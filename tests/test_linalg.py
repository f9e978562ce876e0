"""ops.linalg against numpy/scipy f64 oracles (CPU, x64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import solve_triangular

import gpflow_slim_tpu as gfs
from gpflow_slim_tpu import parallel
from gpflow_slim_tpu.ops import linalg

rng = np.random.RandomState(0)


def spd(N):
    A = rng.randn(N, N)
    return A @ A.T + N * np.eye(N)


def lower(N):
    return np.tril(rng.randn(N, N)) + N * np.eye(N)


@pytest.mark.parametrize("N", [64, 128, 200, 256])
def test_cholesky_matches_numpy(N):
    K = spd(N)
    L = np.asarray(linalg.cholesky(jnp.asarray(K)))
    np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=0, atol=1e-10)
    assert np.abs(np.triu(L, 1)).max() == 0.0


def _numpy_logdet_quad(K, D):
    L = np.linalg.cholesky(K)
    return np.log(np.diag(L)).sum(), (solve_triangular(L, D, lower=True)
                                      ** 2).sum()


@pytest.mark.parametrize("P", [1, 3])
def test_chol_logdet_quad_and_gpr_objective_match_numpy(P):
    N = 60
    K = spd(N)
    D = rng.randn(N, P)
    hl, quad = linalg.chol_logdet_quad(jnp.asarray(K), jnp.asarray(D))
    hl_ref, quad_ref = _numpy_logdet_quad(K, D)
    np.testing.assert_allclose(float(hl), hl_ref, rtol=1e-12)
    np.testing.assert_allclose(float(quad), quad_ref, rtol=1e-10)

    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(6 * X) + 0.1 * rng.randn(N, P)
    m = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.3))
    Kx = np.exp(-0.5 * (X - X.T) ** 2 / 0.09) + np.eye(N)
    hl_ref, quad_ref = _numpy_logdet_quad(Kx, Y)
    obj_ref = 0.5 * N * P * np.log(2 * np.pi) + P * hl_ref + 0.5 * quad_ref
    np.testing.assert_allclose(float(m.objective()), obj_ref, rtol=1e-10)


def _central_difference(f, x, direction, h=1e-6):
    return (f(x + h * direction) - f(x - h * direction)) / (2 * h)


def test_chol_logdet_quad_grad_matches_finite_differences():
    N, P = 30, 2
    K = spd(N)
    D = rng.randn(N, P)

    def f(K, D):
        hl, quad = linalg.chol_logdet_quad(K, D)
        return 0.7 * hl - 1.3 * quad

    gK, gD = jax.grad(f, argnums=(0, 1))(jnp.asarray(K), jnp.asarray(D))
    E = rng.randn(N, N)
    E = E + E.T  # symmetric direction: the input is a covariance
    fd = _central_difference(lambda k: float(f(k, jnp.asarray(D))),
                             jnp.asarray(K), jnp.asarray(E))
    np.testing.assert_allclose(float(jnp.sum(gK * E)), fd, rtol=1e-6)
    V = rng.randn(N, P)
    fd = _central_difference(lambda d: float(f(jnp.asarray(K), d)),
                             jnp.asarray(D), jnp.asarray(V))
    np.testing.assert_allclose(float(jnp.sum(gD * V)), fd, rtol=1e-6)


def test_gpr_objective_grad_matches_finite_differences():
    N = 40
    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(6 * X) + 0.1 * rng.randn(N, 1)
    m = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.3))
    vec, unpack = gfs.params.pack_trainable(m)
    f = lambda v: unpack(v).objective()  # noqa: E731
    g = np.asarray(jax.grad(f)(vec))
    for i in range(vec.shape[0]):
        e = jnp.zeros_like(vec).at[i].set(1.0)
        np.testing.assert_allclose(
            g[i], _central_difference(lambda v: float(f(v)), vec, e),
            rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("N,P", [(128, 64), (200, 7), (64, 130)])
def test_solves_match_scipy(N, P):
    L = lower(N)
    B = rng.randn(N, P)
    np.testing.assert_allclose(
        np.asarray(linalg.solve_lower(jnp.asarray(L), jnp.asarray(B))),
        solve_triangular(L, B, lower=True), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(linalg.solve_upper(jnp.asarray(L.T), jnp.asarray(B))),
        solve_triangular(L.T, B, lower=False), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(linalg.cho_solve_lower(jnp.asarray(L), jnp.asarray(B))),
        np.linalg.solve(L @ L.T, B), rtol=1e-8, atol=1e-14)


def test_solve_vector_rhs():
    N = 64
    L = lower(N)
    b = rng.randn(N)
    x = np.asarray(linalg.solve_lower(jnp.asarray(L), jnp.asarray(b)))
    assert x.shape == (N,)
    np.testing.assert_allclose(x, solve_triangular(L, b, lower=True),
                               atol=1e-12)


def _batch(P, M, K):
    return np.stack([lower(M) for _ in range(P)]), rng.randn(P, M, K)


def test_batched_solve_lower_matches_scipy():
    Ls, Bs = _batch(3, 96, 40)
    out = np.asarray(linalg.batched_solve_lower(jnp.asarray(Ls),
                                                jnp.asarray(Bs)))
    ref = np.stack([solve_triangular(l, b, lower=True)
                    for l, b in zip(Ls, Bs)])
    np.testing.assert_allclose(out, ref, atol=1e-12)


def test_batched_solve_upper_matches_scipy():
    Ls, Bs = _batch(3, 96, 40)
    Us = np.swapaxes(Ls, 1, 2)
    out = np.asarray(linalg.batched_solve_upper(jnp.asarray(Us),
                                                jnp.asarray(Bs)))
    ref = np.stack([solve_triangular(u, b, lower=False)
                    for u, b in zip(Us, Bs)])
    np.testing.assert_allclose(out, ref, atol=1e-12)


def test_batched_solve_vjp_matches_finite_differences():
    Ls, Bs = _batch(2, 16, 5)
    Ls, Bs = jnp.asarray(Ls), jnp.asarray(Bs)

    def f(L, B):
        return jnp.sum(jnp.sin(linalg.batched_solve_lower(L, B)))

    gL, gB = jax.grad(f, argnums=(0, 1))(Ls, Bs)
    dL = jnp.asarray(np.tril(rng.randn(*Ls.shape)))
    dB = jnp.asarray(rng.randn(*Bs.shape))
    np.testing.assert_allclose(
        float(jnp.sum(gL * dL)),
        _central_difference(lambda l: float(f(l, Bs)), Ls, dL), rtol=1e-6)
    np.testing.assert_allclose(
        float(jnp.sum(gB * dB)),
        _central_difference(lambda b: float(f(Ls, b)), Bs, dB), rtol=1e-6)


def test_robust_cholesky_rank_deficient_gram():
    X = np.repeat(rng.uniform(0, 1, (10, 1)), 4, axis=0)  # duplicate rows
    K = np.exp(-0.5 * (X - X.T) ** 2 / 0.04)  # rank 10 of 40
    L, jitter = linalg.robust_cholesky(jnp.asarray(K))
    L, jitter = np.asarray(L), float(jitter)
    assert np.isfinite(L).all() and jitter > 0
    np.testing.assert_allclose(L @ L.T, K + jitter * np.eye(40), atol=1e-10)


def test_cyclic_cholesky_diagonal_blocks_on_four_devices():
    # each step factors its bs×bs diagonal block and solves the panel
    # against it; with one block column per device and bs=16 every step's
    # block and panel are non-trivial
    mesh = parallel.make_mesh({"data": 4}, devices=jax.devices()[:4])
    N, bs = 128, 16
    K = spd(N)
    L = np.asarray(parallel.cyclic_cholesky(jnp.asarray(K), mesh, "data",
                                            block_size=bs))
    Lref = np.linalg.cholesky(K)
    for k in range(N // bs):
        blk = slice(k * bs, (k + 1) * bs)
        np.testing.assert_allclose(L[blk, blk], Lref[blk, blk], atol=1e-10)
        np.testing.assert_allclose(
            np.linalg.inv(L[blk, blk]), np.linalg.inv(Lref[blk, blk]),
            atol=1e-10)
    np.testing.assert_allclose(L, Lref, atol=1e-10)
