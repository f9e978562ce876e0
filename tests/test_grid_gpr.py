"""End-to-end 2-D block-cyclic distributed GPR (parallel.grid_gpr).

The reference is single-device (SURVEY §2.2) — these tests check the
distributed addition against the single-device implementations: sharded
Gram tiles vs dense K, in-layout Cholesky vs jnp, 2-D TRSMs vs
solve_triangular, and the full loss/grad vs models.GPR to f64 tolerance.
Runs on the 8-virtual-CPU-device mesh from conftest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import gpflow_slim_tpu as gfs
from gpflow_slim_tpu.parallel import (
    GridLayout,
    grid_cholesky_tiles,
    grid_gram,
    grid_solve_lower_thin,
    grid_solve_lower_wide,
    grid_solve_upper_thin,
    make_grid_gpr_loss,
)
from gpflow_slim_tpu.parallel.grid_gpr import (
    _grid_ata,
    _grid_identity,
    grid_logdet,
)


def _mesh24():
    dev = np.array(jax.devices()[:8]).reshape(2, 4)
    return Mesh(dev, ("rows", "cols"))


def _mesh42():
    dev = np.array(jax.devices()[:8]).reshape(4, 2)
    return Mesh(dev, ("rows", "cols"))


def _spd(rng, N, dtype=np.float64):
    A = rng.randn(N, N)
    return (A @ A.T / N + 2.0 * np.eye(N)).astype(dtype)


def _permute(M, lo):
    return jnp.asarray(M)[lo.row_perm()][:, lo.col_perm()]


def _unpermute(Mp, lo):
    return np.asarray(Mp)[np.argsort(lo.row_perm())][
        :, np.argsort(lo.col_perm())
    ]


@pytest.mark.parametrize("mesh_fn", [_mesh24, _mesh42])
def test_grid_gram_matches_dense(rng, mesh_fn):
    mesh = mesh_fn()
    N, bs = 128, 16
    lo = GridLayout(N, mesh, block_size=bs)
    X = jnp.asarray(rng.uniform(0, 1, (N, 2)))
    kern = gfs.kernels.Matern32(2, lengthscales=0.7)
    Kp = grid_gram(kern, X, lo, diag_add=0.25)
    K = kern.K(X) + 0.25 * jnp.eye(N, dtype=X.dtype)
    np.testing.assert_allclose(_unpermute(Kp, lo), K, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mesh_fn", [_mesh24, _mesh42])
def test_grid_cholesky_tiles_sharded_output(rng, mesh_fn):
    """Factor equals jnp.linalg.cholesky AND the output stays tile-sharded
    (the round-1 gap: no replication at the output boundary)."""
    mesh = mesh_fn()
    N, bs = 128, 16
    lo = GridLayout(N, mesh, block_size=bs)
    K = _spd(rng, N)
    Kp = jax.device_put(_permute(K, lo), lo.tile_sharding())

    fn = jax.jit(lambda Kp: grid_cholesky_tiles(Kp, lo))
    Lp = fn(Kp)
    np.testing.assert_allclose(
        _unpermute(Lp, lo), np.linalg.cholesky(K), rtol=1e-9, atol=1e-9
    )
    # output sharding is the block-cyclic tile spec, not replicated
    assert Lp.sharding.spec == lo.tile_spec()
    shard_shapes = {s.data.shape for s in Lp.addressable_shards}
    assert shard_shapes == {(N // lo.Pr, N // lo.Pc)}


def test_grid_logdet_and_thin_solves(rng):
    mesh = _mesh24()
    N, bs, P = 96, 8, 3
    lo = GridLayout(N, mesh, block_size=bs)
    K = _spd(rng, N)
    L = np.linalg.cholesky(K)
    Lp = jax.device_put(_permute(np.tril(L), lo), lo.tile_sharding())
    rhs = jnp.asarray(rng.randn(N, P))

    ld = grid_logdet(Lp, lo)
    np.testing.assert_allclose(
        float(ld), np.sum(np.log(np.diag(L))), rtol=1e-12
    )

    alpha = grid_solve_lower_thin(Lp, rhs, lo)
    ref = np.linalg.solve(L, np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(alpha), ref, rtol=1e-9, atol=1e-9)

    beta = grid_solve_upper_thin(Lp, rhs, lo)
    refu = np.linalg.solve(L.T, np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(beta), refu, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("mesh_fn", [_mesh24, _mesh42])
def test_grid_wide_trsm_and_inverse(rng, mesh_fn):
    """2-D distributed TRSM with a block-cyclic (N, N) RHS; W = L⁻¹ and
    WᵀW = K⁻¹ (the backward-pass building blocks), all in layout."""
    mesh = mesh_fn()
    N, bs = 96, 8
    lo = GridLayout(N, mesh, block_size=bs)
    K = _spd(rng, N)
    L = np.linalg.cholesky(K)
    Lp = jax.device_put(_permute(np.tril(L), lo), lo.tile_sharding())

    Ip = _grid_identity(lo, Lp.dtype)
    np.testing.assert_allclose(_unpermute(Ip, lo), np.eye(N), atol=0)

    Wp = grid_solve_lower_wide(Lp, Ip, lo)
    np.testing.assert_allclose(
        _unpermute(Wp, lo), np.linalg.inv(L), rtol=1e-8, atol=1e-8
    )
    assert Wp.sharding.spec == lo.tile_spec()

    Cp = _grid_ata(Wp, lo)
    np.testing.assert_allclose(
        _unpermute(Cp, lo), np.linalg.inv(K), rtol=1e-7, atol=1e-7
    )


@pytest.mark.parametrize("mesh_fn", [_mesh24, _mesh42])
def test_grid_gpr_loss_and_grad_match_single_device(rng, mesh_fn):
    """The headline equality: make_grid_gpr_loss == GPR.objective, value
    and gradient, to f64 tolerance — with multi-output Y and priors."""
    mesh = mesh_fn()
    N = 128
    X = rng.uniform(0, 1, (N, 2))
    F = np.sin(3 * X[:, :1]) + np.cos(2 * X[:, 1:])
    Y = np.concatenate([F, 0.5 * F + 0.1], axis=1)  # (N, 2)

    def build():
        kern = gfs.kernels.RBF(2, lengthscales=[0.4, 0.6], variance=1.3)
        m = gfs.models.GPR(X, Y, kern=kern)
        return m

    m_ref = build()
    loss_ref, grad_ref = jax.value_and_grad(lambda m: m.objective())(m_ref)

    m = build()
    loss_fn = make_grid_gpr_loss(m, mesh, block_size=16)
    loss, grad = jax.jit(jax.value_and_grad(loss_fn))(m)

    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-10)
    # hyperparameter gradients only: the grid loss captures X/Y as
    # constants (data is sharded infrastructure, not a trainable leaf)
    for sub in ("kern", "likelihood"):
        ref_leaves = jax.tree_util.tree_leaves(getattr(grad_ref, sub))
        leaves = jax.tree_util.tree_leaves(getattr(grad, sub))
        assert len(ref_leaves) == len(leaves) and leaves
        for a, b in zip(leaves, ref_leaves):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-10
            )


def test_grid_loss_no_replicated_nxn(rng):
    """Memory-scaling guard: every live N×N value inside the compiled
    loss+grad keeps the 2-D tile sharding — nothing N×N is replicated.
    (Per-device peak ≈ O(N²/(Pr·Pc)) end-to-end, forward and backward.)"""
    mesh = _mesh24()
    N = 128
    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(4 * X)
    m = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1, lengthscales=0.3))
    loss_fn = make_grid_gpr_loss(m, mesh, block_size=16)

    with mesh:
        txt = (
            jax.jit(jax.value_and_grad(loss_fn))
            .lower(m)
            .compile()
            .as_text()
        )
    # the compiled HLO must never hold an unsharded N×N buffer: every
    # f64[128,128] (logical global) must carry a 2x4 tile sharding
    import re

    bad = [
        ln for ln in txt.splitlines()
        if re.search(r"f(32|64)\[128,128\]", ln)
        and "sharding={devices=[2,4]" not in ln
        and "parameter" not in ln  # inputs carry shardings separately
    ]
    assert not bad, f"replicated N×N values in compiled loss: {bad[:5]}"


def test_grid_shape_guard(rng):
    mesh = _mesh24()
    N = 64
    X = rng.uniform(0, 1, (N, 1))
    Y = np.sin(4 * X)
    m = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1))
    loss_fn = make_grid_gpr_loss(m, mesh, block_size=8)
    m_bad = gfs.models.GPR(X[: N // 2], Y[: N // 2], kern=gfs.kernels.RBF(1))
    with pytest.raises(ValueError):
        loss_fn(m_bad)
