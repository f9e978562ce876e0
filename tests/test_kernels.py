"""Kernel zoo vs hand-written numpy oracles (reference test_kerns.py role).

Checks: K(X) symmetry/PSD, K(X,X2) vs oracle, Kdiag == diag(K), active_dims
slicing, Sum/Product algebra, ARD, parity-critical constants.
"""

import numpy as np
import pytest

import gpflow_slim_tpu as gfs

K = gfs.kernels
rng = np.random.RandomState(0)
X = rng.randn(6, 3)
X2 = rng.randn(4, 3)


def sqdist(A, B, ls):
    A = A / ls
    B = B / ls
    return (
        np.sum(A**2, 1)[:, None] - 2 * A @ B.T + np.sum(B**2, 1)[None, :]
    )


def _check(kern, oracle_fn, atol=1e-8):
    G = np.asarray(kern.K(X, X2))
    np.testing.assert_allclose(G, oracle_fn(X, X2), atol=atol)
    Gx = np.asarray(kern.K(X))
    np.testing.assert_allclose(Gx, Gx.T, atol=1e-12)
    # the euclid-dist epsilon (1e-12) shifts the diagonal of r-kernels by
    # O(variance * 1e-6) relative to the analytic Kdiag — reference behavior
    np.testing.assert_allclose(np.diag(Gx), np.asarray(kern.Kdiag(X)), atol=5e-6)
    eigs = np.linalg.eigvalsh(Gx)
    assert eigs.min() > -1e-8


def test_rbf():
    _check(
        K.RBF(3, variance=1.5, lengthscales=0.7),
        lambda A, B: 1.5 * np.exp(-0.5 * sqdist(A, B, 0.7)),
    )


def test_rbf_ard():
    ls = np.array([0.5, 1.0, 2.0])
    _check(
        K.RBF(3, variance=2.0, lengthscales=ls, ARD=True),
        lambda A, B: 2.0 * np.exp(-0.5 * sqdist(A, B, ls)),
    )


def test_matern12():
    _check(
        K.Matern12(3, variance=1.2, lengthscales=0.9),
        lambda A, B: 1.2 * np.exp(-np.sqrt(sqdist(A, B, 0.9) + 1e-12)),
        atol=1e-6,
    )


def test_matern32():
    def oracle(A, B):
        r = np.sqrt(sqdist(A, B, 0.8) + 1e-12)
        return 1.1 * (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)

    _check(K.Matern32(3, variance=1.1, lengthscales=0.8), oracle, atol=1e-6)


def test_matern52():
    def oracle(A, B):
        r = np.sqrt(sqdist(A, B, 0.8) + 1e-12)
        return 0.7 * (1 + np.sqrt(5) * r + 5.0 / 3.0 * r**2) * np.exp(-np.sqrt(5) * r)

    _check(K.Matern52(3, variance=0.7, lengthscales=0.8), oracle, atol=1e-6)


def test_exponential_gpflow1_quirk():
    # reference lineage uses exp(-r/2) for Exponential
    def oracle(A, B):
        r = np.sqrt(sqdist(A, B, 0.6) + 1e-12)
        return 1.0 * np.exp(-0.5 * r)

    _check(K.Exponential(3, lengthscales=0.6), oracle, atol=1e-6)


def test_cosine():
    def oracle(A, B):
        r = np.sqrt(sqdist(A, B, 1.3) + 1e-12)
        return 0.9 * np.cos(r)

    G = np.asarray(K.Cosine(3, variance=0.9, lengthscales=1.3).K(X, X2))
    np.testing.assert_allclose(G, oracle(X, X2), atol=1e-6)


def test_rational_quadratic():
    def oracle(A, B):
        d2 = sqdist(A, B, 0.9)
        return 1.4 * (1 + d2 / (2 * 2.5)) ** (-2.5)

    _check(
        K.RationalQuadratic(3, variance=1.4, lengthscales=0.9, alpha=2.5),
        oracle,
    )


def test_linear_and_ard():
    _check(K.Linear(3, variance=1.3), lambda A, B: 1.3 * A @ B.T)
    v = np.array([0.5, 1.5, 2.5])
    _check(K.Linear(3, variance=v, ARD=True), lambda A, B: (A * v) @ B.T)


def test_polynomial():
    def oracle(A, B):
        return (1.2 * A @ B.T + 0.7) ** 2

    _check(
        K.Polynomial(3, degree=2.0, variance=1.2, offset=0.7), oracle
    )


def test_periodic_mackay_form():
    # σ² exp(−0.5 Σ_d sin²(π Δ_d / p) / ℓ²)
    def oracle(A, B):
        d = np.pi * (A[:, None, :] - B[None, :, :]) / 1.7
        return 1.3 * np.exp(-0.5 * np.sum((np.sin(d) / 0.8) ** 2, -1))

    _check(
        K.Periodic(3, period=1.7, variance=1.3, lengthscales=0.8), oracle
    )


def test_white():
    k = K.White(3, variance=0.3)
    np.testing.assert_allclose(
        np.asarray(k.K(X)), 0.3 * np.eye(6), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(k.K(X, X2)), np.zeros((6, 4)), atol=1e-12
    )


def test_constant():
    k = K.Constant(3, variance=0.6)
    np.testing.assert_allclose(np.asarray(k.K(X, X2)), 0.6 * np.ones((6, 4)))


def test_arccosine_order0_against_formula():
    k = K.ArcCosine(3, order=0, variance=1.0, weight_variances=1.0,
                    bias_variance=1.0)

    def oracle(A, B):
        s = lambda U, V: 1.0 + U @ V.T
        nx = np.sqrt(1.0 + np.sum(A**2, 1))
        ny = np.sqrt(1.0 + np.sum(B**2, 1))
        cos_t = np.clip(s(A, B) / nx[:, None] / ny[None, :], -1, 1)
        theta = np.arccos(cos_t)
        return (1 / np.pi) * (np.pi - theta)

    _check(k, oracle, atol=1e-7)


@pytest.mark.parametrize("order", [1, 2])
def test_arccosine_diag_consistency(order):
    k = K.ArcCosine(3, order=order, weight_variances=np.array([0.5, 1.0, 2.0]),
                    bias_variance=0.7, ARD=True)
    G = np.asarray(k.K(X))
    np.testing.assert_allclose(np.diag(G), np.asarray(k.Kdiag(X)), atol=1e-7)


def test_coregion():
    W = rng.randn(4, 2)
    kappa = np.abs(rng.randn(4)) + 0.1
    k = K.Coregion(1, output_dim=4, rank=2, W=W, kappa=kappa)
    Xi = rng.randint(0, 4, (7, 1)).astype(float)
    X2i = rng.randint(0, 4, (5, 1)).astype(float)
    B = W @ W.T + np.diag(kappa)
    G = np.asarray(k.K(Xi, X2i))
    oracle = B[Xi[:, 0].astype(int)][:, X2i[:, 0].astype(int)]
    np.testing.assert_allclose(G, oracle, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(k.Kdiag(Xi)), np.diag(B)[Xi[:, 0].astype(int)], atol=1e-8
    )


def test_active_dims_slicing():
    k = K.RBF(1, active_dims=[1])
    full = K.RBF(1)
    np.testing.assert_allclose(
        np.asarray(k.K(X)), np.asarray(full.K(X[:, 1:2])), atol=1e-12
    )
    k2 = K.RBF(2, active_dims=slice(0, 2))
    np.testing.assert_allclose(
        np.asarray(k2.K(X)), np.asarray(K.RBF(2).K(X[:, :2])), atol=1e-12
    )


def test_sum_product_algebra():
    k1 = K.RBF(3, variance=0.5)
    k2 = K.Matern32(3, variance=1.5)
    ksum = k1 + k2
    kprod = k1 * k2
    np.testing.assert_allclose(
        np.asarray(ksum.K(X, X2)),
        np.asarray(k1.K(X, X2)) + np.asarray(k2.K(X, X2)),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(kprod.K(X, X2)),
        np.asarray(k1.K(X, X2)) * np.asarray(k2.K(X, X2)),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(ksum.Kdiag(X)),
        np.asarray(k1.Kdiag(X)) + np.asarray(k2.Kdiag(X)),
        atol=1e-12,
    )


def test_sum_with_active_dims_composition():
    # composite kernel over different dim subsets (deep-kernel pattern)
    k = K.RBF(1, active_dims=[0]) + K.Periodic(1, active_dims=[2]) * K.Matern32(
        1, active_dims=[1]
    )
    G = np.asarray(k.K(X))
    oracle = np.asarray(K.RBF(1).K(X[:, :1])) + np.asarray(
        K.Periodic(1).K(X[:, 2:3])
    ) * np.asarray(K.Matern32(1).K(X[:, 1:2]))
    np.testing.assert_allclose(G, oracle, atol=1e-10)


def test_kernel_on_warped_inputs():
    # kernels accept arbitrary arrays (deep-kernel composability, SURVEY §3.5)
    import jax
    import jax.numpy as jnp

    k = K.RBF(2)

    def warp_and_gram(W):
        H = jnp.tanh(X @ W)
        return jnp.sum(k.K(H))

    W = rng.randn(3, 2)
    g = jax.grad(warp_and_gram)(W)
    assert np.isfinite(np.asarray(g)).all()


def _map_oracle(kind, d2):
    """Numpy f64 form of each stationary map of the squared distance."""
    r = np.sqrt(d2 + 1e-12)
    return {
        "rbf": np.exp(-0.5 * d2),
        "exponential": np.exp(-0.5 * r),
        "matern12": np.exp(-r),
        "matern32": (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r),
        "matern52": (1 + np.sqrt(5) * r + 5.0 / 3.0 * d2)
        * np.exp(-np.sqrt(5) * r),
        "cosine": np.cos(r),
    }[kind]


_KINDS = {"rbf": K.RBF, "exponential": K.Exponential, "matern12": K.Matern12,
          "matern32": K.Matern32, "matern52": K.Matern52, "cosine": K.Cosine}


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_stationary_gram_each_kind_matches_numpy(kind):
    # the one Stationary.K path, at a Gram larger than the zoo tests'
    A, B = rng.randn(200, 3), rng.randn(130, 3)
    kern = _KINDS[kind](3, variance=1.3, lengthscales=0.8)
    assert kern._gram_kind == kind
    np.testing.assert_allclose(
        np.asarray(kern.K(A, B)), 1.3 * _map_oracle(kind, sqdist(A, B, 0.8)),
        rtol=1e-10, atol=1e-12)


def test_stationary_gram_ard_d8_matches_numpy():
    A = rng.uniform(0, 1, (150, 8))
    ls = np.linspace(0.2, 2.0, 8)
    kern = K.Matern52(8, variance=0.6, lengthscales=ls, ARD=True)
    np.testing.assert_allclose(
        np.asarray(kern.K(A)), 0.6 * _map_oracle("matern52",
                                                 sqdist(A, A, ls)),
        rtol=1e-10, atol=1e-12)
