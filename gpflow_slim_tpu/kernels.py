"""Covariance kernels (ref:gpflowSlim/kernels.py).

Pure-function pytree redesign of the reference kernel zoo: each kernel is a
``Module`` whose hyperparameters are ``Param`` leaves; ``K(X, X2)`` /
``Kdiag(X)`` are pure functions of ``self`` usable under any
jit / grad / vmap / shard_map context — this preserves the reference's
deep-kernel composability (arbitrary warped inputs may be passed to ``K``).

Stationary kernels compute the pairwise squared distance via the expansion
``‖x‖² − 2·X X2ᵀ + ‖x2‖²`` (one matmul instead of O(N·M·D) broadcasting),
clipped at zero; XLA fuses the elementwise kernel map after the cross
product. ``euclid_dist = sqrt(r² + 1e-12)`` — the epsilon keeps Matérn
gradients finite at zero distance (parity constant, SURVEY App. A).

Parity conventions matched to the reference lineage:
  * RBF: ``σ² exp(−d²/2)`` with ℓ-scaled distances (ARD supported).
  * Matérn 1/2, 3/2, 5/2 standard forms; ``Exponential`` keeps the GPflow-1.x
    quirk ``σ² exp(−r/2)``.
  * Periodic is the MacKay form ``σ² exp(−0.5 Σ_d sin²(π Δ_d / p) / ℓ_d²)``.
  * ArcCosine uses the Cho & Saul J-functions for orders 0/1/2.
  * ``__add__``/``__mul__`` build ``Sum``/``Product`` combination kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import config
from .params import Module, Param
from .transforms import positive

__all__ = [
    "Kernel",
    "Static",
    "White",
    "Constant",
    "Bias",
    "Stationary",
    "RBF",
    "SquaredExponential",
    "Exponential",
    "Matern12",
    "Matern32",
    "Matern52",
    "Cosine",
    "RationalQuadratic",
    "Linear",
    "Polynomial",
    "ArcCosine",
    "Periodic",
    "Coregion",
    "Combination",
    "Sum",
    "Product",
]

_EUCLID_EPS = 1e-12


def _square_dist(Xs, X2s):
    """Pairwise squared distance of pre-scaled inputs, clipped at zero (the
    HIGHEST-precision cross matmul is explained in ``square_dist``)."""
    xs = jnp.sum(jnp.square(Xs), axis=-1)
    ys = jnp.sum(jnp.square(X2s), axis=-1)
    cross = jnp.matmul(Xs, X2s.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(xs[:, None] - 2.0 * cross + ys[None, :], 0.0)


def _gram(kind, Xs, X2s, variance):
    """Stationary Gram ``K(Xs, X2s)`` of pre-scaled inputs
    (``Xs = X / lengthscales``) for the static map ``kind``."""
    d2 = _square_dist(Xs, X2s)
    if kind == "rbf":
        return variance * jnp.exp(-0.5 * d2)
    r = jnp.sqrt(d2 + _EUCLID_EPS)
    if kind == "matern12":
        return variance * jnp.exp(-r)
    if kind == "matern32":
        s3 = np.sqrt(3.0)
        return variance * (1.0 + s3 * r) * jnp.exp(-s3 * r)
    if kind == "matern52":
        s5 = np.sqrt(5.0)
        return variance * (1.0 + s5 * r + 5.0 / 3.0 * d2) * jnp.exp(-s5 * r)
    if kind == "exponential":
        return variance * jnp.exp(-0.5 * r)
    if kind == "cosine":
        return variance * jnp.cos(r)
    raise ValueError(f"unknown kind {kind!r}")


class Kernel(Module):
    """Base kernel: ``active_dims`` slicing + combination operators."""

    def __init__(self, input_dim, active_dims=None, name="kernel"):
        self.input_dim = int(input_dim)
        if isinstance(active_dims, (list, tuple, np.ndarray)):
            active_dims = tuple(int(a) for a in active_dims)
        self.active_dims = active_dims  # None | slice | tuple[int]
        self.name = name

    # -- input slicing -----------------------------------------------------
    def _slice(self, X, X2):
        # coerce raw user inputs to the working float type (avoids silent
        # f64-numpy → f32-jax downcast warnings on every predict call)
        dtype = config.default_float()
        X = jnp.asarray(X, dtype)
        X2 = X2 if X2 is None else jnp.asarray(X2, dtype)
        ad = self.active_dims
        if ad is None:
            X = X[..., : self.input_dim]
            X2 = X2 if X2 is None else X2[..., : self.input_dim]
        elif isinstance(ad, slice):
            X = X[..., ad]
            X2 = X2 if X2 is None else X2[..., ad]
        else:
            idx = jnp.asarray(ad)
            X = jnp.take(X, idx, axis=-1)
            X2 = X2 if X2 is None else jnp.take(X2, idx, axis=-1)
        return X, X2

    # -- interface ---------------------------------------------------------
    def K(self, X, X2=None, presliced=False):
        raise NotImplementedError

    def Kdiag(self, X, presliced=False):
        raise NotImplementedError

    # -- combination algebra ----------------------------------------------
    def __add__(self, other):
        return Sum([self, other])

    def __mul__(self, other):
        return Product([self, other])


# ---------------------------------------------------------------------------
# Static kernels
# ---------------------------------------------------------------------------

class Static(Kernel):
    def __init__(self, input_dim, variance=1.0, active_dims=None, name="static"):
        super().__init__(input_dim, active_dims, name=name)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")

    def Kdiag(self, X, presliced=False):
        return jnp.full((X.shape[0],), jnp.squeeze(self.variance.value), dtype=X.dtype)


class White(Static):
    """``σ² I`` on identical inputs; zero cross-covariance."""

    def K(self, X, X2=None, presliced=False):
        v = jnp.squeeze(self.variance.value)
        if X2 is None:
            return v * jnp.eye(X.shape[0], dtype=X.dtype)
        return jnp.zeros((X.shape[0], X2.shape[0]), dtype=X.dtype)


class Constant(Static):
    def K(self, X, X2=None, presliced=False):
        v = jnp.squeeze(self.variance.value)
        m = X.shape[0] if X2 is None else X2.shape[0]
        return v * jnp.ones((X.shape[0], m), dtype=X.dtype)


class Bias(Constant):
    pass


# ---------------------------------------------------------------------------
# Stationary kernels
# ---------------------------------------------------------------------------

class Stationary(Kernel):
    """Stationary base: ARD lengthscales + signal variance.

    ``ARD`` is inferred from the shape of ``lengthscales`` or forced by the
    flag (scalar value is then broadcast to ``input_dim``).
    """

    def __init__(
        self,
        input_dim,
        variance=1.0,
        lengthscales=1.0,
        active_dims=None,
        ARD=False,
        name="stationary",
    ):
        super().__init__(input_dim, active_dims, name=name)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")
        ls = np.asarray(lengthscales, dtype=np.float64)
        if ARD and ls.ndim == 0:
            ls = np.full((input_dim,), float(ls))
        self.lengthscales = Param(ls, transform=positive(), name=f"{name}/lengthscales")

    # -- distances ---------------------------------------------------------
    def _scaled(self, X):
        return X / self.lengthscales.value

    def square_dist(self, X, X2):
        """ℓ-scaled pairwise squared distance via the matmul expansion.

        The cross matmul runs at Precision.HIGHEST: the expansion relies on
        exact cancellation near the diagonal, and a reduced-precision
        product (TF32 on a GPU) leaves O(2⁻¹¹)·‖x‖² residuals there, large
        enough to destroy PD-ness at short lengthscales. The O(N²D) cost
        is negligible next to the O(N³) factorizations these matrices feed.
        """
        X = self._scaled(X)
        return _square_dist(X, X if X2 is None else self._scaled(X2))

    def euclid_dist(self, X, X2):
        return jnp.sqrt(self.square_dist(X, X2) + _EUCLID_EPS)

    def Kdiag(self, X, presliced=False):
        return jnp.full((X.shape[0],), jnp.squeeze(self.variance.value), dtype=X.dtype)

    # Stationary kernels with a closed-form map of the squared distance
    # (RBF/Matérn/Exponential/Cosine) set ``_gram_kind``; see ``_gram``.
    _gram_kind: str | None = None

    def K(self, X, X2=None, presliced=False):
        if self._gram_kind is None:
            raise NotImplementedError
        if not presliced:
            X, X2 = self._slice(X, X2)
        Xs = self._scaled(X)
        X2s = Xs if X2 is None else self._scaled(X2)
        return _gram(self._gram_kind, Xs, X2s,
                     jnp.squeeze(self.variance.value))


class RBF(Stationary):
    def __init__(self, input_dim, variance=1.0, lengthscales=1.0,
                 active_dims=None, ARD=False, name="rbf"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)
    _gram_kind = "rbf"



SquaredExponential = RBF


class Exponential(Stationary):
    """GPflow-1.x quirk preserved: ``σ² exp(−r/2)`` (not ``exp(−r)``)."""

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0,
                 active_dims=None, ARD=False, name="exponential"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)
    _gram_kind = "exponential"



class Matern12(Stationary):
    def __init__(self, input_dim, variance=1.0, lengthscales=1.0,
                 active_dims=None, ARD=False, name="matern12"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)
    _gram_kind = "matern12"



class Matern32(Stationary):
    def __init__(self, input_dim, variance=1.0, lengthscales=1.0,
                 active_dims=None, ARD=False, name="matern32"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)
    _gram_kind = "matern32"



class Matern52(Stationary):
    def __init__(self, input_dim, variance=1.0, lengthscales=1.0,
                 active_dims=None, ARD=False, name="matern52"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)
    _gram_kind = "matern52"



class Cosine(Stationary):
    def __init__(self, input_dim, variance=1.0, lengthscales=1.0,
                 active_dims=None, ARD=False, name="cosine"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)
    _gram_kind = "cosine"


class RationalQuadratic(Stationary):
    """``σ² (1 + d²/(2α))^{−α}`` with ℓ-scaled distances."""

    def __init__(self, input_dim, variance=1.0, lengthscales=1.0, alpha=1.0,
                 active_dims=None, ARD=False, name="rq"):
        super().__init__(input_dim, variance, lengthscales, active_dims, ARD, name)
        self.alpha = Param(alpha, transform=positive(), name=f"{name}/alpha")

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        r2 = self.square_dist(X, X2)
        a = jnp.squeeze(self.alpha.value)
        return jnp.squeeze(self.variance.value) * jnp.power(
            1.0 + r2 / (2.0 * a), -a
        )


# ---------------------------------------------------------------------------
# Dot-product kernels
# ---------------------------------------------------------------------------

class Linear(Kernel):
    """``K = X diag(σ²) X2ᵀ`` (ARD variance per input dim)."""

    def __init__(self, input_dim, variance=1.0, active_dims=None, ARD=False,
                 name="linear"):
        super().__init__(input_dim, active_dims, name=name)
        v = np.asarray(variance, dtype=np.float64)
        if ARD and v.ndim == 0:
            v = np.full((input_dim,), float(v))
        self.variance = Param(v, transform=positive(), name=f"{name}/variance")

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        v = self.variance.value
        if X2 is None:
            return (X * v) @ X.T
        return (X * v) @ X2.T

    def Kdiag(self, X, presliced=False):
        if not presliced:
            X, _ = self._slice(X, None)
        return jnp.sum(jnp.square(X) * self.variance.value, axis=-1)


class Polynomial(Linear):
    """``(σ²⟨x, x'⟩ + offset)^degree`` — degree is static."""

    def __init__(self, input_dim, degree=3.0, variance=1.0, offset=1.0,
                 active_dims=None, ARD=False, name="polynomial"):
        super().__init__(input_dim, variance, active_dims, ARD, name=name)
        self.degree = float(degree)
        self.offset = Param(offset, transform=positive(), name=f"{name}/offset")

    def K(self, X, X2=None, presliced=False):
        base = super().K(X, X2, presliced=presliced)
        return jnp.power(base + self.offset.value, self.degree)

    def Kdiag(self, X, presliced=False):
        base = super().Kdiag(X, presliced=presliced)
        return jnp.power(base + self.offset.value, self.degree)


class ArcCosine(Kernel):
    """Cho & Saul (2009) arc-cosine kernel, orders 0/1/2, weighted + bias.

    ``s(x, x') = σ_b² + Σ_d w_d x_d x'_d``; ``θ = arccos(s/√(s_xx s_x'x'))``;
    ``K = σ²/π · J_order(θ) · (s_xx s_x'x')^{order/2}``.
    """

    implemented_orders = (0, 1, 2)

    def __init__(self, input_dim, order=0, variance=1.0, weight_variances=1.0,
                 bias_variance=1.0, active_dims=None, ARD=False,
                 name="arccosine"):
        super().__init__(input_dim, active_dims, name=name)
        if order not in self.implemented_orders:
            raise ValueError("requested order is not implemented")
        self.order = int(order)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")
        wv = np.asarray(weight_variances, dtype=np.float64)
        if ARD and wv.ndim == 0:
            wv = np.full((input_dim,), float(wv))
        self.weight_variances = Param(
            wv, transform=positive(), name=f"{name}/weight_variances"
        )
        self.bias_variance = Param(
            bias_variance, transform=positive(), name=f"{name}/bias_variance"
        )

    def _weighted_product(self, X, X2=None):
        wv = self.weight_variances.value
        bv = jnp.squeeze(self.bias_variance.value)
        if X2 is None:
            return bv + jnp.sum(wv * jnp.square(X), axis=-1)
        return bv + (X * wv) @ X2.T

    def _J(self, theta):
        if self.order == 0:
            return jnp.pi - theta
        elif self.order == 1:
            return jnp.sin(theta) + (jnp.pi - theta) * jnp.cos(theta)
        else:
            return 3.0 * jnp.sin(theta) * jnp.cos(theta) + (jnp.pi - theta) * (
                1.0 + 2.0 * jnp.square(jnp.cos(theta))
            )

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        X_denom = jnp.sqrt(self._weighted_product(X))
        if X2 is None:
            X2_denom = X_denom
            numer = self._weighted_product(X, X)
        else:
            X2_denom = jnp.sqrt(self._weighted_product(X2))
            numer = self._weighted_product(X, X2)
        cos_theta = numer / X_denom[:, None] / X2_denom[None, :]
        theta = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
        return (
            jnp.squeeze(self.variance.value)
            * (1.0 / jnp.pi)
            * self._J(theta)
            * jnp.power(X_denom[:, None], self.order)
            * jnp.power(X2_denom[None, :], self.order)
        )

    def Kdiag(self, X, presliced=False):
        if not presliced:
            X, _ = self._slice(X, None)
        Xp = self._weighted_product(X)
        theta = jnp.zeros_like(Xp)
        return (
            jnp.squeeze(self.variance.value)
            * (1.0 / jnp.pi)
            * self._J(theta)
            * jnp.power(Xp, self.order)
        )


class Periodic(Kernel):
    """MacKay periodic kernel: ``σ² exp(−0.5 Σ_d sin²(π Δ_d / p) / ℓ_d²)``.

    Note the 0.5·sin²/ℓ² constant (GPflow-1.x form, SURVEY App. A), not the
    2·sin²/ℓ² textbook variant.
    """

    def __init__(self, input_dim, period=1.0, variance=1.0, lengthscales=1.0,
                 active_dims=None, name="periodic"):
        super().__init__(input_dim, active_dims, name=name)
        self.variance = Param(variance, transform=positive(), name=f"{name}/variance")
        self.lengthscales = Param(
            lengthscales, transform=positive(), name=f"{name}/lengthscales"
        )
        self.period = Param(period, transform=positive(), name=f"{name}/period")

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        if X2 is None:
            X2 = X
        # (N, M, D) pairwise differences; D is small so this is VPU-cheap.
        r = jnp.pi * (X[:, None, :] - X2[None, :, :]) / self.period.value
        scaled = jnp.sin(r) / self.lengthscales.value
        return jnp.squeeze(self.variance.value) * jnp.exp(
            -0.5 * jnp.sum(jnp.square(scaled), axis=-1)
        )

    def Kdiag(self, X, presliced=False):
        return jnp.full((X.shape[0],), jnp.squeeze(self.variance.value), dtype=X.dtype)


class Coregion(Kernel):
    """Coregionalization: ``B = W Wᵀ + diag(κ)`` looked up by integer index.

    ``X[:, active_dim]`` holds output indices; ``K(X, X2) = B[ix, ix2]``.
    """

    def __init__(self, input_dim, output_dim, rank, active_dims=None,
                 name="coregion", W=None, kappa=None):
        super().__init__(input_dim, active_dims, name=name)
        if input_dim != 1:
            raise ValueError("Coregion kernel requires input_dim=1")
        self.output_dim = int(output_dim)
        self.rank = int(rank)
        W0 = np.zeros((output_dim, rank)) if W is None else np.asarray(W)
        k0 = np.ones(output_dim) if kappa is None else np.asarray(kappa)
        self.W = Param(W0, name=f"{name}/W")
        self.kappa = Param(k0, transform=positive(), name=f"{name}/kappa")

    def _B(self):
        W = self.W.value
        return W @ W.T + jnp.diag(self.kappa.value)

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        B = self._B()
        ix = jnp.asarray(X[:, 0], dtype=jnp.int32)
        ix2 = ix if X2 is None else jnp.asarray(X2[:, 0], dtype=jnp.int32)
        return B[ix][:, ix2]

    def Kdiag(self, X, presliced=False):
        if not presliced:
            X, _ = self._slice(X, None)
        Bdiag = jnp.sum(jnp.square(self.W.value), axis=1) + self.kappa.value
        ix = jnp.asarray(X[:, 0], dtype=jnp.int32)
        return Bdiag[ix]


# ---------------------------------------------------------------------------
# Combination kernels
# ---------------------------------------------------------------------------

class Combination(Kernel):
    def __init__(self, kernels, name="combination"):
        flat = []
        for k in kernels:
            if not isinstance(k, Kernel):
                raise TypeError("can only combine Kernel instances")
            if isinstance(k, type(self)) and type(k) in (Sum, Product):
                flat.extend(k.kernels)
            else:
                flat.append(k)
        def required_dim(k):
            ad = k.active_dims
            if ad is None:
                return k.input_dim
            if isinstance(ad, slice):
                return ad.stop if ad.stop is not None else k.input_dim
            return max(ad) + 1

        input_dim = max(required_dim(k) for k in flat)
        super().__init__(input_dim, active_dims=slice(None), name=name)
        self.kernels = list(flat)

    def _slice(self, X, X2):  # children do their own slicing
        return X, X2


class Sum(Combination):
    def __init__(self, kernels, name="sum"):
        super().__init__(kernels, name=name)

    def K(self, X, X2=None, presliced=False):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = out + k.K(X, X2)
        return out

    def Kdiag(self, X, presliced=False):
        out = self.kernels[0].Kdiag(X)
        for k in self.kernels[1:]:
            out = out + k.Kdiag(X)
        return out


class Product(Combination):
    def __init__(self, kernels, name="product"):
        super().__init__(kernels, name=name)

    def K(self, X, X2=None, presliced=False):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = out * k.K(X, X2)
        return out

    def Kdiag(self, X, presliced=False):
        out = self.kernels[0].Kdiag(X)
        for k in self.kernels[1:]:
            out = out * k.Kdiag(X)
        return out
