"""GP conditionals (ref:gpflowSlim/conditionals.py).

``base_conditional`` is THE core predictive-math routine (SURVEY App. A):
given Kmn, Kmm, Knn and latent values/statistics at the M points, produce the
predictive mean and (co)variance at the N points, with optional variational
``q_sqrt`` covariance terms and whitened representation.

Shapes follow the reference convention:
  Kmn (M, N); Kmm (M, M); Knn (N, N) if full_cov else (N,);
  f (M, P); q_sqrt (M, P) diag or (P, M, M) lower-tri.
Returns fmean (N, P) and fvar (N, P) (diag) or (P, N, N) (full).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cholesky, solve_triangular

from . import config
from .ops import linalg as ops_linalg

__all__ = ["base_conditional", "base_conditional_with_lm", "conditional",
           "feature_conditional", "uncertain_conditional", "psi_statistics"]


def base_conditional(Kmn, Kmm, Knn, f, *, full_cov=False, q_sqrt=None, white=False):
    Lm = ops_linalg.cholesky(Kmm)
    return base_conditional_with_lm(
        Kmn, Lm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white
    )


def base_conditional_with_lm(Kmn, Lm, Knn, f, *, full_cov=False,
                             q_sqrt=None, white=False):
    """base_conditional given a precomputed Cholesky of Kmm (serving path)."""
    num_func = f.shape[1]  # P

    A = ops_linalg.solve_lower(Lm, Kmn)  # (M, N)

    if full_cov:
        fvar = Knn - A.T @ A  # (N, N)
        fvar = jnp.tile(fvar[None, :, :], (num_func, 1, 1))  # (P, N, N)
    else:
        fvar = Knn - jnp.sum(jnp.square(A), axis=0)  # (N,)
        fvar = jnp.tile(fvar[None, :], (num_func, 1))  # (P, N)

    if not white:
        A = ops_linalg.solve_upper(Lm.T, A)  # Kmm⁻¹-weighted

    fmean = A.T @ f  # (N, P)

    if q_sqrt is not None:
        if q_sqrt.ndim == 2:
            # diagonal q_sqrt: (M, P) -> LTA (P, M, N)
            LTA = A[None, :, :] * q_sqrt.T[:, :, None]
        elif q_sqrt.ndim == 3:
            L = jnp.tril(q_sqrt)  # (P, M, M)
            LTA = jax.vmap(lambda Lp: Lp.T @ A)(L)  # (P, M, N)
        else:
            raise ValueError(f"bad q_sqrt rank: {q_sqrt.ndim}")
        if full_cov:
            fvar = fvar + jnp.einsum("pmn,pmk->pnk", LTA, LTA)
        else:
            fvar = fvar + jnp.sum(jnp.square(LTA), axis=1)  # (P, N)

    if not full_cov:
        fvar = fvar.T  # (N, P)

    return fmean, fvar


def conditional(Xnew, X, kern, f, *, full_cov=False, q_sqrt=None, white=False):
    """Predictive q(f*) given (variational) values f at inputs X."""
    jitter = config.default_jitter()
    num_data = X.shape[0]
    Kmm = kern.K(X) + jitter * jnp.eye(num_data, dtype=Xnew.dtype)
    Kmn = kern.K(X, Xnew)
    Knn = kern.K(Xnew) if full_cov else kern.Kdiag(Xnew)
    return base_conditional(
        Kmn, Kmm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white
    )


def _rbf_psi_stats(kern, Z, Xmu, Xvar):
    """Closed-form RBF kernel expectations under q(x) = N(Xmu, Σ).

    ``Xvar`` is (N, D) for diagonal Σ or (N, D, D) for full covariance.
    Returns (ψ0 scalar, ψ1 (N, M), ψ2 (N, M, M)):
      ψ0    = E[k(x,x)] = σ²
      ψ1_nm = E[k(x_n, z_m)]   = σ² |ΣΛ⁻¹+I|^{-½} exp(−½ dᵀ(Σ+Λ)⁻¹d)
      ψ2_nmm' = E[k(x_n,z_m)k(x_n,z_m')]
              = σ⁴ |2ΣΛ⁻¹+I|^{-½} exp(−¼ δzᵀΛ⁻¹δz − ½ dᵀ(Σ+Λ/2)⁻¹d)
    with Λ = diag(ℓ²), δz = z_m − z_m', d = μ − z (resp. μ − z̄).
    (Titsias/GPLVM psi-statistics.)
    """
    var = jnp.squeeze(kern.variance.value)
    ls2 = jnp.square(kern.lengthscales.value)  # (D,) or scalar
    D = Z.shape[1]
    ls2 = jnp.broadcast_to(ls2, (D,))
    psi0 = jnp.full((Xmu.shape[0],), var, dtype=Xmu.dtype)

    if Xvar.ndim == 2:  # diagonal Σ — elementwise closed forms
        denom1 = Xvar + ls2[None, :]  # (N, D)
        d1 = jnp.square(Xmu[:, None, :] - Z[None, :, :]) / denom1[:, None, :]
        log_det1 = 0.5 * jnp.sum(jnp.log(Xvar / ls2[None, :] + 1.0), axis=-1)
        psi1 = var * jnp.exp(-0.5 * jnp.sum(d1, axis=-1) - log_det1[:, None])

        Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])  # (M, M, D)
        dZ = jnp.square(Z[:, None, :] - Z[None, :, :]) / ls2[None, None, :]
        denom2 = Xvar[:, None, None, :] + 0.5 * ls2[None, None, None, :]
        dmu = (
            jnp.square(Xmu[:, None, None, :] - Zbar[None, :, :, :]) / denom2
        )
        log_det2 = 0.5 * jnp.sum(
            jnp.log(2.0 * Xvar / ls2[None, :] + 1.0), axis=-1
        )  # (N,)
        psi2 = (
            jnp.square(var)
            * jnp.exp(
                -0.25 * jnp.sum(dZ, axis=-1)[None, :, :]
                - 0.5 * jnp.sum(dmu, axis=-1)
                - log_det2[:, None, None]
            )
        )
        return psi0, psi1, psi2

    # full Σ (N, D, D): per-n D×D Cholesky solves (D is small)
    Lam = jnp.diag(ls2)
    eyeD = jnp.eye(D, dtype=Z.dtype)
    Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])  # (M, M, D)
    dZ = jnp.square(Z[:, None, :] - Z[None, :, :]) / ls2[None, None, :]
    quad_dZ = -0.25 * jnp.sum(dZ, axis=-1)  # (M, M)

    def per_n(mu_n, Sig_n):
        # ψ1 pieces
        C1 = cholesky(Sig_n + Lam, lower=True)
        d = mu_n[None, :] - Z  # (M, D)
        a = solve_triangular(C1, d.T, lower=True)  # (D, M)
        quad1 = -0.5 * jnp.sum(jnp.square(a), axis=0)  # (M,)
        # |ΣΛ⁻¹+I| = |Σ+Λ| / |Λ|
        logdet1 = (
            2.0 * jnp.sum(jnp.log(jnp.diagonal(C1)))
            - jnp.sum(jnp.log(ls2))
        )
        psi1_n = var * jnp.exp(quad1 - 0.5 * logdet1)

        # ψ2 pieces
        C2 = cholesky(Sig_n + 0.5 * Lam, lower=True)
        dmu = mu_n[None, None, :] - Zbar  # (M, M, D)
        b = solve_triangular(
            C2, jnp.reshape(dmu, (-1, D)).T, lower=True
        )  # (D, M²)
        quad2 = -0.5 * jnp.reshape(
            jnp.sum(jnp.square(b), axis=0), (Z.shape[0], Z.shape[0])
        )
        # |2ΣΛ⁻¹+I| = |Σ+Λ/2| / |Λ/2|
        logdet2 = (
            2.0 * jnp.sum(jnp.log(jnp.diagonal(C2)))
            - jnp.sum(jnp.log(0.5 * ls2))
        )
        psi2_n = jnp.square(var) * jnp.exp(
            quad_dZ + quad2 - 0.5 * logdet2
        )
        return psi1_n, psi2_n

    psi1, psi2 = jax.vmap(per_n)(Xmu, Xvar)
    return psi0, psi1, psi2


def _default_psi_gh_points(D: int) -> int:
    """Per-dimension Gauss–Hermite order for the tensor-product grid,
    capped so the total node count H^D stays ≤ ~4000. For D where even
    H=2 blows the cap (D ≥ 12) there is no sensible tensor grid — raise
    instead of silently allocating 2^D·(M, M) intermediates."""
    H = min(20, int(4000.0 ** (1.0 / D)))
    if H < 2:
        raise NotImplementedError(
            f"tensor-product Gauss-Hermite quadrature is intractable for "
            f"input dimension {D}; pass num_gauss_hermite_points "
            f"explicitly (total cost H**D) or use an RBF kernel "
            f"(closed-form psi-statistics)"
        )
    return H


def _quadrature_psi_stats(kern, Z, Xmu, Xvar, H: int):
    """Kernel expectations ψ0/ψ1/ψ2 under q(x)=N(Xmu, Σ) for ARBITRARY
    kernels via tensor-product Gauss–Hermite quadrature.

    ψ0_n = E[k(x_n, x_n)], ψ1 = E[k(x_n, Z)], ψ2_n = E[k(x_n,Z) k(x_n,Z)ᵀ].
    ``Xvar`` is (N, D) diagonal or (N, D, D) full. Node count is H^D — only
    sensible for small input dimension (the closed-form RBF path handles the
    common case; this is the generic fallback, mirroring the quadrature
    fallback strategy of the reference lineage's kernel-expectation code).
    """
    from . import quadrature as quad_mod

    N, D = Xmu.shape
    xi, w = quad_mod.mvhermgauss(H, D)  # (S, D), (S,)
    dtype = Xmu.dtype
    xi = jnp.asarray(xi, dtype=dtype)
    w = jnp.asarray(w, dtype=dtype) / jnp.pi ** (D / 2.0)  # normalized

    if Xvar.ndim == 2:  # diagonal Σ: x = μ + √(2σ²)·ξ
        def nodes_for(mu_n, var_n):
            return mu_n[None, :] + jnp.sqrt(2.0 * var_n)[None, :] * xi
    else:  # full Σ: x = μ + √2·L·ξ
        def nodes_for(mu_n, Sig_n):
            Ln = cholesky(Sig_n, lower=True)
            return mu_n[None, :] + jnp.sqrt(2.0) * xi @ Ln.T

    def per_n(mu_n, var_n):
        Xs = nodes_for(mu_n, var_n)  # (S, D)
        psi0_n = w @ kern.Kdiag(Xs)  # scalar
        Kxz = kern.K(Xs, Z)  # (S, M)
        psi1_n = w @ Kxz  # (M,)
        psi2_n = jnp.einsum("s,sm,sk->mk", w, Kxz, Kxz)  # (M, M)
        return psi0_n, psi1_n, psi2_n

    return jax.vmap(per_n)(Xmu, Xvar)


def psi_statistics(kern, Z, Xmu, Xvar, *, num_gauss_hermite_points=None):
    """Kernel expectations (ψ0 (N,), ψ1 (N,M), ψ2 (N,M,M)) under
    q(x_n)=N(Xmu_n, Σ_n): closed-form for plain RBF, Gauss–Hermite
    quadrature for any other kernel. Shared by ``uncertain_conditional``
    and ``models.BayesianGPLVM``."""
    from . import kernels as kernels_mod

    if isinstance(kern, kernels_mod.RBF) and kern.active_dims is None:
        return _rbf_psi_stats(kern, Z, Xmu, Xvar)
    H = num_gauss_hermite_points or _default_psi_gh_points(Z.shape[1])
    return _quadrature_psi_stats(kern, Z, Xmu, Xvar, H)


def uncertain_conditional(Xnew_mu, Xnew_var, feat, kern, q_mu, q_sqrt, *,
                          mean_function=None, white=False,
                          num_gauss_hermite_points=None):
    """Predictive moments of f* when the INPUT is uncertain:
    x* ~ N(Xnew_mu, Σ) with Σ diagonal (Xnew_var (N, D)) or full
    (Xnew_var (N, D, D)) — moment matching / GP-LVM psi-statistics.

    RBF kernels with InducingPoints use closed forms; any other kernel
    falls back to tensor-product Gauss–Hermite quadrature over the input
    distribution (``num_gauss_hermite_points`` per dimension; defaults to
    a grid of ≲4000 nodes). Returns (mean (N, P), var (N, P)).
    ref:gpflowSlim/conditionals.py ``uncertain_conditional`` role.
    """
    from . import features as features_mod

    if not isinstance(feat, features_mod.InducingPoints):
        raise NotImplementedError(
            "uncertain_conditional requires InducingPoints"
        )
    if mean_function is not None:
        raise NotImplementedError(
            "uncertain_conditional supports Zero mean only"
        )

    Z = feat.Z.value
    M = Z.shape[0]
    P = q_mu.shape[1]
    jitter = config.default_jitter()
    Kuu = kern.K(Z) + jitter * jnp.eye(M, dtype=Z.dtype)
    Luu = cholesky(Kuu, lower=True)

    # express q(u) in unwhitened u-space
    if q_sqrt.ndim == 2:
        Sq = jax.vmap(jnp.diag)(q_sqrt.T)  # (P, M, M)
    else:
        Sq = jnp.tril(q_sqrt)
    if white:
        mu_u = Luu @ q_mu
        Lq_u = jax.vmap(lambda Sp: Luu @ Sp)(Sq)
    else:
        mu_u = q_mu
        Lq_u = Sq
    cov_u = Lq_u @ jnp.swapaxes(Lq_u, -1, -2)  # (P, M, M)

    psi0, psi1, psi2 = psi_statistics(
        kern, Z, Xnew_mu, Xnew_var,
        num_gauss_hermite_points=num_gauss_hermite_points,
    )

    # α_p = Kuu⁻¹ mu_u (M, P)
    Kinv_mu = solve_triangular(
        Luu.T, solve_triangular(Luu, mu_u, lower=True), lower=False
    )
    mean = psi1 @ Kinv_mu  # (N, P)

    # tr(Kuu⁻¹ ψ2[n]): solve per n
    def kinv(Mx):
        return solve_triangular(
            Luu.T, solve_triangular(Luu, Mx, lower=True), lower=False
        )

    Kinv_psi2_tr = jax.vmap(lambda P2: jnp.trace(kinv(P2)))(psi2)  # (N,)

    # B_p = Kuu⁻¹ (mu_p mu_pᵀ + cov_p) Kuu⁻¹ ; tr(B_p ψ2[n])
    def B_for_output(mu_p, cov_p):
        Mmat = jnp.outer(mu_p, mu_p) + cov_p
        return kinv(kinv(Mmat).T).T  # Kuu⁻¹ M Kuu⁻¹ (symmetric)

    B = jax.vmap(B_for_output)(mu_u.T, cov_u)  # (P, M, M)
    tr_B_psi2 = jnp.einsum("pij,nij->np", B, psi2)  # (N, P)

    var = (
        psi0[:, None]
        - Kinv_psi2_tr[:, None]
        + tr_B_psi2
        - jnp.square(mean)
    )
    return mean, var


def feature_conditional(Xnew, feat, kern, f, *, full_cov=False, q_sqrt=None,
                        white=False):
    """Conditional through an inducing feature (dispatching Kuu/Kuf)."""
    from . import features as features_mod

    jitter = config.default_jitter()
    Kmm = features_mod.Kuu(feat, kern, jitter=jitter)
    Kmn = features_mod.Kuf(feat, kern, Xnew)
    Knn = kern.K(Xnew) if full_cov else kern.Kdiag(Xnew)
    return base_conditional(
        Kmn, Kmm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white
    )
