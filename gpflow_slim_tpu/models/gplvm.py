"""GP latent variable models: GPLVM + BayesianGPLVM.

GPflow-1.x-lineage model family (``gplvm.py`` in the parent library the
reference forked from; the reference's ψ-statistic machinery lives in
``ref:gpflowSlim/conditionals.py``-adjacent code — SURVEY §2.1 NKN/[U] rows).

``GPLVM`` is exact GPR with the inputs X as a *trainable* ``Param``
(MAP latent positions, PCA-initialized). ``BayesianGPLVM`` is the
Titsias/Lawrence variational model: q(X) = Π N(x_n; μ_n, diag s_n) with the
collapsed Titsias bound computed from kernel expectations ψ0/ψ1/ψ2
(closed-form RBF, quadrature otherwise — ``conditionals.psi_statistics``).

Cost: the bound is two tall matmuls (ψ1ᵀ-weighted solves) + an M×M
Cholesky, O(NM² + M³); ψ-statistics are fused elementwise maps over
(N, M[, M]) arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import config, features as features_mod
from ..conditionals import psi_statistics
from ..likelihoods import Gaussian
from ..mean_functions import Zero
from ..ops import linalg
from ..params import Param
from ..transforms import positive
from .model import GPModel, Model

__all__ = ["GPLVM", "BayesianGPLVM", "pca_reduce"]


def pca_reduce(Y, latent_dim: int):
    """PCA projection of Y (N, P) onto its top ``latent_dim`` principal
    components — the standard GPLVM latent initialization."""
    Y = np.asarray(Y, dtype=np.float64)
    if latent_dim > Y.shape[1]:
        raise ValueError("latent_dim must be <= output dimension")
    evals, evecs = np.linalg.eigh(np.cov(Y.T).reshape(Y.shape[1], Y.shape[1]))
    idx = np.argsort(evals)[::-1][:latent_dim]
    W = evecs[:, idx]
    return (Y - Y.mean(0)) @ W


class GPLVM(GPModel):
    """MAP GP-LVM: exact GPR marginal likelihood with trainable latents X.

    ``self.X`` is a ``Param`` (not fixed data); everything else is the GPR
    math with X = X.value.
    """

    def __init__(self, Y, latent_dim, X_mean=None, kern=None,
                 mean_function=None, name="gplvm"):
        from ..kernels import RBF

        dtype = config.default_float()
        Y = jnp.asarray(Y, dtype=dtype)
        if Y.ndim != 2:
            raise ValueError(f"Y must be rank-2 (N, P); got {Y.shape}")
        if X_mean is None:
            X_mean = pca_reduce(Y, latent_dim)
        X_mean = np.asarray(X_mean, dtype=np.float64)
        if X_mean.shape != (Y.shape[0], latent_dim):
            raise ValueError(
                f"X_mean must be (N, latent_dim) = {(Y.shape[0], latent_dim)};"
                f" got {X_mean.shape}"
            )
        if kern is None:
            kern = RBF(latent_dim, ARD=True, name=f"{name}/kern")

        Model.__init__(self, name=name)
        self.Y = Y
        self.kern = kern
        self.likelihood = Gaussian(name=f"{name}/likelihood")
        self.mean_function = (
            mean_function if mean_function is not None else Zero()
        )
        self.num_latent = int(Y.shape[1])
        self.latent_dim = int(latent_dim)
        self.X = Param(X_mean, name=f"{name}/X")

    def _K_chol(self):
        X = self.X.value
        N = X.shape[0]
        K = self.kern.K(X) + jnp.squeeze(self.likelihood.variance.value) * \
            jnp.eye(N, dtype=X.dtype)
        return linalg.cholesky(K)

    def build_likelihood(self):
        from .. import densities

        L = self._K_chol()
        m = self.mean_function(self.X.value)
        return densities.multivariate_normal(self.Y, m, L)

    def build_predict(self, Xnew, full_cov=False):
        X = self.X.value
        Kx = self.kern.K(X, Xnew)
        L = self._K_chol()
        A = linalg.solve_lower(L, Kx)
        V = linalg.solve_lower(L, self.Y - self.mean_function(X))
        fmean = A.T @ V + self.mean_function(Xnew)
        if full_cov:
            fvar = self.kern.K(Xnew) - A.T @ A
            fvar = jnp.tile(fvar[None, :, :], (self.num_latent, 1, 1))
        else:
            fvar = self.kern.Kdiag(Xnew) - jnp.sum(jnp.square(A), axis=0)
            fvar = jnp.tile(fvar[:, None], (1, self.num_latent))
        return fmean, fvar


class BayesianGPLVM(GPModel):
    """Variational Bayesian GP-LVM (Titsias & Lawrence 2010).

    q(X) = Π_n N(x_n; X_mean_n, diag(X_var_n)) with trainable variational
    parameters, M inducing points, and the collapsed Titsias bound built
    from ψ-statistics:

        ELBO = −ND/2·log2π − D/2·logdet B − ND/2·log σ²
               − ‖Y‖²/2σ² + ‖c‖²/2 − D/2·(ψ0/σ² − tr(AAᵀ)) − KL[q(X)‖p(X)]

    with ``A = L⁻¹ψ1ᵀ/σ``, ``AAᵀ = L⁻¹(Σ_n ψ2_n)L⁻ᵀ/σ²``, ``B = AAᵀ+I``,
    ``LB = chol B``, ``c = LB⁻¹AY/σ`` — exactly the SGPR factorization with
    (ψ1, Σψ2) replacing (Kuf, KufKufᵀ).
    """

    def __init__(self, X_mean, X_var, Y, kern, M=None, Z=None,
                 X_prior_mean=None, X_prior_var=None, name="bgplvm"):
        dtype = config.default_float()
        Y = jnp.asarray(Y, dtype=dtype)
        X_mean = np.asarray(X_mean, dtype=np.float64)
        X_var = np.asarray(X_var, dtype=np.float64)
        if X_mean.shape != X_var.shape:
            raise ValueError("X_mean and X_var must have the same (N, Q) shape")
        if X_mean.shape[0] != Y.shape[0]:
            raise ValueError("X_mean and Y must agree on N")
        N, Q = X_mean.shape

        if Z is None:
            if M is None:
                raise ValueError("provide either Z (M, Q) or M (int)")
            perm = np.random.RandomState(0).permutation(N)[:M]
            Z = X_mean[perm].copy()
        Z = np.asarray(Z, dtype=np.float64)

        Model.__init__(self, name=name)
        self.Y = Y
        self.kern = kern
        self.likelihood = Gaussian(name=f"{name}/likelihood")
        self.mean_function = Zero()
        self.num_latent = int(Y.shape[1])
        self.latent_dim = Q
        self.X_mean = Param(X_mean, name=f"{name}/X_mean")
        self.X_var = Param(X_var, transform=positive(), name=f"{name}/X_var")
        self.feature = features_mod.InducingPoints(Z, name=f"{name}/Z")
        self.X_prior_mean = jnp.asarray(
            np.zeros((N, Q)) if X_prior_mean is None else X_prior_mean,
            dtype=dtype,
        )
        self.X_prior_var = jnp.asarray(
            np.ones((N, Q)) if X_prior_var is None else X_prior_var,
            dtype=dtype,
        )

    # -- shared factorization ---------------------------------------------
    def _common_factors(self):
        jitter = config.default_jitter()
        sigma_sq = jnp.squeeze(self.likelihood.variance.value)
        sigma = jnp.sqrt(sigma_sq)

        Xmu = self.X_mean.value
        Xvar = self.X_var.value
        Z = self.feature.Z.value
        M = Z.shape[0]

        psi0, psi1, psi2 = psi_statistics(self.kern, Z, Xmu, Xvar)
        psi0_sum = jnp.sum(psi0)
        Psi2 = jnp.sum(psi2, axis=0)  # (M, M)

        Kuu = features_mod.Kuu(self.feature, self.kern, jitter=jitter)
        L = linalg.cholesky(Kuu)

        A = linalg.solve_lower(L, psi1.T) / sigma  # (M, N)
        tmp = linalg.solve_lower(L, Psi2)
        AAT = linalg.solve_lower(L, tmp.T) / sigma_sq  # L⁻¹Psi2L⁻ᵀ/σ²
        B = AAT + jnp.eye(M, dtype=AAT.dtype)
        LB = linalg.cholesky(B)
        c = linalg.solve_lower(LB, A @ self.Y) / sigma  # (M, P)
        return psi0_sum, AAT, L, LB, c, sigma, sigma_sq

    def kl_latents(self):
        """KL[q(X) ‖ p(X)] for factorized Gaussians (diagonal)."""
        Xmu = self.X_mean.value
        Xvar = self.X_var.value
        NQ = Xmu.size
        return (
            -0.5 * NQ
            + 0.5 * jnp.sum(jnp.log(self.X_prior_var))
            - 0.5 * jnp.sum(jnp.log(Xvar))
            + 0.5 * jnp.sum(
                (jnp.square(Xmu - self.X_prior_mean) + Xvar)
                / self.X_prior_var
            )
        )

    def build_likelihood(self):
        psi0_sum, AAT, L, LB, c, sigma, sigma_sq = self._common_factors()
        N = self.Y.shape[0]
        D = self.num_latent
        ND = N * D

        bound = -0.5 * ND * jnp.log(2.0 * jnp.pi)
        bound += -D * jnp.sum(jnp.log(jnp.diagonal(LB)))
        bound += -0.5 * ND * jnp.log(sigma_sq)
        bound += -0.5 * jnp.sum(jnp.square(self.Y)) / sigma_sq
        bound += 0.5 * jnp.sum(jnp.square(c))
        bound += -0.5 * D * (psi0_sum / sigma_sq - jnp.trace(AAT))
        return bound - self.kl_latents()

    def build_predict(self, Xnew, full_cov=False):
        _, _, L, LB, c, sigma, sigma_sq = self._common_factors()
        Kus = features_mod.Kuf(self.feature, self.kern, Xnew)  # (M, N*)
        tmp1 = linalg.solve_lower(L, Kus)
        tmp2 = linalg.solve_lower(LB, tmp1)
        fmean = tmp2.T @ c  # (N*, P)
        if full_cov:
            fvar = self.kern.K(Xnew) + tmp2.T @ tmp2 - tmp1.T @ tmp1
            fvar = jnp.tile(fvar[None, :, :], (self.num_latent, 1, 1))
        else:
            fvar = (
                self.kern.Kdiag(Xnew)
                + jnp.sum(jnp.square(tmp2), axis=0)
                - jnp.sum(jnp.square(tmp1), axis=0)
            )
            fvar = jnp.tile(fvar[:, None], (1, self.num_latent))
        return fmean, fvar
