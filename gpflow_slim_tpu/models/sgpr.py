"""Sparse GP regression: SGPR (Titsias) + GPRFITC (ref:gpflowSlim/models/sgpr.py).

SGPR is the Titsias-2009 collapsed variational bound in the
``A = L⁻¹Kuf/σ, B = I + AAᵀ`` factorization (SURVEY App. A); GPRFITC is the
Snelson–Ghahramani FITC approximation with the diagonal correction
``ν = diag(Kff − Qff) + σ²``. Both O(NM²), dominated by tall matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import config, features as features_mod
from ..likelihoods import Gaussian
from ..ops import linalg
from .model import GPModel


class SGPRUpperMixin:
    """Titsias upper bound on the log marginal likelihood.

    Useful for sandwiching the true marginal likelihood:
    ELBO ≤ log Z ≤ upper_bound.
    """

    def compute_upper_bound(self):
        num_data = self.X.shape[0]
        M = len(self.feature)
        jitter = config.default_jitter()
        sigma_sq = jnp.squeeze(self.likelihood.variance.value)

        Kdiag = self.kern.Kdiag(self.X)
        Kuu = features_mod.Kuu(self.feature, self.kern, jitter=jitter)
        Kuf = features_mod.Kuf(self.feature, self.kern, self.X)

        I = jnp.eye(M, dtype=self.X.dtype)
        L = linalg.cholesky(Kuu)
        A = linalg.solve_lower(L, Kuf)
        AAT = A @ A.T
        B = I + AAT / sigma_sq
        LB = linalg.cholesky(B)

        # trace bound on the residual eigenvalues
        c = jnp.sum(Kdiag) - jnp.trace(AAT)
        corrected_noise = sigma_sq + c

        const = -0.5 * num_data * jnp.log(2.0 * jnp.pi * sigma_sq)
        logdet = -jnp.sum(jnp.log(jnp.diagonal(LB)))

        LC = linalg.cholesky(I + AAT / corrected_noise)
        err = self.Y - self.mean_function(self.X)
        v = linalg.solve_lower(LC, (A @ err) / corrected_noise)
        quad = -0.5 * jnp.sum(jnp.square(err)) / corrected_noise + 0.5 * jnp.sum(
            jnp.square(v)
        )
        return const + logdet + quad


class SGPR(GPModel, SGPRUpperMixin):
    """Titsias collapsed variational sparse GP regression."""

    def __init__(self, X, Y, kern, feat=None, Z=None, mean_function=None,
                 name="sgpr"):
        likelihood = Gaussian(name=f"{name}/likelihood")
        super().__init__(X, Y, kern, likelihood, mean_function, name=name)
        self.feature = features_mod.inducingpoint_wrapper(feat, Z)

    def _common_factors(self):
        jitter = config.default_jitter()
        num_data = self.X.shape[0]
        sigma = jnp.sqrt(jnp.squeeze(self.likelihood.variance.value))

        err = self.Y - self.mean_function(self.X)  # (N, P)
        Kuf = features_mod.Kuf(self.feature, self.kern, self.X)  # (M, N)
        Kuu = features_mod.Kuu(self.feature, self.kern, jitter=jitter)
        L = linalg.cholesky(Kuu)

        A = linalg.solve_lower(L, Kuf) / sigma  # (M, N)
        AAT = A @ A.T
        B = AAT + jnp.eye(AAT.shape[0], dtype=AAT.dtype)
        LB = linalg.cholesky(B)
        Aerr = A @ err
        c = linalg.solve_lower(LB, Aerr) / sigma  # (M, P)
        return err, L, A, AAT, LB, c, sigma, num_data

    def build_likelihood(self):
        """Titsias ELBO (collapsed bound), exact formula of SURVEY App. A."""
        err, L, A, AAT, LB, c, sigma, num_data = self._common_factors()
        output_dim = self.num_latent
        sigma_sq = jnp.square(sigma)

        bound = -0.5 * num_data * output_dim * jnp.log(2.0 * jnp.pi)
        bound += -output_dim * jnp.sum(jnp.log(jnp.diagonal(LB)))
        bound -= 0.5 * num_data * output_dim * jnp.log(sigma_sq)
        bound += -0.5 * jnp.sum(jnp.square(err)) / sigma_sq
        bound += 0.5 * jnp.sum(jnp.square(c))
        bound += -0.5 * output_dim * (
            jnp.sum(self.kern.Kdiag(self.X)) / sigma_sq - jnp.trace(AAT)
        )
        return bound

    def posterior(self):
        """Precompute (L, LB, c) once for O(M·N*) serving predictions."""
        from .posterior import SGPRPosterior

        err, L, A, AAT, LB, c, sigma, _ = self._common_factors()
        return SGPRPosterior(self.kern, self.likelihood, self.mean_function,
                             self.feature, L, LB, c, self.num_latent)

    def build_predict(self, Xnew, full_cov=False):
        err, L, A, AAT, LB, c, sigma, _ = self._common_factors()
        Kus = features_mod.Kuf(self.feature, self.kern, Xnew)  # (M, N*)
        tmp1 = linalg.solve_lower(L, Kus)
        tmp2 = linalg.solve_lower(LB, tmp1)
        mean = tmp2.T @ c + self.mean_function(Xnew)
        if full_cov:
            var = self.kern.K(Xnew) + tmp2.T @ tmp2 - tmp1.T @ tmp1
            var = jnp.tile(var[None, :, :], (self.num_latent, 1, 1))
        else:
            var = (
                self.kern.Kdiag(Xnew)
                + jnp.sum(jnp.square(tmp2), axis=0)
                - jnp.sum(jnp.square(tmp1), axis=0)
            )
            var = jnp.tile(var[:, None], (1, self.num_latent))
        return mean, var


class GPRFITC(GPModel):
    """FITC sparse regression (Snelson–Ghahramani 2006)."""

    def __init__(self, X, Y, kern, feat=None, Z=None, mean_function=None,
                 name="gprfitc"):
        likelihood = Gaussian(name=f"{name}/likelihood")
        super().__init__(X, Y, kern, likelihood, mean_function, name=name)
        self.feature = features_mod.inducingpoint_wrapper(feat, Z)

    def _common_terms(self):
        jitter = config.default_jitter()
        sigma_sq = jnp.squeeze(self.likelihood.variance.value)
        M = len(self.feature)

        err = self.Y - self.mean_function(self.X)
        Kdiag = self.kern.Kdiag(self.X)
        Kuf = features_mod.Kuf(self.feature, self.kern, self.X)
        Kuu = features_mod.Kuu(self.feature, self.kern, jitter=jitter)

        Luu = linalg.cholesky(Kuu)
        V = linalg.solve_lower(Luu, Kuf)  # (M, N)

        g = Kdiag - jnp.sum(jnp.square(V), axis=0)  # diag(Kff − Qff)
        nu = g + sigma_sq  # (N,)

        beta = err / nu[:, None]  # (N, P)
        alpha = V @ beta  # (M, P)
        B = jnp.eye(M, dtype=V.dtype) + (V / nu[None, :]) @ V.T
        L = linalg.cholesky(B)
        gamma = linalg.solve_lower(L, alpha)  # (M, P)
        return err, nu, Luu, L, alpha, beta, gamma

    def build_likelihood(self):
        err, nu, Luu, L, alpha, beta, gamma = self._common_terms()
        num_data = self.X.shape[0]

        mahalanobis = -0.5 * jnp.sum(jnp.square(err) / nu[:, None]) + 0.5 * jnp.sum(
            jnp.square(gamma)
        )
        constant = -0.5 * num_data * jnp.log(2.0 * jnp.pi)
        logdet = -0.5 * jnp.sum(jnp.log(nu)) - jnp.sum(jnp.log(jnp.diagonal(L)))
        return mahalanobis + self.num_latent * (constant + logdet)

    def build_predict(self, Xnew, full_cov=False):
        err, nu, Luu, L, alpha, beta, gamma = self._common_terms()
        Kus = features_mod.Kuf(self.feature, self.kern, Xnew)
        w = linalg.solve_lower(Luu, Kus)  # (M, N*)
        tmp = linalg.solve_upper(L.T, gamma)
        mean = w.T @ tmp + self.mean_function(Xnew)
        intermediateA = linalg.solve_lower(L, w)
        if full_cov:
            var = (
                self.kern.K(Xnew)
                - w.T @ w
                + intermediateA.T @ intermediateA
            )
            var = jnp.tile(var[None, :, :], (self.num_latent, 1, 1))
        else:
            var = (
                self.kern.Kdiag(Xnew)
                - jnp.sum(jnp.square(w), axis=0)
                + jnp.sum(jnp.square(intermediateA), axis=0)
            )
            var = jnp.tile(var[:, None], (1, self.num_latent))
        return mean, var
