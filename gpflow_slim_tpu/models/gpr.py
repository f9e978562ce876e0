"""Exact Gaussian-process regression (ref:gpflowSlim/models/gpr.py).

Conjugate model: log marginal likelihood via one Cholesky of
``K(X) + σ² I`` and the MVN logpdf (SURVEY App. A); predictions via
triangular solves against the stored training data, all through
``ops.linalg``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..likelihoods import Gaussian
from ..ops import linalg
from .model import GPModel


class GPR(GPModel):
    def __init__(self, X, Y, kern, mean_function=None, name="gpr"):
        likelihood = Gaussian(name=f"{name}/likelihood")
        super().__init__(X, Y, kern, likelihood, mean_function, name=name)

    def _K_noisy(self):
        N = self.X.shape[0]
        return self.kern.K(self.X) + jnp.squeeze(
            self.likelihood.variance.value
        ) * jnp.eye(N, dtype=self.X.dtype)

    def _K_chol(self):
        return linalg.cholesky(self._K_noisy())

    def build_likelihood(self):
        """log p(Y | θ) = MVN(Y; m(X), K + σ²I), summed over output columns
        (same math as ``densities.multivariate_normal``; SURVEY App. A).
        """
        N = self.X.shape[0]
        d = self.Y - self.mean_function(self.X)
        half_logdet, quad = linalg.chol_logdet_quad(self._K_noisy(), d)
        num_col = d.shape[1] if d.ndim > 1 else 1
        return (
            -0.5 * N * num_col * jnp.log(2.0 * jnp.pi)
            - num_col * half_logdet
            - 0.5 * quad
        )

    def posterior(self):
        """Precompute (L, α) once for O(N·N*) serving predictions."""
        from .posterior import GPRPosterior

        L = self._K_chol()
        err = self.Y - self.mean_function(self.X)
        alpha = linalg.solve_upper(L.T, linalg.solve_lower(L, err))
        return GPRPosterior(self.kern, self.likelihood, self.mean_function,
                            self.X, L, alpha, self.num_latent)

    def build_predict(self, Xnew, full_cov=False):
        Kx = self.kern.K(self.X, Xnew)  # (N, N*)
        L = self._K_chol()
        A = linalg.solve_lower(L, Kx)  # (N, N*)
        V = linalg.solve_lower(L, self.Y - self.mean_function(self.X))  # (N, P)
        fmean = A.T @ V + self.mean_function(Xnew)
        if full_cov:
            fvar = self.kern.K(Xnew) - A.T @ A
            fvar = jnp.tile(fvar[None, :, :], (self.num_latent, 1, 1))  # (P,N*,N*)
        else:
            fvar = self.kern.Kdiag(Xnew) - jnp.sum(jnp.square(A), axis=0)
            fvar = jnp.tile(fvar[:, None], (1, self.num_latent))  # (N*, P)
        return fmean, fvar
