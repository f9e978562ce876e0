"""Precomputed posteriors for serving (no reference counterpart).

The reference rebuilds the O(N³) factorization inside every prediction
graph. For production serving we precompute the data-dependent factors once
(``model.posterior()``) and every subsequent ``predict_*`` is O(N·N*) —
matmuls + triangular solves only. Posterior objects are Modules
(pytrees), so they jit/vmap/shard like everything else and can be
checkpointed with ``utils.checkpoint`` for a serving process.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..params import Module
from ..ops import linalg


class GPRPosterior(Module):
    """Cached exact-GPR predictor: holds (X, L, α) from one factorization."""

    def __init__(self, kern, likelihood, mean_function, X, L, alpha,
                 num_latent):
        self.kern = kern
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.X = X
        self.L = L              # chol(K + σ²I)
        self.alpha = alpha      # (K + σ²I)⁻¹ (Y − m(X))
        self.num_latent = int(num_latent)

    def predict_f(self, Xnew, full_cov=False):
        Kx = self.kern.K(self.X, Xnew)  # (N, N*)
        fmean = Kx.T @ self.alpha + self.mean_function(Xnew)
        A = linalg.solve_lower(self.L, Kx)
        if full_cov:
            fvar = self.kern.K(Xnew) - A.T @ A
            fvar = jnp.tile(fvar[None, :, :], (self.num_latent, 1, 1))
        else:
            fvar = self.kern.Kdiag(Xnew) - jnp.sum(jnp.square(A), axis=0)
            fvar = jnp.tile(fvar[:, None], (1, self.num_latent))
        return fmean, fvar

    def predict_y(self, Xnew):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(m, v)

    def predict_density(self, Xnew, Ynew):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_density(m, v, Ynew)


class SVGPPosterior(Module):
    """Cached SVGP predictor: precomputed (Luu, Kuu⁻¹-projected q)."""

    def __init__(self, kern, likelihood, mean_function, feature, Luu, q_mu,
                 q_sqrt, whiten, num_latent):
        self.kern = kern
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.feature = feature
        self.Luu = Luu
        self.q_mu = q_mu        # raw array (M, P)
        self.q_sqrt = q_sqrt    # raw array (P, M, M) lower
        self.whiten = bool(whiten)
        self.num_latent = int(num_latent)

    def predict_f(self, Xnew, full_cov=False):
        from .. import features as features_mod
        from ..conditionals import base_conditional_with_lm

        Kmn = features_mod.Kuf(self.feature, self.kern, Xnew)
        Knn = self.kern.K(Xnew) if full_cov else self.kern.Kdiag(Xnew)
        mean, var = base_conditional_with_lm(
            Kmn, self.Luu, Knn, self.q_mu, full_cov=full_cov,
            q_sqrt=self.q_sqrt, white=self.whiten,
        )
        return mean + self.mean_function(Xnew), var

    def predict_y(self, Xnew):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(m, v)


class SGPRPosterior(Module):
    """Cached SGPR predictor: holds (Z-side factors L, LB, c)."""

    def __init__(self, kern, likelihood, mean_function, feature, L, LB, c,
                 num_latent):
        self.kern = kern
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.feature = feature
        self.L = L
        self.LB = LB
        self.c = c
        self.num_latent = int(num_latent)

    def predict_f(self, Xnew, full_cov=False):
        from .. import features as features_mod

        Kus = features_mod.Kuf(self.feature, self.kern, Xnew)
        tmp1 = linalg.solve_lower(self.L, Kus)
        tmp2 = linalg.solve_lower(self.LB, tmp1)
        mean = tmp2.T @ self.c + self.mean_function(Xnew)
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

    def predict_y(self, Xnew):
        m, v = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(m, v)
