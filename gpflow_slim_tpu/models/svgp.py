"""Stochastic variational GP (ref:gpflowSlim/models/svgp.py).

Hensman et al. 2013/2015: trainable q(u) = N(q_mu, q_sqrt q_sqrtᵀ) over M
inducing outputs, whitened by default. ELBO = scale·Σ variational_expectations
− KL (SURVEY App. A). The reference feeds minibatches through placeholders;
Here data lives device-resident, ``build_likelihood_batch``
takes an explicit batch (or indices gathered inside jit) with the N/B scale —
the data-parallel path shards the batch axis via shard_map (parallel.dp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import config, features as features_mod
from ..conditionals import base_conditional
from ..kullback_leiblers import gauss_kl
from ..params import Param
from ..transforms import LowerTriangular, positive
from .model import GPModel


class SVGP(GPModel):
    def __init__(self, X, Y, kern, likelihood, feat=None, Z=None,
                 mean_function=None, num_latent=None, q_diag=False,
                 whiten=True, name="svgp"):
        super().__init__(X, Y, kern, likelihood, mean_function,
                         num_latent=num_latent, name=name)
        self.feature = features_mod.inducingpoint_wrapper(feat, Z)
        self.q_diag = bool(q_diag)
        self.whiten = bool(whiten)
        self.num_data = int(X.shape[0])

        M = len(self.feature)
        P = self.num_latent
        self.q_mu = Param(np.zeros((M, P)), name=f"{name}/q_mu")
        if q_diag:
            self.q_sqrt = Param(
                np.ones((M, P)), transform=positive(), name=f"{name}/q_sqrt"
            )
        else:
            # identity init, packed through the LowerTriangular transform
            init = np.tile(np.eye(M)[None], (P, 1, 1))
            self.q_sqrt = Param(
                init,
                transform=LowerTriangular(M, num_matrices=P),
                name=f"{name}/q_sqrt",
            )

    # -- ELBO --------------------------------------------------------------
    def prior_kl(self):
        if self.whiten:
            return gauss_kl(self.q_mu.value, self.q_sqrt.value, None)
        K = features_mod.Kuu(self.feature, self.kern,
                             jitter=config.default_jitter())
        return gauss_kl(self.q_mu.value, self.q_sqrt.value, K)

    def _conditional_batch(self, X, full_cov=False):
        jitter = config.default_jitter()
        Kmm = features_mod.Kuu(self.feature, self.kern, jitter=jitter)
        Kmn = features_mod.Kuf(self.feature, self.kern, X)
        Knn = self.kern.K(X) if full_cov else self.kern.Kdiag(X)
        fmean, fvar = base_conditional(
            Kmn, Kmm, Knn, self.q_mu.value,
            full_cov=full_cov, q_sqrt=self.q_sqrt.value, white=self.whiten,
        )
        return fmean + self.mean_function(X), fvar

    def build_likelihood_batch(self, Xb, Yb):
        """Minibatch ELBO with the N/B scale (stochastic training step)."""
        kl = self.prior_kl()
        fmean, fvar = self._conditional_batch(Xb)
        var_exp = self.likelihood.variational_expectations(fmean, fvar, Yb)
        scale = jnp.asarray(self.num_data, fmean.dtype) / Xb.shape[0]
        return jnp.sum(var_exp) * scale - kl

    def build_likelihood(self):
        """Full-data ELBO."""
        return self.build_likelihood_batch(self.X, self.Y)

    def build_predict(self, Xnew, full_cov=False):
        return self._conditional_batch(Xnew, full_cov=full_cov)

    def q_sqrt_array(self):
        """(P, M, M) lower-tri covariance factor regardless of q_diag."""
        q = self.q_sqrt.value
        if q.ndim == 2:  # diag (M, P)
            return jax.vmap(jnp.diag)(q.T)
        return jnp.tril(q)

    def posterior(self):
        """Precompute chol(Kuu) + materialized q for O(M·N*) serving."""
        from ..ops import linalg
        from .posterior import SVGPPosterior

        Kuu = features_mod.Kuu(self.feature, self.kern,
                               jitter=config.default_jitter())
        Luu = linalg.cholesky(Kuu)
        return SVGPPosterior(
            self.kern, self.likelihood, self.mean_function, self.feature,
            Luu, self.q_mu.value, self.q_sqrt_array(), self.whiten,
            self.num_latent,
        )
