"""MCMC model for non-conjugate full GPs (ref:gpflowSlim/models/gpmc.py).

Whitened latents: V ~ N(0, I) elementwise prior (an untransformed Param with
a standard-normal prior), f = chol(K+jitter)·V + m(X). ``log_posterior`` =
Σ logp(y|f) + log N(V;0,I) + hyperprior terms — sampled externally by
``mcmc.hmc``/``mcmc.nuts`` over the unconstrained parameter vector.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import config, priors
from ..conditionals import conditional
from ..ops import linalg
from ..params import Param
from .model import GPModel


class GPMC(GPModel):
    def __init__(self, X, Y, kern, likelihood, mean_function=None,
                 num_latent=None, name="gpmc"):
        super().__init__(X, Y, kern, likelihood, mean_function,
                         num_latent=num_latent, name=name)
        N = int(X.shape[0])
        self.V = Param(
            np.zeros((N, self.num_latent)),
            prior=priors.Gaussian(0.0, 1.0),
            name=f"{name}/V",
        )

    def build_likelihood(self):
        N = self.X.shape[0]
        K = self.kern.K(self.X) + jnp.eye(N, dtype=self.X.dtype) * config.default_jitter()
        L = linalg.cholesky(K)
        F = L @ self.V.value + self.mean_function(self.X)
        return jnp.sum(self.likelihood.logp(F, self.Y))

    def build_predict(self, Xnew, full_cov=False):
        mu, var = conditional(
            Xnew, self.X, self.kern, self.V.value,
            full_cov=full_cov, white=True,
        )
        return mu + self.mean_function(Xnew), var
