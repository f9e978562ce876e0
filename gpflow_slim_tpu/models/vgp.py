"""Full-data non-conjugate variational GPs (ref:gpflowSlim/models/vgp.py).

Whitened representation: q(v) = N(q_mu, q_sqrt q_sqrtᵀ) with f = L v + m(X),
L = chol(K(X)+jitter). ELBO = Σ variational_expectations − KL[q(v)‖N(0,I)].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..conditionals import conditional
from ..kullback_leiblers import gauss_kl
from ..ops import linalg
from ..params import Param
from ..transforms import LowerTriangular
from .model import GPModel


class VGP(GPModel):
    def __init__(self, X, Y, kern, likelihood, mean_function=None,
                 num_latent=None, name="vgp"):
        super().__init__(X, Y, kern, likelihood, mean_function,
                         num_latent=num_latent, name=name)
        N = self.num_data = int(X.shape[0])
        P = self.num_latent
        self.q_mu = Param(np.zeros((N, P)), name=f"{name}/q_mu")
        init = np.tile(np.eye(N)[None], (P, 1, 1))
        self.q_sqrt = Param(
            init, transform=LowerTriangular(N, num_matrices=P),
            name=f"{name}/q_sqrt",
        )

    def build_likelihood(self):
        N = self.num_data
        kl = gauss_kl(self.q_mu.value, self.q_sqrt.value, None)

        K = self.kern.K(self.X) + jnp.eye(N, dtype=self.X.dtype) * config.default_jitter()
        L = linalg.cholesky(K)
        fmean = L @ self.q_mu.value + self.mean_function(self.X)  # (N, P)

        q_sqrt = jnp.tril(self.q_sqrt.value)  # (P, N, N)
        LSq = jax.vmap(lambda S: L @ S)(q_sqrt)  # (P, N, N)
        fvar = jnp.sum(jnp.square(LSq), axis=2).T  # (N, P)

        var_exp = self.likelihood.variational_expectations(fmean, fvar, self.Y)
        return jnp.sum(var_exp) - kl

    def build_predict(self, Xnew, full_cov=False):
        mu, var = conditional(
            Xnew, self.X, self.kern, self.q_mu.value,
            full_cov=full_cov, q_sqrt=self.q_sqrt.value, white=True,
        )
        return mu + self.mean_function(Xnew), var


class VGPOpperArchambeau(GPModel):
    """Opper & Archambeau (2009) parameterization of the full variational GP
    (the reference lineage's ``VGP_opper_archambeau``).

    q(f) = N(K α, [K⁻¹ + diag(λ²)]⁻¹) — only 2·N·P variational parameters
    (α, λ) instead of N²; the optimal posterior provably has this form.
    """

    def __init__(self, X, Y, kern, likelihood, mean_function=None,
                 num_latent=None, name="vgp_oa"):
        from ..transforms import positive

        super().__init__(X, Y, kern, likelihood, mean_function,
                         num_latent=num_latent, name=name)
        N = self.num_data = int(X.shape[0])
        P = self.num_latent
        self.q_alpha = Param(np.zeros((N, P)), name=f"{name}/q_alpha")
        self.q_lambda = Param(np.ones((N, P)), transform=positive(),
                              name=f"{name}/q_lambda")

    def _A_chol(self):
        """Per-output A_p = I + λ_p λ_pᵀ ∘ K, and its Cholesky."""
        N = self.num_data
        K = self.kern.K(self.X)
        lam = self.q_lambda.value.T  # (P, N)
        A = jnp.eye(N, dtype=K.dtype) + lam[:, None, :] * lam[:, :, None] * K
        L = jax.vmap(lambda Ap: linalg.cholesky(Ap))(A)
        return K, lam, L

    def build_likelihood(self):
        N = self.num_data
        P = self.num_latent
        K, lam, L = self._A_chol()
        K_alpha = K @ self.q_alpha.value  # (N, P)
        f_mean = K_alpha + self.mean_function(self.X)

        eye = jnp.eye(N, dtype=K.dtype)
        Li = jax.vmap(
            lambda Lp: jax.scipy.linalg.solve_triangular(Lp, eye, lower=True)
        )(L)  # (P, N, N)
        tmp = Li / lam[:, None, :]  # divide columns by λ
        f_var = (1.0 / jnp.square(lam) - jnp.sum(jnp.square(tmp), axis=1)).T

        A_logdet = 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1))
        )
        trAi = jnp.sum(jnp.square(Li))
        KL = 0.5 * (
            A_logdet + trAi - N * P + jnp.sum(K_alpha * self.q_alpha.value)
        )
        v_exp = self.likelihood.variational_expectations(
            f_mean, f_var, self.Y
        )
        return jnp.sum(v_exp) - KL

    def build_predict(self, Xnew, full_cov=False):
        # q(f*) moments under the Opper-Archambeau posterior
        K, lam, L = self._A_chol()
        Kx = self.kern.K(self.X, Xnew)  # (N, N*)
        f_mean = Kx.T @ self.q_alpha.value + self.mean_function(Xnew)
        # var = K** − Kxᵀ (K + diag(1/λ²))⁻¹ Kx  per output, via A's chol:
        # (K + Λ⁻²)⁻¹ = Λ A⁻ᵀ... use tmp = L⁻¹ (λ ∘ Kx)
        lamKx = lam[:, :, None] * Kx[None, :, :]  # (P, N, N*)
        tmp = jax.vmap(
            lambda Lp, Bp: jax.scipy.linalg.solve_triangular(
                Lp, Bp, lower=True
            )
        )(L, lamKx)  # (P, N, N*)
        if full_cov:
            cov = self.kern.K(Xnew)[None] - jnp.einsum(
                "pnk,pnl->pkl", tmp, tmp
            )
            return f_mean, cov
        var = self.kern.Kdiag(Xnew)[None, :] - jnp.sum(
            jnp.square(tmp), axis=1
        )  # (P, N*)
        return f_mean, var.T
