"""KL divergences for variational GPs (ref:gpflowSlim/kullback_leiblers.py).

``gauss_kl(q_mu, q_sqrt, K=None)`` = KL[ N(q_mu, S) ‖ N(0, K) ] summed over
the P independent output dims, S = q_sqrt q_sqrtᵀ (rank-3 lower-tri) or
diag(q_sqrt²) (rank-2). ``K=None`` means the whitened case (prior = I).
Formula (SURVEY App. A):
  ½[ tr(K⁻¹S) + q_muᵀK⁻¹q_mu − M·P + P·logdet K − Σ logdet S ].
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.linalg import cholesky, solve_triangular

from . import config

__all__ = ["gauss_kl"]


def gauss_kl(q_mu, q_sqrt, K=None):
    """q_mu: (M, P); q_sqrt: (M, P) diag or (P, M, M) lower-tri; K: (M, M) or None."""
    M, P = q_mu.shape
    diag = q_sqrt.ndim == 2

    if K is None:
        alpha = q_mu  # K⁻¹ = I
    else:
        # K is expected PD already (callers add jitter), reference semantics
        Lp = cholesky(K, lower=True)
        alpha = solve_triangular(Lp, q_mu, lower=True)

    # Mahalanobis term: q_muᵀ K⁻¹ q_mu
    mahalanobis = jnp.sum(jnp.square(alpha))
    # Constant
    constant = -jnp.asarray(M * P, dtype=q_mu.dtype)
    # Log-determinant of q covariance: Σ_p Σ_m log q_sqrt_diag²
    if diag:
        logdet_qcov = jnp.sum(jnp.log(jnp.square(q_sqrt)))
    else:
        logdet_qcov = jnp.sum(
            jnp.log(jnp.square(jnp.diagonal(q_sqrt, axis1=-2, axis2=-1)))
        )

    # Trace term: tr(K⁻¹ S)
    if K is None:
        if diag:
            trace = jnp.sum(jnp.square(q_sqrt))
        else:
            trace = jnp.sum(jnp.square(q_sqrt) * _lower_mask(q_sqrt))
        prior_logdet = jnp.zeros((), dtype=q_mu.dtype)
    else:
        if diag:
            # tr(K⁻¹ diag(s²)) = Σ_m (K⁻¹)_mm Σ_p s²_mp
            Kinv_diag = jnp.sum(
                jnp.square(solve_triangular(Lp, jnp.eye(M, dtype=K.dtype), lower=True)),
                axis=0,
            )  # diag of K⁻¹ via columns of Lp⁻¹
            trace = jnp.sum(Kinv_diag[:, None] * jnp.square(q_sqrt))
        else:
            # Lp⁻¹ Lq per output dim; trace = ‖Lp⁻¹ Lq‖²_F summed over p
            LpiLq = _batched_solve(Lp, q_sqrt)  # (P, M, M)
            trace = jnp.sum(jnp.square(LpiLq))
        prior_logdet = 2.0 * P * jnp.sum(jnp.log(jnp.diagonal(Lp)))

    kl = 0.5 * (mahalanobis + constant - logdet_qcov + trace + prior_logdet)
    return kl


def _batched_solve(Lp, Lq):
    # (P, M, M) per-output solves against the shared prior factor
    from .ops import linalg

    Lq = jnp.tril(Lq)
    Lp_b = jnp.broadcast_to(Lp, (Lq.shape[0],) + Lp.shape)
    return linalg.batched_solve_lower(Lp_b, Lq)


def _lower_mask(q_sqrt):
    M = q_sqrt.shape[-1]
    return jnp.tril(jnp.ones((M, M), dtype=q_sqrt.dtype))
