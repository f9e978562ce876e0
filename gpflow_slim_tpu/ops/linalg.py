"""Dense linear algebra (the reference's tf.linalg role).

The reference delegates Cholesky/TRSM to TF's C++ kernels (Eigen LLT on the
CPU, cuSOLVER potrf / cuBLAS trsm on a GPU). Here every function is a thin
layer over XLA's ``cholesky`` / ``triangular_solve`` HLOs, which XLA lowers
to the same cuSOLVER and cuBLAS calls on a GPU and to LAPACK on the CPU.
JAX supplies the JVP/VJP rules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.lax import linalg as _lax_linalg
from jax.scipy.linalg import solve_triangular as _solve_triangular

from .. import config


def cholesky(K):
    """Lower Cholesky factor of an SPD matrix.

    ``symmetrize_input=False``: jax.scipy's default prepends a (K + Kᵀ)/2
    pass, an extra O(N²) read and write per factorization. Every caller in
    this library constructs K symmetrically (Gram expansions, A·Aᵀ
    products, +diag), so the lower triangle alone is the contract.
    Callers with a possibly-asymmetric matrix symmetrize it first.
    """
    return _lax_linalg.cholesky(K, symmetrize_input=False)


def chol_logdet_quad(K, D):
    """``(half_logdet, quad)`` of the MVN objective core:
    ``half_logdet = Σ log diag chol(K)``, ``quad = ‖chol(K)⁻¹ D‖²_F``.

    This is what exact-GPR's marginal likelihood consumes (SURVEY App. A).
    """
    if D.ndim == 1:
        D = D[:, None]
    L = cholesky(K)
    half_logdet = jnp.sum(jnp.log(jnp.diagonal(L)))
    alpha = solve_lower(L, D)
    return half_logdet, jnp.sum(jnp.square(alpha))


def solve_lower(L, B):
    """Solve L x = B with L lower-triangular."""
    return _solve_triangular(L, B, lower=True)


def solve_upper(U, B):
    """Solve U x = B with U upper-triangular."""
    return _solve_triangular(U, B, lower=False)


def cho_solve_lower(L, B):
    """Solve (L Lᵀ) x = B given the lower Cholesky factor."""
    return solve_upper(L.T, solve_lower(L, B))


def batched_solve_lower(L, B):
    """Solve L[p] X = B[p] over a leading batch dim (the (P, M, M)
    variational q_sqrt / per-output solves)."""
    return jax.vmap(solve_lower)(L, B)


def batched_solve_upper(U, B):
    """Solve U[p] X = B[p] over a leading batch dim (upper triangles)."""
    return jax.vmap(solve_upper)(U, B)


def batched_cho_solve_lower(L, B):
    """Solve (L[p] L[p]ᵀ) X = B[p] given batched lower factors."""
    return batched_solve_upper(
        jnp.swapaxes(L, 1, 2), batched_solve_lower(L, B)
    )


def robust_cholesky(K, max_tries: int = 5):
    """Cholesky with adaptive jitter escalation (GPyTorch-style).

    Tries ``chol(K + jitter·scale·I)`` with jitter growing ×10 per attempt
    (starting from the dtype-aware default) until the factor is finite —
    jittable via ``lax.while_loop``. Returns ``(L, jitter_used)``. The f32
    safety net for ill-conditioned kernels; exact parity paths should
    call ``cholesky`` directly.
    """
    N = K.shape[0]
    eye = jnp.eye(N, dtype=K.dtype)
    scale = jnp.mean(jnp.diagonal(K))
    base = jnp.asarray(config.default_jitter(), K.dtype)

    def attempt(jit_rel):
        L = cholesky(K + jit_rel * scale * eye)
        ok = jnp.all(jnp.isfinite(L))
        return L, ok

    def cond(state):
        _, ok, tries, _ = state
        return jnp.logical_and(jnp.logical_not(ok), tries < max_tries)

    def body(state):
        jit_rel, _, tries, _ = state
        jit_rel = jit_rel * 10.0
        L, ok = attempt(jit_rel)
        return (jit_rel, ok, tries + 1, L)

    L0, ok0 = attempt(base)
    jit_rel, ok, _, L = jax.lax.while_loop(
        cond, body, (base, ok0, jnp.asarray(0, jnp.int32), L0)
    )
    return L, jit_rel * scale
