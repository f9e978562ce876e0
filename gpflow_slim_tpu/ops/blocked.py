"""Blocked (right-looking) Cholesky and triangular solves in pure lax ops.

These are XLA-level blocked algorithms that run **sharded**: all
per-step operands are full-height slabs with static shapes, so under a row
sharding XLA's SPMD partitioner distributes the trailing updates (the
distributed block-Cholesky path of BASELINE config #5 — see
``parallel.dist_linalg``). The reference's counterpart is monolithic
``tf.linalg.cholesky`` (single device).

Cost note: full-height slab updates do ~3× the minimal Cholesky flops but
every flop is a matmul; on one device ``ops.linalg.cholesky`` (cuSOLVER
potrf on a GPU) does the triangular flop count.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cholesky as _chol
from jax.scipy.linalg import solve_triangular as _st

# The slab updates and their adjoints are cancellation-critical: with f32
# products in TF32 (a GPU's default) the distributed GPR gradient left f64
# by ~4e-2 at N=16,384, so every matmul here runs at full f32 precision.
_HP = jax.lax.Precision.HIGHEST

__all__ = ["blocked_cholesky", "blocked_solve_lower", "blocked_solve_upper",
           "pad_to_block"]


def pad_to_block(K, block_size):
    """Pad an SPD matrix to a block multiple with an identity extension."""
    N = K.shape[0]
    rem = (-N) % block_size
    if rem == 0:
        return K, N
    Kp = jnp.zeros((N + rem, N + rem), K.dtype)
    Kp = Kp.at[:N, :N].set(K)
    Kp = Kp.at[jnp.arange(N, N + rem), jnp.arange(N, N + rem)].set(1.0)
    return Kp, N


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def blocked_cholesky(K, block_size: int = 256):
    """Lower Cholesky via right-looking blocked elimination.

    Requires N divisible by block_size (use ``pad_to_block``). Each step:
    factor the bs×bs diagonal block, TRSM the full-height block column,
    SYRK the trailing matrix — all static-shape, so lax.fori_loop + XLA
    sharding work unchanged.

    custom_vjp: naive reverse-mode through the fori_loop would store the
    full N×N carry per block step (nb·N² residuals — fatal at N=50k). The
    analytic Cholesky adjoint (Murray 2016) needs only L itself; its solves
    run through the same blocked kernels, so the backward stays sharded.
    """
    return _blocked_cholesky_impl(K, block_size)


@partial(jax.jit, static_argnames=("block_size",))
def _blocked_cholesky_impl(K, block_size: int = 256):
    N = K.shape[0]
    if N % block_size != 0:
        raise ValueError(f"N={N} not divisible by block_size={block_size}")
    nb = N // block_size
    bs = block_size
    rows = jnp.arange(N)[:, None]

    def body(k, L):
        off = k * bs
        col = jax.lax.dynamic_slice(L, (0, off), (N, bs))  # (N, bs)
        diag = jax.lax.dynamic_slice(col, (off, 0), (bs, bs))
        Lkk = _chol(diag, lower=True)
        # col · Lkk⁻ᵀ for the full height; mask selects the sub-diagonal part
        sol = _st(Lkk, col.T, lower=True).T  # (N, bs)
        below = rows >= off + bs
        W = jnp.where(below, sol, 0.0)
        diag_part = jax.lax.dynamic_update_slice(
            jnp.zeros((N, bs), K.dtype), Lkk, (off, 0)
        )
        newcol = W + diag_part
        L = jax.lax.dynamic_update_slice(L, newcol, (0, off))
        # trailing SYRK: W has zero rows above off+bs, so only the trailing
        # submatrix is touched
        L = L - jnp.matmul(W, W.T, precision=_HP)
        return L

    L = jax.lax.fori_loop(0, nb, body, K)
    return jnp.tril(L)


def _chol_fwd(K, block_size):
    L = _blocked_cholesky_impl(K, block_size)
    return L, L


def _chol_bwd(block_size, L, g):
    # Murray (2016): K̄ = ½ sym(L⁻ᵀ (P + Pᵀ) L⁻¹), P = Φ(Lᵀ L̄)
    Lbar = jnp.tril(g)
    LtLbar = jnp.matmul(L.T, Lbar, precision=_HP)
    P = jnp.tril(LtLbar) - 0.5 * jnp.diag(jnp.diagonal(LtLbar))
    PPt = P + P.T
    tmp = _solve_upper_impl(L.T, PPt, block_size)  # L⁻ᵀ (P+Pᵀ)
    S = _solve_upper_impl(L.T, tmp.T, block_size).T  # … L⁻¹
    return (0.25 * (S + S.T),)


blocked_cholesky.defvjp(_chol_fwd, _chol_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def blocked_solve_lower(L, B, block_size: int = 256):
    """Solve L X = B (L lower-tri, blocked forward substitution).

    custom_vjp (standard TRSM adjoint) — avoids nb·(N,P) loop residuals.
    """
    return _solve_lower_impl(L, B, block_size)


@partial(jax.jit, static_argnames=("block_size",))
def _solve_lower_impl(L, B, block_size: int = 256):
    N = L.shape[0]
    if N % block_size != 0:
        raise ValueError(f"N={N} not divisible by block_size={block_size}")
    nb = N // block_size
    bs = block_size
    B2 = B if B.ndim == 2 else B[:, None]
    rows = jnp.arange(N)[:, None]

    def body(k, Bw):
        off = k * bs
        Lcol = jax.lax.dynamic_slice(L, (0, off), (N, bs))
        diag = jax.lax.dynamic_slice(Lcol, (off, 0), (bs, bs))
        Bk = jax.lax.dynamic_slice(Bw, (off, 0), (bs, Bw.shape[1]))
        Xk = _st(diag, Bk, lower=True)
        Bw = jax.lax.dynamic_update_slice(Bw, Xk, (off, 0))
        below = rows >= off + bs
        W = jnp.where(below, Lcol, 0.0)
        Bw = Bw - jnp.matmul(W, Xk, precision=_HP)
        return Bw

    X = jax.lax.fori_loop(0, nb, body, B2)
    return X if B.ndim == 2 else X[:, 0]


def _sl_fwd(L, B, block_size):
    X = _solve_lower_impl(L, B, block_size)
    return X, (L, X)


def _sl_bwd(block_size, res, g):
    L, X = res
    gB = _solve_upper_impl(L.T, g, block_size)  # L⁻ᵀ g
    X2 = X if X.ndim == 2 else X[:, None]
    g2 = gB if gB.ndim == 2 else gB[:, None]
    gL = -jnp.tril(jnp.matmul(g2, X2.T, precision=_HP))
    return gL, gB


blocked_solve_lower.defvjp(_sl_fwd, _sl_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def blocked_solve_upper(U, B, block_size: int = 256):
    """Solve U X = B (U upper-tri, blocked backward substitution).

    custom_vjp with the TRSM adjoint (see blocked_solve_lower).
    """
    return _solve_upper_impl(U, B, block_size)


def _su_fwd(U, B, block_size):
    X = _solve_upper_impl(U, B, block_size)
    return X, (U, X)


def _su_bwd(block_size, res, g):
    U, X = res
    gB = _solve_lower_impl(U.T, g, block_size)  # U⁻ᵀ g
    X2 = X if X.ndim == 2 else X[:, None]
    g2 = gB if gB.ndim == 2 else gB[:, None]
    gU = -jnp.triu(jnp.matmul(g2, X2.T, precision=_HP))
    return gU, gB


@partial(jax.jit, static_argnames=("block_size",))
def _solve_upper_impl(U, B, block_size: int = 256):
    N = U.shape[0]
    if N % block_size != 0:
        raise ValueError(f"N={N} not divisible by block_size={block_size}")
    nb = N // block_size
    bs = block_size
    B2 = B if B.ndim == 2 else B[:, None]
    rows = jnp.arange(N)[:, None]

    def body(i, Bw):
        k = nb - 1 - i
        off = k * bs
        Ucol = jax.lax.dynamic_slice(U, (0, off), (N, bs))
        diag = jax.lax.dynamic_slice(Ucol, (off, 0), (bs, bs))
        Bk = jax.lax.dynamic_slice(Bw, (off, 0), (bs, Bw.shape[1]))
        Xk = _st(diag, Bk, lower=False)
        Bw = jax.lax.dynamic_update_slice(Bw, Xk, (off, 0))
        above = rows < off
        W = jnp.where(above, Ucol, 0.0)
        Bw = Bw - jnp.matmul(W, Xk, precision=_HP)
        return Bw

    X = jax.lax.fori_loop(0, nb, body, B2)
    return X if B.ndim == 2 else X[:, 0]

blocked_solve_upper.defvjp(_su_fwd, _su_bwd)
