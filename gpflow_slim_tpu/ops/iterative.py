"""Matrix-free iterative linear algebra for large-N GP inference.

Techniques from the retrieved scaling literature (PAPERS.md): GPyTorch-style
blackbox matrix-matrix inference (CG solves + stochastic Lanczos quadrature
logdet, Gardner et al. 2018) with partial pivoted-Cholesky preconditioning
(Gardner et al. 2021). These give an O(N²·iters) marginal-likelihood path —
vs O(N³) Cholesky — whose matvecs are pure GEMMs and compose with the
ring Gram matvec (parallel.ring_gram_matvec) for sharded N.

All loops are ``lax.fori_loop`` / ``lax.scan`` with static bounds — one XLA
program.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["batched_cg", "lanczos_tridiag", "slq_logdet",
           "pivoted_cholesky", "woodbury_solve_fn"]


def batched_cg(matvec: Callable, B, max_iters: int = 100, tol: float = 1e-6,
               precond: Callable | None = None):
    """Solve A X = B for PSD A with (preconditioned) conjugate gradients.

    B: (N, P) — all right-hand sides iterate together (matrix-matrix
    products, the BBMM trick). Runs a fixed ``max_iters`` with
    convergence masking (static shapes; converged columns stop updating).
    Returns (X, residual_norms (P,)).
    """
    if precond is None:
        precond = lambda v: v

    X0 = jnp.zeros_like(B)
    R0 = B  # residual
    Z0 = precond(R0)
    P0 = Z0
    rz0 = jnp.sum(R0 * Z0, axis=0)  # (P,)
    bnorm = jnp.sqrt(jnp.sum(B * B, axis=0)) + 1e-30

    def body(i, carry):
        X, R, P, rz = carry
        AP = matvec(P)
        denom = jnp.sum(P * AP, axis=0)
        alpha = rz / jnp.where(denom == 0, 1.0, denom)
        active = jnp.sqrt(jnp.sum(R * R, axis=0)) / bnorm > tol
        alpha = jnp.where(active, alpha, 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = precond(R)
        rz_new = jnp.sum(R * Z, axis=0)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        beta = jnp.where(active, beta, 0.0)
        P = Z + beta[None, :] * P
        return (X, R, P, rz_new)

    X, R, _, _ = jax.lax.fori_loop(0, max_iters, body, (X0, R0, P0, rz0))
    res = jnp.sqrt(jnp.sum(R * R, axis=0)) / bnorm
    return X, res


def lanczos_tridiag(matvec: Callable, v0, num_steps: int):
    """Lanczos tridiagonalization from start vector v0 (full
    reorthogonalization-free, fixed steps). Returns (alphas (m,), betas (m-1,)).
    """
    v = v0 / jnp.linalg.norm(v0)

    def step(carry, _):
        v_prev, v_cur, beta_prev = carry
        w = matvec(v_cur) - beta_prev * v_prev
        alpha = jnp.dot(w, v_cur)
        w = w - alpha * v_cur
        beta = jnp.linalg.norm(w)
        v_next = w / jnp.where(beta == 0, 1.0, beta)
        return (v_cur, v_next, beta), (alpha, beta)

    init = (jnp.zeros_like(v), v, jnp.zeros((), v.dtype))
    _, (alphas, betas) = jax.lax.scan(step, init, None, length=num_steps)
    return alphas, betas[:-1]


def slq_logdet(matvec: Callable, dim: int, key, num_probes: int = 16,
               num_steps: int = 20, dtype=jnp.float32):
    """Stochastic Lanczos quadrature estimate of log det A (A PSD).

    E_z[zᵀ log(A) z] with Rademacher probes; each probe runs ``num_steps``
    Lanczos iterations, the (m×m) tridiagonal eigendecomposition gives the
    quadrature nodes/weights: zᵀlog(A)z ≈ ‖z‖² Σ_k (e₁ᵀu_k)² log λ_k.
    """
    def one_probe(k):
        z = jax.random.rademacher(k, (dim,), dtype=dtype)
        alphas, betas = lanczos_tridiag(matvec, z, num_steps)
        T = (
            jnp.diag(alphas)
            + jnp.diag(betas, 1)
            + jnp.diag(betas, -1)
        )
        lam, U = jnp.linalg.eigh(T)
        lam = jnp.maximum(lam, 1e-10)
        w = jnp.square(U[0, :])
        return jnp.sum(w * jnp.log(lam)) * (dim * 1.0)

    keys = jax.random.split(key, num_probes)
    ests = jax.vmap(one_probe)(keys)
    return jnp.mean(ests)


@partial(jax.jit, static_argnames=("rank",))
def pivoted_cholesky(K, rank: int):
    """Partial pivoted Cholesky: K ≈ L Lᵀ with L (N, rank).

    Greedy max-diagonal pivoting (the GPyTorch preconditioner). Jittable:
    fixed ``rank`` iterations with argmax pivoting via one-hot gathers.
    """
    N = K.shape[0]
    d = jnp.diagonal(K)
    L = jnp.zeros((N, rank), K.dtype)
    picked = jnp.zeros((N,), bool)  # separate mask: −inf sentinels in d get
    # resurrected by the max(…, 0) clip, so previously-chosen pivots could
    # be re-picked on rank-deficient inputs

    def body(i, carry):
        d, L, picked = carry
        p = jnp.argmax(jnp.where(picked, -jnp.inf, d))
        pivot = jnp.maximum(d[p], 1e-12)
        # row p of K minus correction from previous factors
        Kp = K[p, :]  # gather row (dynamic index ok at jnp level)
        corr = L @ L[p, :]  # (N,)
        col = (Kp - corr) / jnp.sqrt(pivot)
        col = col.at[p].set(jnp.sqrt(pivot))
        L = L.at[:, i].set(col)
        d = jnp.maximum(d - jnp.square(col), 0.0)
        picked = picked.at[p].set(True)
        return (d, L, picked)

    _, L, _ = jax.lax.fori_loop(0, rank, body, (d, L, picked))
    return L


def woodbury_solve_fn(L, sigma2):
    """Return v ↦ (L Lᵀ + σ²I)⁻¹ v (Woodbury), for preconditioning CG.

    L: (N, k) low-rank factor; cost O(Nk) per apply after an O(k³) setup.
    """
    N, k = L.shape
    M = jnp.eye(k, dtype=L.dtype) + (L.T @ L) / sigma2
    Mchol = jax.scipy.linalg.cho_factor(M, lower=True)

    def solve(v):
        # (σ²I + LLᵀ)⁻¹ v = v/σ² − L M⁻¹ Lᵀ v / σ⁴
        Ltv = L.T @ v
        inner = jax.scipy.linalg.cho_solve(Mchol, Ltv)
        return v / sigma2 - (L @ inner) / (sigma2 * sigma2)

    return solve


def probe_keys(*params):
    """PRNG keys for stochastic-trace probes, derived from the bit pattern
    of the current (hyper)parameters.

    A FIXED probe key freezes the SLQ/Hutchinson estimator error into one
    systematic bias for a whole optimization (the estimator is only
    unbiased across redraws). Deriving the key from the parameter bits
    redraws probes at every optimizer step (parameters moved ⇒ new key)
    while keeping each evaluation self-consistent (value/grad and fwd/bwd
    see identical probes) and deterministic given the parameters.

    The hash must be (a) full-precision — under f64 defaults, late-training
    optimizer steps move parameters by less than f32 resolution, and an
    f32-downcast hash would silently reuse the same probes (re-freezing the
    bias this function exists to remove) — and (b) order-sensitive, so
    permutation-symmetric parameter states don't collide. So: hash the
    native bit pattern (f64 leaves as two uint32 halves) and mix each leaf
    at a position-dependent odd multiplier before folding in.

    Returns ``(key_logdet, key_trace)``.
    """
    acc = jnp.zeros((), jnp.uint32)
    leaf_idx = 0
    for p in params:
        for leaf in jax.tree_util.tree_leaves(p):
            x = jax.lax.stop_gradient(jnp.ravel(jnp.asarray(leaf)))
            if x.dtype == jnp.float64:
                # hash without a u64 bitcast (not every backend lowers
                # one): split into an exact f32 head plus the f32-rounded residual
                # (≈48 mantissa bits total — resolves steps far below f32
                # resolution) and hash both halves
                hi = x.astype(jnp.float32)
                lo = (x - hi.astype(jnp.float64)).astype(jnp.float32)
                bits = jnp.concatenate([
                    jax.lax.bitcast_convert_type(hi, jnp.uint32),
                    jax.lax.bitcast_convert_type(lo, jnp.uint32),
                ])
            else:
                bits = jax.lax.bitcast_convert_type(
                    x.astype(jnp.float32), jnp.uint32
                )
            # position-dependent odd multiplier (mod 2³²) makes the mix
            # order-sensitive across leaves AND across elements in a leaf
            mult = (
                jnp.arange(bits.shape[0], dtype=jnp.uint32)
                * jnp.uint32(2654435761)  # Knuth multiplicative constant
                + jnp.uint32(2 * leaf_idx + 1)
            )
            acc = acc * jnp.uint32(16777619) ^ jnp.sum(
                bits * mult, dtype=jnp.uint32
            )
            leaf_idx += 1
    base = jax.random.fold_in(jax.random.PRNGKey(0), acc)
    return jax.random.fold_in(base, 0), jax.random.fold_in(base, 1)
