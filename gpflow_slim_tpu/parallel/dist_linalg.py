"""Distributed dense linear algebra + the multi-host exact-GPR path.

BASELINE config #5: exact GPR at N beyond one device's memory. The pieces:

  * ``distributed_cholesky`` / ``distributed_solve_lower`` — the blocked
    slab algorithms of ``ops.blocked`` run under row sharding; every
    per-step operand is a full-height (N, bs) slab, so XLA's SPMD
    partitioner turns the TRSM panel broadcast and SYRK trailing update
    into collectives (the panel's bs×bs diagonal block is gathered,
    everything else stays local to its row shard).
  * ``distributed_gpr_mll`` — ring-Gram (never materializes K unsharded)
    → sharded blocked Cholesky → sharded solves → scalar reduction. Fully
    differentiable: ``jax.grad`` through it gives the distributed
    hyperparameter gradient for N=50k-class problems.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.blocked import (
    blocked_cholesky,
    blocked_solve_lower,
    blocked_solve_upper,
)
from .ring_gram import ring_gram

__all__ = [
    "distributed_cholesky",
    "distributed_solve_lower",
    "distributed_gpr_mll",
    "make_distributed_gpr_loss",
]


def _row_sharding(mesh, axis):
    return NamedSharding(mesh, P(axis))


def distributed_cholesky(K, mesh: Mesh, axis: str = "rows",
                         block_size: int = 256):
    K = jax.lax.with_sharding_constraint(K, _row_sharding(mesh, axis))
    L = blocked_cholesky(K, block_size=block_size)
    return jax.lax.with_sharding_constraint(L, _row_sharding(mesh, axis))


def distributed_solve_lower(L, B, mesh: Mesh, axis: str = "rows",
                            block_size: int = 256):
    L = jax.lax.with_sharding_constraint(L, _row_sharding(mesh, axis))
    return blocked_solve_lower(L, B, block_size=block_size)


def distributed_gpr_mll(kern, noise_variance, X, Y, mesh: Mesh,
                        axis: str = "rows", block_size: int = 256,
                        mean=None):
    """Exact GPR log marginal likelihood, distributed over ``axis``.

    X (N, D), Y (N, P) row-sharded (N divisible by mesh axis and
    block_size). Returns the scalar MVN logpdf — same math as
    ``models.GPR.build_likelihood`` (densities.multivariate_normal), built
    from ring-Gram + sharded blocked Cholesky.
    """
    N, D = X.shape
    num_out = Y.shape[1]
    sharding = _row_sharding(mesh, axis)
    X = jax.lax.with_sharding_constraint(X, sharding)
    Y = jax.lax.with_sharding_constraint(Y, sharding)

    K = ring_gram(kern, X, mesh, axis=axis)  # (N, N) row-sharded
    K = K + noise_variance * jnp.eye(N, dtype=K.dtype)
    K = jax.lax.with_sharding_constraint(K, sharding)

    L = blocked_cholesky(K, block_size=block_size)
    err = Y if mean is None else Y - mean
    alpha = blocked_solve_lower(L, err, block_size=block_size)

    mll = -0.5 * N * num_out * jnp.log(2.0 * jnp.pi)
    mll -= num_out * jnp.sum(jnp.log(jnp.diagonal(L)))
    mll -= 0.5 * jnp.sum(jnp.square(alpha))
    return mll


def make_distributed_gpr_loss(model, mesh: Mesh, axis: str = "rows",
                              block_size: int = 256):
    """Jittable distributed −log marginal likelihood of a GPR model pytree.

    ``loss_fn(model) -> scalar``; grads flow to kernel/noise params through
    the ring Gram and the blocked factorization.
    """

    def loss_fn(m):
        noise = jnp.squeeze(m.likelihood.variance.value)
        mean = m.mean_function(m.X)
        mll = distributed_gpr_mll(
            m.kern, noise, m.X, m.Y, mesh, axis=axis,
            block_size=block_size, mean=mean,
        )
        return -(mll + m.log_prior())

    return loss_fn
