"""Distributed matrix-free exact-GP marginal likelihood (CG/SLQ over a
row-sharded mesh axis).

Combines the ring Gram matvec (``ring_gram.ring_gram_matvec`` — K is never
materialized, each chip streams its block row against ppermute-rotated
shards) with the BBMM CG/SLQ estimator of ``models.cg_gpr``: CG solves and
Lanczos run at the jit level on row-sharded global arrays, so their inner
reductions compile to `psum`s, and the custom-VJP backward
differentiates only ring-matvec quadratic forms (stop-gradded solves).

This is the N-beyond-everything path: per-chip memory is O(N·D/P + N·B/P)
— no chip ever holds a Gram panel larger than (N/P)².
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.iterative import batched_cg, probe_keys, slq_logdet
from .mesh import NamedSharding, P
from .ring_gram import ring_gram_matvec

__all__ = ["make_distributed_cg_loss"]


def make_distributed_cg_loss(model, mesh, axis: str = "rows",
                             num_probes: int = 16, cg_iters: int = 100,
                             slq_steps: int = 25):
    """Differentiable ``loss_fn(model) -> -(mll + log_prior)`` for an
    exact-GP regression model, matrix-free over ``mesh[axis]``.

    ``model.X``/``model.Y`` are captured (row-sharded) at CONSTRUCTION
    time; the ``model`` argument of the returned ``loss_fn`` contributes
    only hyperparameters (kern / likelihood / mean_function). Calling
    ``loss_fn`` with a model holding different data would silently score
    the captured data — guarded by a shape assert below; rebuild the loss
    for new data. N must divide by the axis size.
    """
    sharding = NamedSharding(mesh, P(axis))
    X = jax.device_put(model.X, sharding)
    Y = jax.device_put(model.Y, sharding)
    N = X.shape[0]

    def matvec(kern, noise, v):
        return ring_gram_matvec(kern, X, v, mesh, axis=axis, noise=noise)

    @jax.custom_vjp
    def mll_fn(kern, noise, err):
        mll, _ = mll_fwd(kern, noise, err)
        return mll

    def mll_fwd(kern, noise, err):
        num_out = err.shape[1]
        mv = lambda v: matvec(kern, noise, v)
        alpha, _ = batched_cg(mv, err, max_iters=cg_iters)
        # parameter-bit-derived keys (ops.iterative.probe_keys): probes are
        # redrawn whenever the hyperparameters move, so the estimator error
        # averages out over training steps instead of freezing into a bias
        key_logdet, key_trace = probe_keys(kern, noise)
        logdet = slq_logdet(mv, N, key_logdet,
                            num_probes=num_probes, num_steps=slq_steps,
                            dtype=err.dtype)
        Z = jax.device_put(
            jax.random.rademacher(key_trace, (N, num_probes),
                                  dtype=err.dtype),
            sharding,
        )
        U, _ = batched_cg(mv, Z, max_iters=cg_iters)
        mll = (
            -0.5 * jnp.sum(err * alpha)
            - 0.5 * num_out * logdet
            - 0.5 * N * num_out * jnp.log(2.0 * jnp.pi)
        )
        return mll, (kern, noise, err, alpha, Z, U)

    def mll_bwd(res, g):
        kern, noise, err, alpha, Z, U = res
        num_out = err.shape[1]
        alpha = jax.lax.stop_gradient(alpha)
        Z = jax.lax.stop_gradient(Z)
        U = jax.lax.stop_gradient(U)

        def surrogate(kern, noise, err):
            t_quad = 0.5 * jnp.sum(alpha * matvec(kern, noise, alpha))
            t_trace = (-0.5 * num_out / num_probes
                       * jnp.sum(U * matvec(kern, noise, Z)))
            t_err = -jnp.sum(err * alpha)
            return t_quad + t_trace + t_err

        grads = jax.grad(surrogate, argnums=(0, 1, 2))(kern, noise, err)
        return tuple(jax.tree_util.tree_map(lambda a: a * g, grads))

    mll_fn.defvjp(mll_fwd, mll_bwd)

    def loss_fn(m):
        if m.X.shape != X.shape or m.Y.shape != Y.shape:
            raise ValueError(
                "loss_fn was built against data of shape "
                f"X{tuple(X.shape)}/Y{tuple(Y.shape)} but was called with a "
                f"model holding X{tuple(m.X.shape)}/Y{tuple(m.Y.shape)}; "
                "make_distributed_cg_loss captures the data at construction "
                "— rebuild the loss for new data"
            )
        noise = jnp.squeeze(m.likelihood.variance.value)
        err = Y - m.mean_function(X)
        return -(mll_fn(m.kern, noise, err) + m.log_prior())

    return loss_fn
