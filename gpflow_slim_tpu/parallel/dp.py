"""Data-parallel SVGP training (SURVEY §2.2 row "DP").

The reference minibatches through feed_dict on one device. Here the
minibatch axis is sharded over the ``data`` mesh axis. Two equivalent paths:

  * ``dp_value_and_grad`` — explicit ``shard_map``: each device computes the
    variational-expectation sum on its batch shard, ``psum``s it, and the
    (replicated) KL is added once; gradients therefore allreduce over the interconnect.
  * ``fit_svgp`` — the pjit path: batch arrays carry a
    ``NamedSharding(mesh, P("data"))``, params are replicated, and XLA's
    SPMD partitioner inserts the same collectives automatically. This is
    the production path (fusion + overlap for free); the shard_map path is
    the explicit-control variant and the one ``dryrun_multichip`` exercises.

Minibatch sampling happens inside jit (``jax.random.choice`` + ``take``) —
no host round trip per step, unlike the reference's feed_dict (SURVEY §3.3).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import trainable_leaf_mask

__all__ = ["dp_value_and_grad", "fit_svgp", "make_svgp_step"]


def _elbo_parts(model, Xb, Yb, scale):
    """(local variational-expectation sum, KL). ELBO = scale·Σve − KL."""
    fmean, fvar = model._conditional_batch(Xb)
    ve = model.likelihood.variational_expectations(fmean, fvar, Yb)
    return jnp.sum(ve) * scale, model.prior_kl()


def dp_value_and_grad(model, Xb, Yb, mesh: Mesh, axis: str = "data"):
    """Explicit shard_map data-parallel (−ELBO, grad) over a sharded batch.

    Xb/Yb are sharded over ``axis`` (global batch B); the model pytree is
    replicated. Returns (loss, grads) replicated on every device.
    """
    B = Xb.shape[0]
    n_dev = mesh.shape[axis]
    if B % n_dev != 0:
        raise ValueError(f"batch {B} not divisible by mesh axis {n_dev}")
    scale = model.num_data / B

    def per_device(m, xb, yb):
        # local loss = this shard's share; global loss/grad via psum — the
        # gradient allreduce is THE data-parallel collective
        def local_loss(mm):
            # loss = −(ELBO + log_prior) = −scale·Σve + KL − log_prior,
            # with the replicated KL/prior terms divided across devices so
            # the psum reconstructs them exactly once
            ve_local, kl = _elbo_parts(mm, xb, yb, 1.0)
            return -scale * ve_local + (kl - mm.log_prior()) / n_dev

        loss_local, grads_local = jax.value_and_grad(local_loss)(m)
        loss = jax.lax.psum(loss_local, axis)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, axis), grads_local
        )
        return loss, grads

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(model, Xb, Yb)


def make_svgp_step(model, optimizer, mesh: Mesh | None = None,
                   axis: str = "data", batch_size: int | None = None):
    """Build a jitted stochastic step: sample minibatch → dp grad → update.

    Returns ``(step_fn, (leaves, opt_state, treedef))`` with
    ``step_fn(leaves, opt_state, key) -> (leaves, opt_state, loss)``.
    """
    mask = trainable_leaf_mask(model)
    # state only for trainable leaves (no Adam moments over X/Y data)
    optimizer = optax.masked(optimizer, list(mask))
    leaves0, treedef = jax.tree_util.tree_flatten(model)
    opt_state = optimizer.init(leaves0)
    N = model.num_data
    B = batch_size or N

    def step_fn(leaves, opt_state, key):
        m = jax.tree_util.tree_unflatten(treedef, leaves)
        idx = jax.random.choice(key, N, shape=(B,), replace=False)
        Xb = jnp.take(m.X, idx, axis=0)
        Yb = jnp.take(m.Y, idx, axis=0)
        if mesh is not None:
            Xb = jax.lax.with_sharding_constraint(
                Xb, NamedSharding(mesh, P(axis))
            )
            Yb = jax.lax.with_sharding_constraint(
                Yb, NamedSharding(mesh, P(axis))
            )

        def loss_fn(mm):
            return -(mm.build_likelihood_batch(Xb, Yb) + mm.log_prior())

        loss, grads = jax.value_and_grad(loss_fn)(m)
        g_leaves = [
            g * t for g, t in zip(jax.tree_util.tree_leaves(grads), mask)
        ]
        updates, opt_state = optimizer.update(g_leaves, opt_state, leaves)
        updates = [u * t for u, t in zip(updates, mask)]
        leaves = [l + u for l, u in zip(leaves, updates)]
        return leaves, opt_state, loss

    return step_fn, (leaves0, opt_state, treedef)


def fit_svgp(model, num_steps: int, key, learning_rate: float = 0.01,
             batch_size: int | None = None, mesh: Mesh | None = None,
             axis: str = "data", optimizer=None):
    """Stochastic SVGP training, whole loop jitted via lax.scan.

    With a mesh, the minibatch is sharded over ``axis`` each step (pjit
    path: XLA inserts the gradient allreduce).
    """
    if optimizer is None:
        optimizer = optax.adam(learning_rate)
    step_fn, (leaves0, opt_state, treedef) = make_svgp_step(
        model, optimizer, mesh=mesh, axis=axis, batch_size=batch_size
    )

    @jax.jit
    def run(leaves, opt_state, key):
        def body(carry, k):
            leaves, opt_state = carry
            leaves, opt_state, loss = step_fn(leaves, opt_state, k)
            return (leaves, opt_state), loss

        keys = jax.random.split(key, num_steps)
        (leaves, opt_state), losses = jax.lax.scan(
            body, (leaves, opt_state), keys
        )
        return leaves, losses

    leaves, losses = run(leaves0, opt_state, key)
    return jax.tree_util.tree_unflatten(treedef, leaves), losses
