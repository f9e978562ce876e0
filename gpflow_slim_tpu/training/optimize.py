"""Training loops: optax-driven hyperparameter optimization.

The reference has no training layer — users run
``tf.train.AdamOptimizer(...).minimize(model.objective)`` in a ``sess.run``
loop (SURVEY §1 L6). The JAX equivalent: the model is a pytree, the
loss is ``model.objective()``, and one jitted step fuses
forward+backward+update into a single XLA executable. ``lax.scan`` over
steps keeps the whole optimization on-device (no per-step host round trip —
the reference's feed_dict bottleneck is gone by construction).

``fit``     — Adam (or any optax GradientTransformation) over trainable
              unconstrained leaves; non-trainable leaves are masked out.
``fit_scipy_like`` — L-BFGS via optax (the reference's ScipyOptimizer role).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import jax
import jax.numpy as jnp
import optax

from ..params import trainable_leaf_mask


def _masked_update(updates_leaves, mask):
    return [u * m for u, m in zip(updates_leaves, mask)]


@lru_cache(maxsize=64)
def _fit_runner(treedef, mask, num_steps, unroll, learning_rate,
                optimizer, loss_fn):
    """Compiled-runner cache: repeated ``fit`` calls with the same model
    STRUCTURE (treedef/mask — data and parameter values are runtime args)
    reuse one jitted executable instead of re-tracing and re-compiling a
    fresh closure each call. Keys are hashable: treedefs, bool tuples,
    numbers, and (for custom optimizer/loss_fn) object identity."""
    if optimizer is None:
        optimizer = optax.adam(learning_rate)
    if loss_fn is None:
        loss_fn = lambda m: m.objective()
    # optax.masked: optimizer state (Adam moments etc.) is only allocated
    # for TRAINABLE leaves — without it, two data-sized moment buffers per
    # data array (X, Y) sit in HBM for the whole scan
    optimizer = optax.masked(optimizer, list(mask))

    def step(carry, _):
        leaves, opt_state = carry
        m = jax.tree_util.tree_unflatten(treedef, leaves)
        loss, grads = jax.value_and_grad(loss_fn)(m)
        grad_leaves = jax.tree_util.tree_leaves(grads)
        grad_leaves = _masked_update(grad_leaves, mask)
        updates, opt_state = optimizer.update(grad_leaves, opt_state, leaves)
        updates = _masked_update(updates, mask)
        leaves = [l + u for l, u in zip(leaves, updates)]
        return (leaves, opt_state), loss

    @jax.jit
    def run(leaves, opt_state):
        (leaves, opt_state), losses = jax.lax.scan(
            step, (leaves, opt_state), None, length=num_steps, unroll=unroll
        )
        return leaves, opt_state, losses

    return optimizer, run


def fit(
    model,
    num_steps: int = 1000,
    learning_rate: float = 0.01,
    optimizer: optax.GradientTransformation | None = None,
    loss_fn: Callable | None = None,
    unroll: int = 1,
):
    """Minimize ``loss_fn(model)`` (default ``model.objective()``).

    Returns ``(fitted_model, losses)`` with ``losses`` of shape (num_steps,).
    The full loop runs on-device under one jit via ``lax.scan``; repeated
    calls with the same model structure reuse the compiled executable.
    """
    mask = tuple(trainable_leaf_mask(model))
    leaves0, treedef = jax.tree_util.tree_flatten(model)
    opt, run = _fit_runner(treedef, mask, num_steps, unroll,
                           learning_rate, optimizer, loss_fn)
    opt_state = opt.init(leaves0)
    leaves, opt_state, losses = run(leaves0, opt_state)
    return jax.tree_util.tree_unflatten(treedef, leaves), losses


def make_step_fn(model, optimizer: optax.GradientTransformation,
                 loss_fn: Callable | None = None):
    """Build ``(step_fn, init_state)`` for user-driven loops.

    ``step_fn(leaves, opt_state) -> (leaves, opt_state, loss)`` is jittable;
    ``leaves`` are ``tree_leaves(model)``.
    """
    if loss_fn is None:
        loss_fn = lambda m: m.objective()
    mask = trainable_leaf_mask(model)
    optimizer = optax.masked(optimizer, list(mask))
    leaves0, treedef = jax.tree_util.tree_flatten(model)
    opt_state = optimizer.init(leaves0)

    def step_fn(leaves, opt_state):
        m = jax.tree_util.tree_unflatten(treedef, leaves)
        loss, grads = jax.value_and_grad(loss_fn)(m)
        grad_leaves = _masked_update(jax.tree_util.tree_leaves(grads), mask)
        updates, opt_state = optimizer.update(grad_leaves, opt_state, leaves)
        updates = _masked_update(updates, mask)
        leaves = [l + u for l, u in zip(leaves, updates)]
        return leaves, opt_state, loss

    return step_fn, (leaves0, treedef, opt_state)


def fit_lbfgs(model, num_steps: int = 100, loss_fn: Callable | None = None):
    """L-BFGS over the trainable unconstrained parameters (ScipyOptimizer role)."""
    if loss_fn is None:
        loss_fn = lambda m: m.objective()

    from ..params import pack_trainable

    vec0, unpack = pack_trainable(model)

    def flat_loss(v):
        return loss_fn(unpack(v))

    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(flat_loss)

    def step(carry, _):
        v, state = carry
        loss, grad = value_and_grad(v, state=state)
        updates, state = opt.update(
            grad, state, v, value=loss, grad=grad, value_fn=flat_loss
        )
        v = optax.apply_updates(v, updates)
        return (v, state), loss

    @jax.jit
    def run(v):
        state = opt.init(v)
        (v, _), losses = jax.lax.scan(step, (v, state), None, length=num_steps)
        return v, losses

    v, losses = run(vec0)
    return unpack(v), losses
