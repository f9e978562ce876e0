"""Iterative multinomial NUTS, fully jittable (north-star addition; the
reference lineage has fixed-length leapfrog HMC only — SURVEY §3.4).

Design (XLA-compatible: static bounds, no recursion):
  * outer ``lax.while_loop`` over tree doublings up to ``max_depth``;
  * each doubling integrates ``2^depth`` leapfrog steps in a
    ``lax.fori_loop``, with the **iterative U-turn checkpoint scheme**:
    even-indexed leaves are stored in a ``max_depth``-slot buffer at
    ``slot = popcount(i)``; at a leaf ``i`` with ``t`` trailing one-bits the
    subtrees of sizes 2,4,…,2^t end, and their start states live in slots
    ``popcount(i)−t … popcount(i)−1`` — O(max_depth) memory, exact NUTS
    U-turn checks without recursion;
  * multinomial (progressive) sampling of the proposal within each subtree,
    biased sampling across subtrees (Betancourt's scheme);
  * divergence when ΔH > 1000; dual-averaging warmup + diagonal mass
    adaptation (Welford) shared across chains via ``lax.pmean`` when run
    under ``shard_map``/``vmap`` with a named axis.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .base import (
    da_init,
    da_update,
    kinetic_energy,
    leapfrog,
    welford_init,
    welford_update,
    welford_variance,
)

_MAX_DELTA_ENERGY = 1000.0


def warmup_schedule(num_warmup: int, init_buffer: int = 75,
                    term_buffer: int = 50, base_window: int = 25):
    """Stan-style adaptation windows: ``[("fast", n), ("slow", n), ...]``.

    An initial fast window adapts the step size only; then doubling slow
    windows (25, 50, 100, …) accumulate Welford moments and re-estimate
    the diagonal mass at each window end (restarting dual averaging with
    the new metric); a final fast window re-tunes the step size against
    the final mass. The last slow window absorbs any remainder. For short
    warmups the buffers scale proportionally (15% / 75% / 10%).
    """
    if num_warmup <= 0:
        return []
    if num_warmup < 20:
        return [("fast", num_warmup)]
    if init_buffer + base_window + term_buffer > num_warmup:
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.10 * num_warmup))
        base_window = num_warmup - init_buffer - term_buffer
    windows = [("fast", init_buffer)]
    slow_end = num_warmup - term_buffer
    pos, w = init_buffer, base_window
    while pos < slow_end:
        end = slow_end if pos + 3 * w > slow_end else pos + w
        windows.append(("slow", end - pos))
        pos, w = end, 2 * w
    windows.append(("fast", term_buffer))
    return windows


class _TreeState(NamedTuple):
    """State of the growing NUTS trajectory."""

    z_left: jnp.ndarray
    r_left: jnp.ndarray
    grad_left: jnp.ndarray
    z_right: jnp.ndarray
    r_right: jnp.ndarray
    grad_right: jnp.ndarray
    z_proposal: jnp.ndarray
    logp_proposal: jnp.ndarray
    grad_proposal: jnp.ndarray
    log_weight: jnp.ndarray  # log Σ exp(−ΔH) over leaves
    depth: jnp.ndarray
    turning: jnp.ndarray
    diverging: jnp.ndarray
    sum_accept_prob: jnp.ndarray
    num_leaves: jnp.ndarray


def _is_turning(z_minus, r_minus, z_plus, r_plus, inv_mass):
    dz = z_plus - z_minus
    return jnp.logical_or(
        jnp.dot(dz, r_minus * inv_mass) < 0.0,
        jnp.dot(dz, r_plus * inv_mass) < 0.0,
    )


def _popcount(x):
    # 32-bit popcount via bit tricks (jnp has no builtin for int32 scalars)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def _trailing_ones(x):
    # number of trailing 1-bits = popcount(x & ~(x+1))
    return _popcount(x & ~(x + 1))


def _build_subtree(logprob_grad_fn, z0, r0, grad0, depth, direction,
                   step_size, inv_mass, H0, key, max_depth):
    """Integrate 2^depth leapfrog steps from (z0, r0); iterative U-turn checks.

    Returns (z_end, r_end, grad_end, z_prop, logp_prop, grad_prop,
    log_weight, turning, diverging, sum_accept, num_leaves).
    """
    dim = z0.shape[0]
    dtype = z0.dtype
    num_steps = jnp.asarray(1, jnp.int32) << depth
    eps = direction * step_size

    ckpt_z = jnp.zeros((max_depth + 1, dim), dtype)
    ckpt_r = jnp.zeros((max_depth + 1, dim), dtype)

    class Carry(NamedTuple):
        z: jnp.ndarray
        r: jnp.ndarray
        grad: jnp.ndarray
        z_prop: jnp.ndarray
        logp_prop: jnp.ndarray
        grad_prop: jnp.ndarray
        log_weight: jnp.ndarray
        turning: jnp.ndarray
        diverging: jnp.ndarray
        sum_accept: jnp.ndarray
        ckpt_z: jnp.ndarray
        ckpt_r: jnp.ndarray
        key: jnp.ndarray
        leaves_done: jnp.ndarray

    def body(i, c: Carry):
        z, r, lp, grad = leapfrog(
            logprob_grad_fn, c.z, c.r, c.grad, eps, inv_mass
        )
        H = lp - kinetic_energy(r, inv_mass)
        delta = H - H0  # log w_leaf
        # NaN-robust divergence: an f32 posterior can return NaN logp/grad
        # at extreme hyperparameters (non-PD Cholesky); `delta < -MAX` is
        # False for NaN, which would leak NaN into sum_accept → dual
        # averaging → step size for the rest of warmup (observed in f32,
        # R̂ ~ 1e6). ~(delta >= -MAX) flags NaN as a divergence, and the
        # leaf is excluded from the weights/statistics below.
        diverging = jnp.logical_not(delta >= -_MAX_DELTA_ENERGY)
        delta = jnp.where(diverging, -jnp.inf, delta)
        accept_prob = jnp.where(
            diverging, 0.0, jnp.minimum(1.0, jnp.exp(delta))
        )

        # progressive multinomial proposal within the subtree
        key, k_acc = jax.random.split(c.key)
        log_weight_new = jnp.logaddexp(c.log_weight, delta)
        p_switch = jnp.exp(delta - log_weight_new)
        switch = jax.random.uniform(k_acc, (), dtype) < p_switch
        z_prop = jnp.where(switch, z, c.z_prop)
        logp_prop = jnp.where(switch, lp, c.logp_prop)
        grad_prop = jnp.where(switch, grad, c.grad_prop)

        # iterative U-turn checks
        pc = _popcount(i)
        is_even = (i % 2) == 0

        # store even leaves at slot popcount(i)
        ckpt_z = jnp.where(
            is_even, c.ckpt_z.at[pc].set(z), c.ckpt_z
        )
        ckpt_r = jnp.where(
            is_even, c.ckpt_r.at[pc].set(r), c.ckpt_r
        )

        # odd leaves close t subtrees: check slots pc-t .. pc-1 — vectorized
        # over all slots with an activity mask (no sequential inner scan in
        # the leapfrog hot loop)
        t = _trailing_ones(i)
        slots = jnp.arange(max_depth + 1, dtype=jnp.int32)
        active = (slots >= pc - t) & (slots <= pc - 1)  # (S,)
        # orientation: forward ⇒ checkpoint is the left end, else the right
        dz = jnp.where(direction > 0, z[None, :] - ckpt_z, ckpt_z - z[None, :])
        r_left = jnp.where(direction > 0, ckpt_r, r[None, :])
        r_right = jnp.where(direction > 0, r[None, :], ckpt_r)
        turn_k = jnp.logical_or(
            jnp.sum(dz * (r_left * inv_mass), axis=1) < 0.0,
            jnp.sum(dz * (r_right * inv_mass), axis=1) < 0.0,
        )
        turning_here = jnp.logical_and(
            jnp.logical_not(is_even), jnp.any(active & turn_k)
        )

        done = jnp.logical_or(c.turning, c.diverging)
        new = Carry(
            z=z, r=r, grad=grad,
            z_prop=z_prop, logp_prop=logp_prop, grad_prop=grad_prop,
            log_weight=log_weight_new,
            turning=jnp.logical_or(c.turning, turning_here),
            diverging=jnp.logical_or(c.diverging, diverging),
            sum_accept=c.sum_accept + accept_prob,
            ckpt_z=ckpt_z, ckpt_r=ckpt_r, key=key,
            leaves_done=c.leaves_done + 1,
        )
        # freeze the carry once turning/diverging (masked continuation)
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(done, a, b), c, new
        )

    init = Carry(
        z=z0, r=r0, grad=grad0,
        z_prop=z0, logp_prop=jnp.asarray(-jnp.inf, dtype),
        grad_prop=grad0,
        log_weight=jnp.asarray(-jnp.inf, dtype),
        turning=jnp.asarray(False), diverging=jnp.asarray(False),
        sum_accept=jnp.zeros((), dtype),
        ckpt_z=ckpt_z, ckpt_r=ckpt_r, key=key,
        leaves_done=jnp.zeros((), jnp.int32),
    )
    out = jax.lax.fori_loop(0, num_steps, body, init)
    return out


def _nuts_transition(logprob_grad_fn, z, logp, grad, key, step_size,
                     inv_mass, max_depth):
    dtype = z.dtype
    k_mom, k_tree = jax.random.split(key)
    r0 = jax.random.normal(k_mom, z.shape, dtype) / jnp.sqrt(inv_mass)
    H0 = logp - kinetic_energy(r0, inv_mass)

    tree = _TreeState(
        z_left=z, r_left=r0, grad_left=grad,
        z_right=z, r_right=r0, grad_right=grad,
        z_proposal=z, logp_proposal=logp, grad_proposal=grad,
        log_weight=jnp.zeros((), dtype),  # initial leaf has weight exp(0)
        depth=jnp.zeros((), jnp.int32),
        turning=jnp.asarray(False), diverging=jnp.asarray(False),
        sum_accept_prob=jnp.zeros((), dtype),
        num_leaves=jnp.zeros((), dtype),
    )

    def cond(carry):
        tree, key = carry
        return jnp.logical_and(
            tree.depth < max_depth,
            jnp.logical_not(jnp.logical_or(tree.turning, tree.diverging)),
        )

    def body(carry):
        tree, key = carry
        key, k_dir, k_sub, k_accept = jax.random.split(key, 4)
        direction = jnp.where(
            jax.random.bernoulli(k_dir), 1.0, -1.0
        ).astype(dtype)

        z0 = jnp.where(direction > 0, tree.z_right, tree.z_left)
        r0 = jnp.where(direction > 0, tree.r_right, tree.r_left)
        g0 = jnp.where(direction > 0, tree.grad_right, tree.grad_left)

        sub = _build_subtree(
            logprob_grad_fn, z0, r0, g0, tree.depth, direction,
            step_size, inv_mass, H0, k_sub, max_depth,
        )

        # update the trajectory endpoints
        z_left = jnp.where(direction > 0, tree.z_left, sub.z)
        r_left = jnp.where(direction > 0, tree.r_left, sub.r)
        g_left = jnp.where(direction > 0, tree.grad_left, sub.grad)
        z_right = jnp.where(direction > 0, sub.z, tree.z_right)
        r_right = jnp.where(direction > 0, sub.r, tree.r_right)
        g_right = jnp.where(direction > 0, sub.grad, tree.grad_right)

        # biased progressive sampling across the doubling
        log_weight_new = jnp.logaddexp(tree.log_weight, sub.log_weight)
        p_new = jnp.exp(jnp.minimum(0.0, sub.log_weight - tree.log_weight))
        invalid = jnp.logical_or(sub.turning, sub.diverging)
        take_new = jnp.logical_and(
            jax.random.uniform(k_accept, (), dtype) < p_new,
            jnp.logical_not(invalid),
        )
        z_prop = jnp.where(take_new, sub.z_prop, tree.z_proposal)
        logp_prop = jnp.where(take_new, sub.logp_prop, tree.logp_proposal)
        grad_prop = jnp.where(take_new, sub.grad_prop, tree.grad_proposal)

        # U-turn across the full (merged) trajectory
        turning_total = jnp.logical_or(
            sub.turning,
            _is_turning(z_left, r_left, z_right, r_right, inv_mass),
        )

        new_tree = _TreeState(
            z_left=z_left, r_left=r_left, grad_left=g_left,
            z_right=z_right, r_right=r_right, grad_right=g_right,
            z_proposal=z_prop, logp_proposal=logp_prop,
            grad_proposal=grad_prop,
            log_weight=jnp.where(invalid, tree.log_weight, log_weight_new),
            depth=tree.depth + 1,
            turning=turning_total,
            diverging=jnp.logical_or(tree.diverging, sub.diverging),
            sum_accept_prob=tree.sum_accept_prob + sub.sum_accept,
            num_leaves=tree.num_leaves + sub.leaves_done.astype(dtype),
        )
        return (new_tree, key)

    tree, _ = jax.lax.while_loop(cond, body, (tree, k_tree))
    accept_prob = tree.sum_accept_prob / jnp.maximum(tree.num_leaves, 1.0)
    return (
        tree.z_proposal, tree.logp_proposal, tree.grad_proposal,
        accept_prob, tree.diverging, tree.depth,
    )


def _maybe_pmean(x, adapt_axis):
    if adapt_axis is not None:
        return jax.lax.pmean(x, adapt_axis)
    return x


def _make_warmup_step(logprob_grad_fn, max_depth, target_accept,
                      adapt_mass, adapt_axis):
    def warmup_step(carry, k):
        z, lp, grad, da, w, inv_mass = carry
        eps = jnp.exp(da.log_step)
        z, lp, grad, accept_prob, diverging, _ = _nuts_transition(
            logprob_grad_fn, z, lp, grad, k, eps, inv_mass, max_depth
        )
        da = da_update(da, _maybe_pmean(accept_prob, adapt_axis),
                       target=target_accept)
        if adapt_mass:
            w = welford_update(w, z)
        return (z, lp, grad, da, w, inv_mass), None

    return warmup_step


def nuts_warmup_init(x0, step_size: float = 0.1):
    """Initial (da, welford, inv_mass) adaptation state for windowed
    warmup (``nuts_warmup_window``). Per chain — vmap over chains."""
    x0 = jnp.asarray(x0)
    return (
        da_init(jnp.asarray(step_size, x0.dtype)),
        welford_init(x0.shape[0], x0.dtype),
        jnp.ones((x0.shape[0],), x0.dtype),
    )


def nuts_warmup_window(
    logprob_fn: Callable,
    z,
    keys,
    da,
    welford,
    inv_mass,
    *,
    max_depth: int = 10,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    adapt_axis: str | None = None,
):
    """Advance NUTS warmup by ``len(keys)`` steps as its own (short,
    jittable) program, resuming from and returning the full adaptation
    state ``(z, da, welford, inv_mass)``.

    Use it to keep each device program short (e.g. to report progress or
    checkpoint between windows of a long warmup). Drive the Stan windows (``warmup_schedule``) phase by phase — and
    chunk within a phase at will, since the Welford state rides along —
    then close each slow window with ``nuts_slow_window_close`` and
    finish with ``eps = exp(da.log_step_avg)``. Identical math to the
    in-``nuts`` warmup loop (same ``_make_warmup_step``); the phase
    driver just lives on the host.
    """
    logprob_grad_fn = jax.value_and_grad(logprob_fn)
    lp0, g0 = logprob_grad_fn(z)
    step = _make_warmup_step(
        logprob_grad_fn, max_depth, target_accept, adapt_mass, adapt_axis
    )
    (z, _, _, da, welford, inv_mass), _ = jax.lax.scan(
        step, (z, lp0, g0, da, welford, inv_mass), keys
    )
    return z, da, welford, inv_mass


def nuts_slow_window_close(da, welford, adapt_axis: str | None = None):
    """End a Stan slow window: re-estimate the diagonal inverse mass from
    the window's Welford moments (pmean-shared across ``adapt_axis`` when
    set) and restart dual averaging from the averaged step size."""
    inv_mass = _maybe_pmean(welford_variance(welford), adapt_axis)
    da = da_init(jnp.exp(da.log_step_avg))
    return da, inv_mass


def nuts(
    logprob_fn: Callable,
    x0,
    key,
    num_samples: int,
    num_warmup: int = 500,
    step_size: float = 0.1,
    max_depth: int = 10,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    adapt_axis: str | None = None,
    inv_mass=None,
):
    """Run one NUTS chain (vmap/shard_map over chains for many).

    ``adapt_axis``: a mapped axis name; when set, warmup adaptation
    statistics (accept prob, Welford moments) are averaged across the axis
    with ``lax.pmean`` — the BASELINE "shared step-size adaptation" knob.

    ``inv_mass``: optional (dim,) diagonal inverse-mass (posterior
    variance scale) to start from — with ``num_warmup=0`` this resumes
    sampling from a checkpointed ``(x0, step_size, inv_mass)`` state, or
    runs window-chunked sampling (each window a short device program).

    Returns ``(samples, info)`` with info = dict(logp, accept_prob,
    diverging, step_size, inv_mass, depth).
    """
    x0 = jnp.asarray(x0)
    dtype = x0.dtype
    dim = x0.shape[0]

    logprob_grad_fn = jax.value_and_grad(logprob_fn)
    lp0, g0 = logprob_grad_fn(x0)

    def maybe_pmean(x):
        if adapt_axis is not None:
            return jax.lax.pmean(x, adapt_axis)
        return x

    # ---- warmup: dual averaging + Welford mass ---------------------------
    da0 = da_init(jnp.asarray(step_size, dtype))
    w0 = welford_init(dim, dtype)
    inv_mass0 = (jnp.ones((dim,), dtype) if inv_mass is None
                 else jnp.asarray(inv_mass, dtype))

    warmup_step = _make_warmup_step(
        logprob_grad_fn, max_depth, target_accept, adapt_mass, adapt_axis
    )

    keys_w = jax.random.split(key, num_warmup + 1)
    key = keys_w[0]
    if num_warmup > 0:
        # Stan-style windowed warmup (see ``warmup_schedule``): fast
        # step-size-only buffers bracket doubling slow windows; each slow
        # window re-estimates the diagonal mass from fresh Welford moments
        # (optimal inv_mass ≈ posterior variance, Stan convention) and
        # restarts dual averaging against the new metric. This replaces
        # the earlier fixed half/half split, whose single mass estimate
        # left chains unconverged at short warmups (R̂ ≫ 1.01).
        z, lp, grad = x0, lp0, g0
        da, inv_mass = da0, inv_mass0
        offset = 1
        for phase, span in warmup_schedule(num_warmup):
            if span <= 0:
                continue
            w = welford_init(dim, dtype)
            (z, lp, grad, da, w, inv_mass), _ = jax.lax.scan(
                warmup_step, (z, lp, grad, da, w, inv_mass),
                keys_w[offset : offset + span],
            )
            offset += span
            if phase == "slow" and adapt_mass:
                inv_mass = maybe_pmean(welford_variance(w))
                da = da_init(jnp.exp(da.log_step_avg))
        eps_final = jnp.exp(da.log_step_avg)
    else:
        z, lp, grad = x0, lp0, g0
        inv_mass = inv_mass0
        eps_final = jnp.asarray(step_size, dtype)

    # ---- sampling ---------------------------------------------------------
    def sample_step(carry, k):
        z, lp, grad = carry
        z, lp, grad, accept_prob, diverging, depth = _nuts_transition(
            logprob_grad_fn, z, lp, grad, k, eps_final, inv_mass, max_depth
        )
        return (z, lp, grad), (z, lp, accept_prob, diverging, depth)

    keys = jax.random.split(key, num_samples)
    _, (samples, logps, accept_probs, divergings, depths) = jax.lax.scan(
        sample_step, (z, lp, grad), keys
    )
    info = {
        "logp": logps,
        "accept_prob": accept_probs,
        "diverging": divergings,
        "step_size": eps_final,
        "inv_mass": inv_mass,
        "depth": depths,
    }
    return samples, info
