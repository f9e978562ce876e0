"""Ring/blockwise Gram construction (SURVEY §5 "long-context" analog).

The GP analog of sequence-length scaling is N: each device holds an X row
shard; to build its block-row of K it ``ppermute``-rotates the opposing
shard around the ring — structurally identical to ring attention's KV
rotation. The full N×N Gram is only ever materialized **sharded** (each
device holds N/P rows); ``ring_gram_matvec`` never materializes K at all
(flash-style streaming accumulation) for matrix-free solvers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["ring_gram", "ring_gram_matvec"]


def _ring_perm(n_dev):
    # send my shard to my left neighbor => after s steps I hold shard (me+s)%n
    return [(i, (i - 1) % n_dev) for i in range(n_dev)]


def ring_gram(kern, X, mesh: Mesh, axis: str = "rows"):
    """K(X, X) with rows sharded over ``axis``; X (N, D) divisible by mesh.

    Returns the Gram with rows sharded over ``axis`` (never fully
    replicated). Diagonal jitter/noise is the caller's business.
    """
    n_dev = mesh.shape[axis]
    N = X.shape[0]
    if N % n_dev != 0:
        raise ValueError(f"N={N} not divisible by ring size {n_dev}")
    n_loc = N // n_dev
    perm = _ring_perm(n_dev)

    def local(kern, Xl):
        me = jax.lax.axis_index(axis)

        def body(s, carry):
            Kl, Xrot = carry
            src = (me + s) % n_dev  # which shard Xrot currently is
            block = kern.K(Xl, Xrot)  # (n_loc, n_loc)
            col = jnp.asarray(src * n_loc, jnp.int32)
            Kl = jax.lax.dynamic_update_slice(
                Kl, block, (jnp.zeros((), jnp.int32), col)
            )
            Xrot = jax.lax.ppermute(Xrot, axis, perm)
            return (Kl, Xrot)

        Kl0 = jnp.zeros((n_loc, N), dtype=Xl.dtype)
        Kl, _ = jax.lax.fori_loop(0, n_dev, body, (Kl0, Xl))
        return Kl

    return shard_map(
        local, mesh=mesh, in_specs=(P(), P(axis)), out_specs=P(axis),
        check_vma=False,
    )(kern, X)


def ring_gram_matvec(kern, X, v, mesh: Mesh, axis: str = "rows",
                     noise: float | jnp.ndarray = 0.0):
    """(K(X,X) + noise·I) @ v without materializing K (O(N²/P) flops/device,
    O(N·D/P) memory/device). v: (N,) or (N, P_cols), row-sharded like X.
    """
    n_dev = mesh.shape[axis]
    N = X.shape[0]
    if N % n_dev != 0:
        raise ValueError(f"N={N} not divisible by ring size {n_dev}")
    perm = _ring_perm(n_dev)
    v2d = v if v.ndim == 2 else v[:, None]

    def local(kern, Xl, vl):
        def body(s, carry):
            acc, Xrot, vrot = carry
            block = kern.K(Xl, Xrot)  # (n_loc, n_loc)
            # full f32 precision: see models/cg_gpr.py's _HP
            acc = acc + jnp.matmul(block, vrot,
                                   precision=jax.lax.Precision.HIGHEST)
            Xrot = jax.lax.ppermute(Xrot, axis, perm)
            vrot = jax.lax.ppermute(vrot, axis, perm)
            return (acc, Xrot, vrot)

        acc0 = jnp.zeros_like(vl)
        acc, _, _ = jax.lax.fori_loop(0, n_dev, body, (acc0, Xl, vl))
        return acc + noise * vl

    out = shard_map(
        local, mesh=mesh, in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis), check_vma=False,
    )(kern, X, v2d)
    return out if v.ndim == 2 else out[:, 0]
