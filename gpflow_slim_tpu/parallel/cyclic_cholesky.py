"""Column-block-cyclic distributed Cholesky with explicit collectives.

The ScaLAPACK-style 1-D block-cyclic right-looking algorithm, written
directly in shard_map (SURVEY §7.2 hard-part #2): block-column j lives on
device j mod P; at step k the owner factors its panel (diagonal block
Cholesky + full-height TRSM-as-GEMM), the panel is **broadcast with one
masked psum over the mesh axis**, and every device applies the SYRK
trailing update to the block columns it owns — so the O(N³) update flops are evenly spread and
each step moves only one N×bs panel over the interconnect (O(N²) total
communication, the 1-D-optimal volume; the slab-SPMD path in
``dist_linalg`` leaves the same schedule to XLA's partitioner).

Layout: the matrix enters/leaves as an ordinary (N, N) array; the
block-cyclic permutation is applied host-side around the shard_map call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

_HP = jax.lax.Precision.HIGHEST  # trailing updates are cancellation-critical

__all__ = ["cyclic_cholesky"]


def _cyclic_order(nb, p):
    """Global block indices in device-major cyclic order."""
    return np.concatenate([np.arange(d, nb, p) for d in range(p)])


def cyclic_cholesky(K, mesh: Mesh, axis: str, block_size: int = 128,
                    lookahead: bool = True):
    """Lower Cholesky of SPD K over a 1-D mesh axis, explicit collectives.

    Requires N divisible by block_size and (N/block_size) divisible by the
    mesh axis size. Returns the full (N, N) lower factor (row-replicated
    output; callers shard further as needed).

    ``lookahead=True`` (default) runs the classic panel-lookahead
    schedule: iteration k first updates ONLY the next panel's column with
    panel k, factors+broadcasts panel k+1, and THEN applies panel k's
    bulk trailing update — so the latency-bound panel psum of step k+1 is
    issued before (and can overlap with) the step-k SYRK GEMMs under
    XLA's async collective scheduler. Same arithmetic, reordered; this is
    the in-schedule analog of pipeline parallelism (docs/SHARDING.md).
    """
    N = K.shape[0]
    bs = block_size
    p = mesh.shape[axis]
    if N % bs != 0:
        raise ValueError(f"N={N} not divisible by block_size={bs}")
    nb = N // bs
    if nb % p != 0:
        raise ValueError(f"nb={nb} not divisible by mesh axis {p}")
    nb_loc = nb // p

    order = _cyclic_order(nb, p)
    inv_order = np.argsort(order)

    # (N, N) -> (nb, N, bs) block columns in cyclic order, shard over axis
    cols = jnp.transpose(
        jnp.reshape(K, (N, nb, bs)), (1, 0, 2)
    )[jnp.asarray(order)]

    rows_idx = jnp.arange(N)[:, None]  # (N, 1)
    i32 = lambda v: jnp.asarray(v, jnp.int32)

    def local(Bl):  # Bl: (nb_loc, N, bs) — this device's block columns
        me = jax.lax.axis_index(axis)
        jg = me + jnp.arange(nb_loc, dtype=me.dtype) * p  # global blk idx

        def factor_panel(Bl, k):
            """Owner factors panel k (others on a safe dummy), masked-psum
            broadcast; owner stores the factored panel. Returns
            (Bl, panel_bc)."""
            owner = k % p
            lidx = k // p
            panel = jax.lax.dynamic_index_in_dim(
                Bl, lidx, axis=0, keepdims=False
            )  # (N, bs)
            diag = jax.lax.dynamic_slice(
                panel, (i32(k * bs), i32(0)), (bs, bs)
            )
            is_owner = me == owner
            safe = jnp.eye(bs, dtype=K.dtype)
            diag = jnp.where(is_owner, diag, safe)
            Ld = jnp.tril(
                jax.lax.linalg.cholesky(diag, symmetrize_input=False))
            below = rows_idx >= (k + 1) * bs
            # (N, bs) sub-diagonal part: W Ldᵀ = panel
            W = jax.lax.linalg.triangular_solve(
                Ld, jnp.where(below, panel, 0.0), left_side=False,
                lower=True, transpose_a=True)
            Ld_full = jax.lax.dynamic_update_slice(
                jnp.zeros((N, bs), K.dtype), Ld, (i32(k * bs), i32(0))
            )
            panel_L = W + Ld_full  # rows above k·bs are zero

            # --- panel broadcast: one masked psum over the mesh axis ----
            panel_bc = jax.lax.psum(
                jnp.where(is_owner, panel_L, 0.0), axis
            )
            Bl = jnp.where(
                is_owner,
                jax.lax.dynamic_update_index_in_dim(Bl, panel_L, lidx, 0),
                Bl,
            )
            return Bl, panel_bc

        def upd_col(Bl, Wb, m, k, only_j=None):
            """Apply panel-k's SYRK update to local column m (global j):
            skipped unless j > k (and j == only_j when given)."""
            j = jg[m]
            Pj = jax.lax.dynamic_slice(
                Wb, (i32(j * bs), i32(0)), (bs, bs)
            )  # rows of the panel aligned with column block j
            delta = jnp.matmul(Wb, Pj.T, precision=_HP)  # (N, bs)
            cur = jax.lax.dynamic_index_in_dim(Bl, m, 0, keepdims=False)
            cond = j > k if only_j is None else (j == only_j)
            new = jnp.where(cond, cur - delta, cur)
            return jax.lax.dynamic_update_index_in_dim(Bl, new, m, 0)

        if not lookahead:
            def step(k, Bl):
                Bl, panel_bc = factor_panel(Bl, k)
                below = rows_idx >= (k + 1) * bs
                Wb = jnp.where(below, panel_bc, 0.0)  # (N, bs)
                return jax.lax.fori_loop(
                    0, nb_loc, lambda m, B: upd_col(B, Wb, m, k), Bl)

            return jax.lax.fori_loop(0, nb, step, Bl)

        # ---- lookahead schedule -------------------------------------
        Bl, pbc = factor_panel(Bl, 0)

        def step(k, carry):
            Bl, pbc = carry  # pbc = broadcast factored panel of step k
            below = rows_idx >= (k + 1) * bs
            Wb = jnp.where(below, pbc, 0.0)
            # (a) next panel's column first: column k+1 lives at local
            #     slot (k+1)//p on its owner; on other devices that slot
            #     holds a different global column, which only_j masks, so
            #     this is one (wasted) GEMM on non-owners — 1/nb_loc of
            #     the update work
            Bl = upd_col(Bl, Wb, (k + 1) // p, k, only_j=k + 1)
            # (b) factor + broadcast panel k+1 — issued BEFORE the bulk
            #     update so the psum overlaps the GEMMs below
            Bl, pbc_next = factor_panel(Bl, k + 1)
            # (c) bulk trailing update with panel k on the remaining
            #     owned columns (j > k+1; column k+1 was done in (a))
            Bl = jax.lax.fori_loop(
                0, nb_loc,
                lambda m, B: upd_col(B, Wb, m, k + 1), Bl)
            return Bl, pbc_next

        Bl, _ = jax.lax.fori_loop(0, nb - 1, step, (Bl, pbc))
        return Bl

    out_cols = shard_map(
        local, mesh=mesh, in_specs=P(axis, None, None),
        out_specs=P(axis, None, None), check_vma=False,
    )(cols)

    # back to (N, N), undo the cyclic permutation, mask to lower triangle
    L = jnp.reshape(
        jnp.transpose(out_cols[jnp.asarray(inv_order)], (1, 0, 2)), (N, N)
    )
    return jnp.tril(L)
