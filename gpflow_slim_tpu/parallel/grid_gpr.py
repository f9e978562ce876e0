"""End-to-end 2-D (rows × cols) block-cyclic distributed exact GPR.

Completes the TP-analog pipeline of SURVEY §2.2 (the reference is
single-device — ref:gpflowSlim delegates one ``tf.cholesky`` to TF's C++
runtime; BASELINE config #5 mandates the multi-chip path): the N×N Gram is
**built sharded** over a 2-D device grid, factored in place, and consumed
by sharded solves — no step of the loss, value or gradient, ever
materializes an unsharded (N, N) array. Per-device memory is
O(N²/(Pr·Pc)) end-to-end.

Layout (shared with ``grid_cholesky``): block (i, j) of the ORIGINAL
matrix lives on device (i mod Pr, j mod Pc) at local slot (i//Pr, j//Pc).
The logical jax-level value is the block-cyclically permuted matrix ``Kp``
sharded ``P(rows, cols)`` — but nothing here ever constructs it on a host:
``grid_gram`` computes each device's tile directly from (replicated,
N×D-small) X.

Pieces:

  * ``grid_gram``            — sharded block-cyclic Gram from X (+ diag).
  * ``grid_cholesky_tiles``  — in-layout factorization (the sharded-output
                               completion of ``grid_cholesky``).
  * ``grid_solve_lower_thin`` / ``grid_solve_upper_thin`` — replicated
                               (N, P) right-hand sides, O(N·(P+bs)) comm.
  * ``grid_solve_lower_wide``— 2-D distributed TRSM with a block-cyclic
                               (N, M) RHS (right-looking, local GEMMs).
  * ``grid_nll``             — custom-VJP scalar −log marginal likelihood;
                               backward builds K⁻¹ tiles via wide TRSM +
                               a SUMMA-style WᵀW, all in layout.
  * ``make_grid_gpr_loss``   — differentiable loss_fn(model) for training.

Gradient math (the custom VJP): with β = K⁻¹ err,
∂mll/∂K = ½(ββᵀ − num_out·K⁻¹) — evaluated tile-locally, so the chain
rule into kernel hyperparameters runs through the (elementwise, local)
sharded Gram construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "GridLayout",
    "grid_gram",
    "grid_cholesky_tiles",
    "grid_solve_lower_thin",
    "grid_solve_upper_thin",
    "grid_solve_lower_wide",
    "grid_logdet",
    "grid_nll",
    "make_grid_gpr_loss",
]

# every matmul here runs at full f32 precision: the factorization's updates
# are cancellation-critical, and a one-hot selection matmul in TF32 rounds
# what it selects to 10 bits
_HP = jax.lax.Precision.HIGHEST


class GridLayout:
    """Static description of a 2-D block-cyclic layout over a mesh."""

    def __init__(self, N: int, mesh: Mesh, axes=("rows", "cols"),
                 block_size: int = 128):
        self.N = N
        self.mesh = mesh
        self.r_ax, self.c_ax = axes
        self.Pr = mesh.shape[self.r_ax]
        self.Pc = mesh.shape[self.c_ax]
        self.bs = block_size
        if N % block_size:
            raise ValueError(f"N={N} not divisible by block_size={block_size}")
        self.nb = N // block_size
        if self.nb % self.Pr or self.nb % self.Pc:
            raise ValueError(
                f"nb={self.nb} must divide by mesh axes ({self.Pr},{self.Pc})"
            )
        self.R_loc = self.nb // self.Pr
        self.C_loc = self.nb // self.Pc

    # ---- device-local index helpers (used INSIDE shard_map bodies) ----

    def local_row_idx(self):
        """Original element-row indices of my local rows, given axis_index."""
        r = jax.lax.axis_index(self.r_ax)
        blocks = r + self.Pr * jnp.arange(self.R_loc)
        return (blocks[:, None] * self.bs
                + jnp.arange(self.bs)[None, :]).reshape(-1)

    def local_col_idx(self):
        c = jax.lax.axis_index(self.c_ax)
        blocks = c + self.Pc * jnp.arange(self.C_loc)
        return (blocks[:, None] * self.bs
                + jnp.arange(self.bs)[None, :]).reshape(-1)

    # ---- host-side permutations (only for import/export convenience) ----

    def row_perm(self):
        order = np.concatenate(
            [np.arange(d, self.nb, self.Pr) for d in range(self.Pr)]
        )
        return (order[:, None] * self.bs + np.arange(self.bs)[None, :]).ravel()

    def col_perm(self):
        order = np.concatenate(
            [np.arange(d, self.nb, self.Pc) for d in range(self.Pc)]
        )
        return (order[:, None] * self.bs + np.arange(self.bs)[None, :]).ravel()

    def tile_spec(self):
        return P(self.r_ax, self.c_ax)

    def tile_sharding(self):
        return NamedSharding(self.mesh, self.tile_spec())


def grid_gram(kern, X, layout: GridLayout, diag_add=0.0):
    """Block-cyclic sharded Gram: device (r, c) computes K(X_rows, X_cols)
    for ITS blocks directly from (replicated) X — the full Gram never
    exists unsharded anywhere, host or device. ``diag_add`` (e.g. the noise
    variance) is added on true-diagonal entries. Differentiable in the
    kernel parameters and ``diag_add``."""
    lo = layout

    def local(kern, X, diag_add):
        row_idx = lo.local_row_idx()
        col_idx = lo.local_col_idx()
        Xr = jnp.take(X, row_idx, axis=0)
        Xc = jnp.take(X, col_idx, axis=0)
        tile = kern.K(Xr, Xc)
        eye_mask = (row_idx[:, None] == col_idx[None, :]).astype(tile.dtype)
        return tile + diag_add * eye_mask

    return shard_map(
        local, mesh=lo.mesh, in_specs=(P(), P(), P()),
        out_specs=lo.tile_spec(), check_vma=False,
    )(kern, X, jnp.asarray(diag_add, X.dtype))


def _factor_local(lo: GridLayout):
    """shard_map body: in-place right-looking block Cholesky on my tile.

    Identical schedule to ``grid_cholesky`` (see that module's docstring
    for the per-step communication analysis); this version masks the local
    upper triangle so the OUTPUT stays a valid sharded lower factor."""
    r_ax, c_ax = lo.r_ax, lo.c_ax
    Pr, Pc, bs, nb = lo.Pr, lo.Pc, lo.bs, lo.nb
    R_loc, C_loc = lo.R_loc, lo.C_loc

    def local(Ka):
        r = jax.lax.axis_index(r_ax)
        c = jax.lax.axis_index(c_ax)
        my_rows = r + Pr * jnp.arange(R_loc)
        row_ids = jnp.repeat(my_rows, bs)
        eye = jnp.eye(bs, dtype=Ka.dtype)

        def step(k, Ka):
            kc_owner = jnp.equal(c, jnp.mod(k, Pc))
            jc = k // Pc

            col_slice = jax.lax.dynamic_slice(
                Ka, (0, jc * bs), (R_loc * bs, bs)
            )
            colblk = jax.lax.psum(
                jnp.where(kc_owner, col_slice, 0.0), c_ax
            )

            is_diag_row = jnp.equal(row_ids, k)[:, None]
            pos_in_block = jnp.mod(jnp.arange(R_loc * bs), bs)
            onehot = (
                is_diag_row
                * (pos_in_block[:, None] == jnp.arange(bs)[None, :])
            ).astype(Ka.dtype)
            diag = jax.lax.psum(
                jnp.matmul(onehot.T, colblk, precision=_HP), r_ax)

            Lkk = jnp.linalg.cholesky(diag)
            Zinv = jax.scipy.linalg.solve_triangular(Lkk, eye, lower=True)

            below = (row_ids > k)[:, None]
            trsm = jnp.matmul(colblk, Zinv.T, precision=_HP)
            Lkk_rows = jnp.matmul(onehot, Lkk, precision=_HP)
            newcol = jnp.where(below, trsm,
                               jnp.where(is_diag_row, Lkk_rows, colblk))
            Ka = jnp.where(
                kc_owner,
                jax.lax.dynamic_update_slice(Ka, newcol, (0, jc * bs)),
                Ka,
            )

            # Comm-optimal panel exchange (ScaLAPACK-style row-scoped
            # broadcast): the trailing update on my (i, j) tiles needs
            # L_ik (local in ``Lmask``) and L_jk for j ∈ my COLUMN blocks
            # only — C_loc blocks, not the whole panel. A masked psum
            # along the row axis delivers exactly those:
            # O(N·bs/Pc)/step/device vs the previous full-panel
            # all_gather's O(N·bs) — O(N²/Pc) total, the N²/√P schedule.
            Lmask = jnp.where(below, newcol, 0.0)
            my_cols = c + Pc * jnp.arange(C_loc)
            src = jnp.mod(my_cols, Pr)       # owner row-rank of block j
            slot = my_cols // Pr             # its local row-block slot
            panel_blocks = Lmask.reshape(R_loc, bs, bs)
            mine = jnp.equal(src, r)
            cand = jnp.take(panel_blocks, jnp.where(mine, slot, 0), axis=0)
            Lc = jax.lax.psum(
                jnp.where(mine[:, None, None], cand, 0.0), r_ax
            )                                # (C_loc, bs, bs)
            Lc_flat = Lc.reshape(C_loc * bs, bs)
            return Ka - jnp.matmul(Lmask, Lc_flat.T, precision=_HP)

        Ka = jax.lax.fori_loop(0, nb, step, Ka)
        # local tril: zero entries whose ORIGINAL (row, col) is above the
        # diagonal, so the sharded output is a clean lower factor
        row_idx = lo.local_row_idx()
        col_idx = lo.local_col_idx()
        keep = (row_idx[:, None] >= col_idx[None, :]).astype(Ka.dtype)
        return Ka * keep

    return local


def grid_cholesky_tiles(Kp, layout: GridLayout):
    """Factor a block-cyclic sharded SPD matrix IN LAYOUT: the output is
    the sharded lower factor (same block-cyclic tiles) — per-device memory
    stays O(N²/(Pr·Pc)); nothing is gathered."""
    lo = layout
    return shard_map(
        _factor_local(lo), mesh=lo.mesh, in_specs=lo.tile_spec(),
        out_specs=lo.tile_spec(), check_vma=False,
    )(Kp)


def grid_logdet(Lp, layout: GridLayout):
    """Σ log diag(L) over the sharded factor (scalar, replicated)."""
    lo = layout

    def local(Ll):
        row_idx = lo.local_row_idx()
        col_idx = lo.local_col_idx()
        mask = row_idx[:, None] == col_idx[None, :]
        s = jnp.sum(jnp.where(mask, jnp.log(jnp.where(mask, Ll, 1.0)), 0.0))
        return jax.lax.psum(jax.lax.psum(s, lo.r_ax), lo.c_ax)

    return shard_map(
        local, mesh=lo.mesh, in_specs=lo.tile_spec(), out_specs=P(),
        check_vma=False,
    )(Lp)


def _diag_block(lo, Ll, k, r, c):
    """Replicate the (bs, bs) diagonal block L_kk from its owner."""
    bs = lo.bs
    slab = jax.lax.dynamic_slice(
        Ll, ((k // lo.Pr) * bs, (k // lo.Pc) * bs), (bs, bs)
    )
    own = jnp.logical_and(jnp.equal(r, jnp.mod(k, lo.Pr)),
                          jnp.equal(c, jnp.mod(k, lo.Pc)))
    return jax.lax.psum(
        jax.lax.psum(jnp.where(own, slab, 0.0), lo.r_ax), lo.c_ax
    )


def grid_solve_lower_thin(Lp, rhs, layout: GridLayout):
    """Solve L α = rhs with a replicated thin (N, P) RHS.

    Block forward substitution in original row order; per step one
    (bs, P) psum + one (bs, bs) psum — O(N·(P+bs)) total communication.
    Returns α replicated (N, P)."""
    lo = layout
    bs, nb = lo.bs, lo.nb

    def local(Ll, rhs):
        r = jax.lax.axis_index(lo.r_ax)
        c = jax.lax.axis_index(lo.c_ax)
        col_idx = lo.local_col_idx()

        def step(k, alpha):
            # owners of block row k: r == k mod Pr, local row slot k//Pr
            rowslab = jax.lax.dynamic_slice(
                Ll, ((k // lo.Pr) * bs, 0), (bs, lo.C_loc * bs)
            )
            gathered = jnp.take(alpha, col_idx, axis=0)
            done = (col_idx < k * bs).astype(alpha.dtype)[:, None]
            part = jnp.matmul(rowslab, gathered * done, precision=_HP)
            own_r = jnp.equal(r, jnp.mod(k, lo.Pr))
            s = jax.lax.psum(
                jax.lax.psum(jnp.where(own_r, part, 0.0), lo.r_ax), lo.c_ax
            )
            Lkk = _diag_block(lo, Ll, k, r, c)
            cur = jax.lax.dynamic_slice(alpha, (k * bs, 0),
                                        (bs, alpha.shape[1]))
            new = jax.scipy.linalg.solve_triangular(Lkk, cur - s, lower=True)
            return jax.lax.dynamic_update_slice(alpha, new, (k * bs, 0))

        return jax.lax.fori_loop(0, nb, step, rhs)

    return shard_map(
        local, mesh=lo.mesh, in_specs=(lo.tile_spec(), P()), out_specs=P(),
        check_vma=False,
    )(Lp, rhs)


def grid_solve_upper_thin(Lp, rhs, layout: GridLayout):
    """Solve Lᵀ β = rhs (replicated thin RHS) against the sharded LOWER
    factor — block backward substitution, same comm budget as the lower
    solve. Returns β replicated."""
    lo = layout
    bs, nb = lo.bs, lo.nb

    def local(Ll, rhs):
        r = jax.lax.axis_index(lo.r_ax)
        c = jax.lax.axis_index(lo.c_ax)
        row_idx = lo.local_row_idx()

        def step(t, beta):
            k = nb - 1 - t
            # owners of block col k: c == k mod Pc, local col slot k//Pc
            colslab = jax.lax.dynamic_slice(
                Ll, (0, (k // lo.Pc) * bs), (lo.R_loc * bs, bs)
            )
            gathered = jnp.take(beta, row_idx, axis=0)
            done = (row_idx >= (k + 1) * bs).astype(beta.dtype)[:, None]
            part = jnp.matmul(colslab.T, gathered * done, precision=_HP)
            own_c = jnp.equal(c, jnp.mod(k, lo.Pc))
            s = jax.lax.psum(
                jax.lax.psum(jnp.where(own_c, part, 0.0), lo.c_ax), lo.r_ax
            )
            Lkk = _diag_block(lo, Ll, k, r, c)
            cur = jax.lax.dynamic_slice(beta, (k * bs, 0),
                                        (bs, beta.shape[1]))
            new = jax.scipy.linalg.solve_triangular(
                Lkk.T, cur - s, lower=False
            )
            return jax.lax.dynamic_update_slice(beta, new, (k * bs, 0))

        return jax.lax.fori_loop(0, nb, step, rhs)

    return shard_map(
        local, mesh=lo.mesh, in_specs=(lo.tile_spec(), P()), out_specs=P(),
        check_vma=False,
    )(Lp, rhs)


def grid_solve_lower_wide(Lp, Bp, layout: GridLayout):
    """2-D distributed TRSM: solve L W = B where BOTH operands are
    block-cyclic sharded (N, N). Right-looking: per step k the L panel is
    psum-replicated down mesh columns, B's block row k down mesh rows, and
    the trailing update is one local GEMM — O(N³/(Pr·Pc)) flops/device."""
    lo = layout
    bs, nb = lo.bs, lo.nb

    def local(Ll, Bl):
        r = jax.lax.axis_index(lo.r_ax)
        c = jax.lax.axis_index(lo.c_ax)
        row_idx = lo.local_row_idx()
        eye = jnp.eye(bs, dtype=Ll.dtype)

        def step(k, Bl):
            # my r-shard of L block column k
            colsl = jax.lax.dynamic_slice(
                Ll, (0, (k // lo.Pc) * bs), (lo.R_loc * bs, bs)
            )
            own_c = jnp.equal(c, jnp.mod(k, lo.Pc))
            colblk = jax.lax.psum(jnp.where(own_c, colsl, 0.0), lo.c_ax)
            # L_kk and its inverse (TRSM → GEMM)
            dslab = jax.lax.dynamic_slice(colblk, ((k // lo.Pr) * bs, 0),
                                          (bs, bs))
            own_r = jnp.equal(r, jnp.mod(k, lo.Pr))
            Lkk = jax.lax.psum(jnp.where(own_r, dslab, 0.0), lo.r_ax)
            Zinv = jax.scipy.linalg.solve_triangular(Lkk, eye, lower=True)
            # B block row k for my columns (already fully updated)
            rowsl = jax.lax.dynamic_slice(
                Bl, ((k // lo.Pr) * bs, 0), (bs, lo.C_loc * bs)
            )
            rowB = jax.lax.psum(jnp.where(own_r, rowsl, 0.0), lo.r_ax)
            Wk = jnp.matmul(Zinv, rowB, precision=_HP)
            Bl = jnp.where(
                own_r,
                jax.lax.dynamic_update_slice(Bl, Wk, ((k // lo.Pr) * bs, 0)),
                Bl,
            )
            # trailing update on rows strictly below block k
            belowmask = (row_idx >= (k + 1) * bs).astype(Bl.dtype)[:, None]
            return Bl - jnp.matmul(colblk * belowmask, Wk, precision=_HP)

        return jax.lax.fori_loop(0, nb, step, Bl)

    return shard_map(
        local, mesh=lo.mesh, in_specs=(lo.tile_spec(), lo.tile_spec()),
        out_specs=lo.tile_spec(), check_vma=False,
    )(Lp, Bp)


def _grid_identity(layout: GridLayout, dtype):
    """The identity matrix in block-cyclic layout, built sharded."""
    lo = layout

    def local():
        row_idx = lo.local_row_idx()
        col_idx = lo.local_col_idx()
        return (row_idx[:, None] == col_idx[None, :]).astype(dtype)

    return shard_map(
        local, mesh=lo.mesh, in_specs=(), out_specs=lo.tile_spec(),
        check_vma=False,
    )()


def _grid_ata(Wp, layout: GridLayout):
    """SUMMA-style C = WᵀW over block-cyclic tiles: per step k, W's block
    row k is replicated down mesh rows then all-gathered along mesh
    columns ((bs, N) panel per device), and each device does one local
    GEMM into its C tile."""
    lo = layout
    bs, nb = lo.bs, lo.nb

    def local(Wl):
        r = jax.lax.axis_index(lo.r_ax)
        c = jax.lax.axis_index(lo.c_ax)
        # my C tile (i, j) needs W_ki for i ∈ my ROW blocks only — fetch
        # those R_loc blocks by masked psum along the col axis
        # (O(N·bs/Pr)/step/device) instead of all-gathering the whole
        # (bs, N) panel; see the matching note in ``_factor_local``.
        row_blocks = r + lo.Pr * jnp.arange(lo.R_loc)
        src = jnp.mod(row_blocks, lo.Pc)   # owner col-rank of block i
        slot = row_blocks // lo.Pc         # its local col-block slot
        mine = jnp.equal(src, c)

        def step(k, C):
            rowsl = jax.lax.dynamic_slice(
                Wl, ((k // lo.Pr) * bs, 0), (bs, lo.C_loc * bs)
            )
            own_r = jnp.equal(r, jnp.mod(k, lo.Pr))
            rowW = jax.lax.psum(jnp.where(own_r, rowsl, 0.0), lo.r_ax)
            rw_blocks = rowW.reshape(bs, lo.C_loc, bs).transpose(1, 0, 2)
            cand = jnp.take(rw_blocks, jnp.where(mine, slot, 0), axis=0)
            Wi_b = jax.lax.psum(
                jnp.where(mine[:, None, None], cand, 0.0), lo.c_ax
            )                              # (R_loc, bs, bs)
            Wi = Wi_b.transpose(1, 0, 2).reshape(bs, lo.R_loc * bs)
            return C + jnp.matmul(Wi.T, rowW, precision=_HP)

        C0 = jnp.zeros_like(Wl)
        return jax.lax.fori_loop(0, nb, step, C0)

    return shard_map(
        local, mesh=lo.mesh, in_specs=lo.tile_spec(),
        out_specs=lo.tile_spec(), check_vma=False,
    )(Wp)


def _outer_tiles(beta, layout: GridLayout, dtype):
    """ββᵀ (summed over output columns) as block-cyclic tiles — β is the
    small replicated (N, P) solve result, so each tile is a local GEMM."""
    lo = layout

    def local(beta):
        row_idx = lo.local_row_idx()
        col_idx = lo.local_col_idx()
        br = jnp.take(beta, row_idx, axis=0)
        bc = jnp.take(beta, col_idx, axis=0)
        return jnp.matmul(br, bc.T, precision=_HP).astype(dtype)

    return shard_map(
        local, mesh=lo.mesh, in_specs=P(), out_specs=lo.tile_spec(),
        check_vma=False,
    )(beta)


def _grid_nll_impl(Kp, err, layout: GridLayout):
    lo = layout
    N = lo.N
    num_out = err.shape[1]
    Lp = grid_cholesky_tiles(Kp, lo)
    alpha = grid_solve_lower_thin(Lp, err, lo)
    logdet = grid_logdet(Lp, lo)
    nll = (
        0.5 * N * num_out * jnp.log(2.0 * jnp.pi)
        + num_out * logdet
        + 0.5 * jnp.sum(jnp.square(alpha))
    )
    return nll, (Lp, alpha)


def make_grid_nll(layout: GridLayout):
    """Build the custom-VJP scalar NLL for this layout.

    forward:  Kp (sharded tiles), err (replicated N×P) → scalar
    backward: K̄p = ḡ·½(num_out·K⁻¹ − ββᵀ) in tiles (K⁻¹ via the wide 2-D
              TRSM + SUMMA — O(N³/(Pr·Pc)) flops/device, never gathered),
              err̄ = ḡ·β.
    """
    lo = layout

    @jax.custom_vjp
    def grid_nll(Kp, err):
        nll, _ = _grid_nll_impl(Kp, err, lo)
        return nll

    def fwd(Kp, err):
        nll, (Lp, alpha) = _grid_nll_impl(Kp, err, lo)
        return nll, (Lp, alpha, err.shape[1])

    def bwd(res, g):
        Lp, alpha, num_out = res
        beta = grid_solve_upper_thin(Lp, alpha, lo)
        Ip = _grid_identity(lo, Lp.dtype)
        Wp = grid_solve_lower_wide(Lp, Ip, lo)  # W = L⁻¹, tiles
        Kinv = _grid_ata(Wp, lo)                # K⁻¹ = WᵀW, tiles
        outer = _outer_tiles(beta, lo, Lp.dtype)
        Kbar = (0.5 * g) * (num_out * Kinv - outer)
        errbar = g * beta
        return Kbar, errbar

    grid_nll.defvjp(fwd, bwd)
    return grid_nll


def grid_nll(Kp, err, layout: GridLayout):
    """−log marginal likelihood of MVN(err; 0, Kp) from sharded tiles.
    Differentiable w.r.t. the tiles (custom VJP) and err."""
    return make_grid_nll(layout)(Kp, err)


def make_grid_gpr_loss(model, mesh: Mesh, axes=("rows", "cols"),
                       block_size: int = 128):
    """Differentiable ``loss_fn(m) -> -(mll + log_prior)`` for exact GPR
    over a 2-D mesh: sharded Gram → in-layout grid Cholesky → sharded
    solves → scalar. The only replicated arrays are X (N×D), the thin
    solves (N×P) and the hyperparameters; everything N×N lives in
    O(N²/(Pr·Pc)) tiles, forward AND backward.

    ``model.X``/``model.Y`` are captured at construction (see
    ``make_distributed_cg_loss`` for the same convention); the model
    argument contributes hyperparameters only.
    """
    X = jnp.asarray(model.X)
    Y = jnp.asarray(model.Y)
    layout = GridLayout(X.shape[0], mesh, axes=axes, block_size=block_size)
    nll_fn = make_grid_nll(layout)

    def loss_fn(m):
        if m.X.shape != X.shape or m.Y.shape != Y.shape:
            raise ValueError(
                "make_grid_gpr_loss captured data of shape "
                f"X{tuple(X.shape)}/Y{tuple(Y.shape)}; got a model with "
                f"X{tuple(m.X.shape)}/Y{tuple(m.Y.shape)} — rebuild the "
                "loss for new data"
            )
        noise = jnp.squeeze(m.likelihood.variance.value)
        Kp = grid_gram(m.kern, X, layout, diag_add=noise)
        err = Y - m.mean_function(X)
        return nll_fn(Kp, err) - m.log_prior()

    loss_fn.layout = layout
    return loss_fn
