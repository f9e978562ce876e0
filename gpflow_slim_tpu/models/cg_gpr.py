"""GPRCG: exact-GP regression with iterative (CG/SLQ) inference.

The GPyTorch BBMM recipe (PAPERS.md: Gardner et al. 2018; preconditioning
2021): the marginal likelihood and its gradients never factorize K —

  forward:  α = A⁻¹y by preconditioned CG;  logdet A by SLQ;
            mll = −½ yᵀα − ½ logdet A − N/2 log 2π
  backward: dmll/dθ = ½ αᵀ(dA/dθ)α − ½·(1/P)Σᵢ uᵢᵀ(dA/dθ)zᵢ
            with probe solves uᵢ = A⁻¹zᵢ reused from the forward pass —
            implemented as a ``custom_vjp`` whose backward differentiates
            only quadratic forms (stop-gradded solves), exactly the BBMM
            trick. O(N²·iters) instead of O(N³), every flop a GEMM.

The logdet (and hence the loss value) is stochastic; probe keys are
derived from the hyperparameter bits (``ops.iterative.probe_keys``) so the
probes redraw at every optimizer step — estimator error averages out over
the trajectory instead of freezing into a fixed bias. Predictions use CG
solves against the training system.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import config
from ..likelihoods import Gaussian
from ..ops.iterative import batched_cg, pivoted_cholesky, probe_keys, \
    slq_logdet, woodbury_solve_fn
from .model import GPModel


# Gram products at full f32 precision: in TF32 (a GPU's default) CG and
# the Hutchinson trace amplify the product error, and at N=16,384 the
# hyperparameter gradient moved by ~1e-2 between two matvec orderings.
_HP = jax.lax.Precision.HIGHEST


def _kmv(K, v):
    return jnp.matmul(K, v, precision=_HP)


def _make_A_matvec(K, noise):
    return lambda v: _kmv(K, v) + noise * v


_STREAM_BLOCK = 4096


def _pad_rows(M, block):
    rem = (-M.shape[0]) % block
    if rem == 0:
        return M
    return jnp.concatenate(
        [M, jnp.zeros((rem, M.shape[1]), M.dtype)], axis=0
    )


def _make_streaming_matvec(kern, X, noise, block=_STREAM_BLOCK):
    """A·v without ever materializing K: the Gram is regenerated one
    ``block``×N row-panel at a time inside a scan (flash-style). O(N·block)
    peak memory; the O(N²·D) Gram flops per matvec are noise next to the
    elementwise kernel map, which XLA fuses into the panel's producer."""
    N = X.shape[0]
    # small-N guard: padding up to the full 4096 stream block would make
    # every matvec compute a (4096, N) panel — up to ~27× wasted flops at
    # N a few hundred. Cap the block at N rounded up to the 128-lane tile.
    block = min(block, -(-N // 128) * 128)
    Xp = _pad_rows(X, block)
    nb = Xp.shape[0] // block
    Xb = Xp.reshape(nb, block, X.shape[1])

    def mv(v):
        def body(carry, xb):
            return carry, _kmv(kern.K(xb, X, presliced=False), v)

        _, panels = jax.lax.scan(body, None, Xb)  # (nb, block[, B])
        out = panels.reshape((nb * block,) + v.shape[1:])[:N]
        return out + noise * v

    return mv


@partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8))
def _cg_mll(kern, noise, X, err, num_probes, cg_iters, slq_steps,
            precond_rank, materialize):
    mll, _ = _cg_mll_fwd(kern, noise, X, err, num_probes, cg_iters,
                         slq_steps, precond_rank, materialize)
    return mll


def _cg_mll_fwd(kern, noise, X, err, num_probes, cg_iters, slq_steps,
                precond_rank, materialize):
    N = X.shape[0]
    num_out = err.shape[1]
    if materialize:
        K = kern.K(X)
        mv = _make_A_matvec(K, noise)
    else:
        mv = _make_streaming_matvec(kern, X, noise)

    if precond_rank > 0:
        if not materialize:
            raise NotImplementedError(
                "pivoted-Cholesky preconditioning requires materialize_k; "
                "streaming mode runs plain CG (precond_rank=0)"
            )
        Lpre = pivoted_cholesky(K, precond_rank)
        pre = woodbury_solve_fn(Lpre, noise)
    else:
        pre = None

    alpha, _ = batched_cg(mv, err, max_iters=cg_iters, precond=pre)

    # probes redrawn whenever the hyperparameters move (ops.iterative.
    # probe_keys): per-step fresh randomness in a training loop, identical
    # probes within one value/grad evaluation
    key_logdet, key_trace = probe_keys(kern, noise)
    logdet = slq_logdet(mv, N, key_logdet, num_probes=num_probes,
                        num_steps=slq_steps, dtype=err.dtype)

    # probe solves for the backward trace estimator
    Z = jax.random.rademacher(
        key_trace, (N, num_probes), dtype=err.dtype
    )
    U, _ = batched_cg(mv, Z, max_iters=cg_iters, precond=pre)

    quad = jnp.sum(err * alpha)
    mll = (
        -0.5 * quad
        - 0.5 * num_out * logdet
        - 0.5 * N * num_out * jnp.log(2.0 * jnp.pi)
    )
    res = (kern, noise, X, err, alpha, Z, U)
    return mll, res


def _cg_mll_bwd(num_probes, cg_iters, slq_steps, precond_rank, materialize,
                res, g):
    kern, noise, X, err, alpha, Z, U = res
    num_out = err.shape[1]
    alpha = jax.lax.stop_gradient(alpha)
    Z = jax.lax.stop_gradient(Z)
    U = jax.lax.stop_gradient(U)

    def surrogate(kern, noise, X, err):
        if materialize:
            K = kern.K(X)
            # ½ αᵀ A α  (gradient wrt θ equals ½ αᵀ dA α; the
            # err-dependence of the quad term enters through −yᵀα below)
            Aalpha = _kmv(K, alpha) + noise * alpha
            t_quad = 0.5 * jnp.sum(alpha * Aalpha)
            # −½ tr(A⁻¹ dA): Hutchinson with the stored solves
            AZ = _kmv(K, Z) + noise * Z
            t_trace = -0.5 * num_out * jnp.sum(U * AZ) / num_probes
        else:
            # streaming: the same quadratic forms, one Gram row-panel at a
            # time; jax.checkpoint makes the scan's backward regenerate
            # each panel instead of storing it — O(N·block) memory in both
            # directions (padded rows carry zero coefficients, so they
            # contribute nothing to either term)
            block = _STREAM_BLOCK
            Xp = _pad_rows(X, block)
            nb = Xp.shape[0] // block
            Xb = Xp.reshape(nb, block, X.shape[1])
            Ab = _pad_rows(alpha, block).reshape(nb, block, -1)
            Ub = _pad_rows(U, block).reshape(nb, block, -1)

            @jax.checkpoint
            def panel_terms(xb, ab, ub):
                Kb = kern.K(xb, X, presliced=False)  # (block, N)
                t_q = 0.5 * jnp.sum(ab * _kmv(Kb, alpha))
                t_t = (-0.5 * num_out / num_probes
                       * jnp.sum(ub * _kmv(Kb, Z)))
                return t_q + t_t

            def body(carry, inp):
                xb, ab, ub = inp
                return carry + panel_terms(xb, ab, ub), None

            tot, _ = jax.lax.scan(
                body, jnp.zeros((), X.dtype), (Xb, Ab, Ub)
            )
            t_quad = tot + 0.5 * noise * jnp.sum(jnp.square(alpha))
            t_trace = (-0.5 * num_out / num_probes
                       * noise * jnp.sum(U * Z))
            t_quad, t_trace = t_quad + t_trace, 0.0
        # −yᵀ α  (direct err dependence of −½ yᵀ A⁻¹ y = −½ errᵀα;
        # d/d err of (−½ errᵀ A⁻¹ err) = −A⁻¹ err = −α)
        t_err = -jnp.sum(err * alpha)
        return t_quad + t_trace + t_err

    grads = jax.grad(surrogate, argnums=(0, 1, 2, 3))(kern, noise, X, err)
    return tuple(jax.tree_util.tree_map(lambda a: a * g, grads))


_cg_mll.defvjp(_cg_mll_fwd, _cg_mll_bwd)


class GPRCG(GPModel):
    """Exact GPR with CG/SLQ inference (matrix-free marginal likelihood).

    Same API as GPR; ``build_likelihood`` is a stochastic estimate of the
    log marginal likelihood with unbiased gradients. ``num_probes``,
    ``cg_iters``, ``slq_steps``, ``precond_rank`` trade accuracy/compute.
    """

    def __init__(self, X, Y, kern, mean_function=None, num_probes=16,
                 cg_iters=100, slq_steps=25, precond_rank=0,
                 materialize_k=True, name="gprcg"):
        likelihood = Gaussian(name=f"{name}/likelihood")
        super().__init__(X, Y, kern, likelihood, mean_function, name=name)
        self.num_probes = int(num_probes)
        self.cg_iters = int(cg_iters)
        self.slq_steps = int(slq_steps)
        self.precond_rank = int(precond_rank)
        # materialize_k=False streams Gram row-panels through every matvec
        # (forward AND backward) — O(N·block) memory, so N is bounded by
        # HBM for X/vectors, not for K. Requires precond_rank=0.
        self.materialize_k = bool(materialize_k)

    def build_likelihood(self):
        noise = jnp.squeeze(self.likelihood.variance.value)
        err = self.Y - self.mean_function(self.X)
        return _cg_mll(
            self.kern, noise, self.X, err,
            self.num_probes, self.cg_iters, self.slq_steps,
            self.precond_rank, self.materialize_k,
        )

    def build_predict(self, Xnew, full_cov=False):
        if full_cov:
            raise NotImplementedError(
                "GPRCG predicts marginal variances only (use GPR for "
                "full covariances)"
            )
        noise = jnp.squeeze(self.likelihood.variance.value)
        if self.materialize_k:
            K = self.kern.K(self.X)
            mv = _make_A_matvec(K, noise)
        else:
            mv = _make_streaming_matvec(self.kern, self.X, noise)
        err = self.Y - self.mean_function(self.X)
        alpha, _ = batched_cg(mv, err, max_iters=self.cg_iters)
        Kx = self.kern.K(self.X, Xnew)  # (N, N*)
        fmean = Kx.T @ alpha + self.mean_function(Xnew)
        # marginal variances: v_i = k** − kₓᵢᵀ A⁻¹ kₓᵢ via CG on the columns
        W, _ = batched_cg(mv, Kx, max_iters=self.cg_iters)
        fvar = self.kern.Kdiag(Xnew) - jnp.sum(Kx * W, axis=0)
        fvar = jnp.tile(fvar[:, None], (1, self.num_latent))
        return fmean, fvar
