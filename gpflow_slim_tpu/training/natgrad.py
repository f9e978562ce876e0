"""Natural gradients for Gaussian variational parameters (SVGP).

Not in the reference; a north-star requirement. Implements Salimbeni,
Eleftheriadis & Hensman (2018) eq. 10: the natural-gradient direction in the
``ξ = (q_mu, q_sqrt)`` coordinates is

    ∇̃_ξ L = (∂ξ/∂θ)|_θ(ξ) · (∂L/∂η)|_η(ξ)

with θ the natural parameters ``(S⁻¹m, −½S⁻¹)`` and η the expectation
parameters ``(m, S + mmᵀ)``. ``∂L/∂η`` comes from reverse-mode through
``expectation → ξ``; the pushforward ``(∂ξ/∂θ)·v`` is one ``jax.jvp``
through ``natural → ξ`` — no explicit Fisher matrix ever formed, everything
batched over output dims as matrix products.

The canonical SVGP loop alternates ``natgrad(q_mu, q_sqrt)`` with Adam on
the hyperparameters (``fit_svgp_natgrad``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import jax
import jax.numpy as jnp
import optax

from ..params import Param, trainable_leaf_mask
from ..transforms import LowerTriangular, positive

__all__ = ["natgrad_step", "fit_svgp_natgrad"]


# -- parameterization maps (batched over P output dims) ---------------------
# ξ = (m (M,P), L (P,M,M) lower);  S = L Lᵀ
# η = (m, S + m mᵀ);  θ = (S⁻¹ m, −½ S⁻¹)

def _sym(A):
    return 0.5 * (A + jnp.swapaxes(A, -1, -2))


def _chol_batched(S):
    # no jitter: exactness of the conjugate one-step jump depends on these
    # roundtrips; non-PD intermediates are handled by γ-backtracking in
    # natgrad_step (a failed chol yields NaNs, which trigger the retry)
    return jax.vmap(jnp.linalg.cholesky)(_sym(S))


def _xi_to_expectation(m, L):
    S = L @ jnp.swapaxes(L, -1, -2)  # (P, M, M)
    mmT = jnp.einsum("mp,np->pmn", m, m)
    return m, S + mmT


def _expectation_to_xi(eta1, eta2):
    m = eta1
    mmT = jnp.einsum("mp,np->pmn", m, m)
    S = eta2 - mmT
    return m, _chol_batched(S)


def _xi_to_natural(m, L):
    # S⁻¹ via Cholesky; nat1 = S⁻¹ m, nat2 = −½ S⁻¹
    P, M, _ = L.shape
    eye = jnp.eye(M, dtype=L.dtype)
    Linv = jax.vmap(
        lambda Lp: jax.scipy.linalg.solve_triangular(Lp, eye, lower=True)
    )(L)
    Sinv = jnp.swapaxes(Linv, -1, -2) @ Linv
    nat1 = jnp.einsum("pmn,np->mp", Sinv, m)
    return nat1, -0.5 * Sinv


def _natural_to_xi(nat1, nat2):
    Sinv = -2.0 * _sym(nat2)
    P, M, _ = Sinv.shape
    eye = jnp.eye(M, dtype=Sinv.dtype)
    Lprec = _chol_batched(Sinv)  # chol of precision (jittered)
    # S = Sinv⁻¹ = Lprec⁻ᵀ Lprec⁻¹
    Linv = jax.vmap(
        lambda Lp: jax.scipy.linalg.solve_triangular(Lp, eye, lower=True)
    )(Lprec)
    S = jnp.swapaxes(Linv, -1, -2) @ Linv
    m = jnp.einsum("pmn,np->mp", S, nat1)
    return m, _chol_batched(S)


def _q_sqrt_array(model):
    """(P, M, M) lower-tri array from the model's q_sqrt (any form)."""
    if hasattr(model, "q_sqrt_array"):
        return model.q_sqrt_array()  # canonical impl on SVGP
    q = model.q_sqrt.value
    if q.ndim == 2:  # diag (M, P)
        return jax.vmap(jnp.diag)(q.T)
    return jnp.tril(q)


def _with_q(model, m_arr, L_arr):
    """Functional replacement of (q_mu, q_sqrt) on an SVGP pytree."""
    new = jax.tree_util.tree_map(lambda x: x, model)  # shallow copy
    M, P = m_arr.shape
    object.__setattr__(
        new, "q_mu", Param(m_arr, name="q_mu", dtype=m_arr.dtype)
    )
    if model.q_diag:
        diag = jnp.diagonal(L_arr, axis1=-2, axis2=-1).T  # (M, P)
        object.__setattr__(
            new, "q_sqrt",
            Param(diag, transform=positive(), name="q_sqrt",
                  dtype=diag.dtype),
        )
    else:
        object.__setattr__(
            new, "q_sqrt",
            Param(L_arr, transform=LowerTriangular(M, num_matrices=P),
                  name="q_sqrt", dtype=L_arr.dtype),
        )
    return new


def natgrad_step(model, loss_fn: Callable, gamma: float):
    """One natural-gradient update of (q_mu, q_sqrt); other params untouched.

    ``loss_fn(model) -> scalar`` (typically −ELBO on a batch). The update is
    taken in the natural-parameter coordinates (GPflow's default ``XiNat``):
    the natural gradient there is exactly ``∂L/∂η``, so

        θ ← θ − γ · ∂L/∂η,   then map θ back to (q_mu, q_sqrt).

    For the conjugate (Gaussian-likelihood) case ∂L/∂η = θ − θ*, hence one
    γ=1 step jumps exactly to the optimal q — the classic natgrad oracle.
    """
    m0 = model.q_mu.value
    L0 = _q_sqrt_array(model)

    # dL/dη by reverse mode through expectation → ξ → loss
    def loss_of_eta(etas):
        xi = _expectation_to_xi(*etas)
        return loss_fn(_with_q(model, *xi))

    etas = _xi_to_expectation(m0, L0)
    dL_deta = jax.grad(loss_of_eta)(etas)

    # θ-space step, mapped back to ξ = (q_mu, q_sqrt). With non-conjugate
    # likelihoods a large γ can push the precision −2·nat2 indefinite (the
    # classic natgrad blow-up); backtrack γ ← γ/2 until the new covariance
    # factorizes (all-finite Cholesky), up to 8 halvings.
    nat1, nat2 = _xi_to_natural(m0, L0)

    def attempt(g):
        m_new, L_new = _natural_to_xi(
            nat1 - g * dL_deta[0], nat2 - g * dL_deta[1]
        )
        ok = jnp.all(jnp.isfinite(m_new)) & jnp.all(jnp.isfinite(L_new))
        return m_new, L_new, ok

    def cond(state):
        g, _, _, ok, it = state
        return jnp.logical_and(jnp.logical_not(ok), it < 8)

    def body(state):
        g, _, _, _, it = state
        g = g * 0.5
        m_new, L_new, ok = attempt(g)
        return (g, m_new, L_new, ok, it + 1)

    m_new, L_new, ok = attempt(jnp.asarray(gamma, m0.dtype))
    g0 = jnp.asarray(gamma, m0.dtype)
    _, m_new, L_new, ok, _ = jax.lax.while_loop(
        cond, body, (g0, m_new, L_new, ok, jnp.asarray(0, jnp.int32))
    )
    # if even the smallest step failed, keep the current q
    m_new = jnp.where(ok, m_new, m0)
    L_new = jnp.where(ok, L_new, L0)

    return _with_q(model, m_new, L_new)


def fit_svgp_natgrad(
    model,
    num_steps: int,
    key,
    gamma: float = 0.1,
    learning_rate: float = 0.01,
    batch_size: int | None = None,
    optimizer=None,
):
    """Alternating natgrad(q) + Adam(hyperparameters) SVGP training.

    Whole loop jitted via lax.scan; per step: sample minibatch → natural-
    gradient step on (q_mu, q_sqrt) → Adam step on everything else.
    Returns (model, losses). Repeated calls with the same model structure
    reuse the compiled executable (runner cache keyed on treedef/masks).
    """
    N = model.num_data
    B = batch_size or N

    # mask: hypers only (exclude q_mu/q_sqrt from Adam)
    mask_trainable = trainable_leaf_mask(model)
    leaves0, treedef = jax.tree_util.tree_flatten(model)
    q_leaf_ids = set()
    outer = jax.tree_util.tree_leaves(
        model, is_leaf=lambda x: isinstance(x, Param)
    )
    for i, leaf in enumerate(outer):
        if leaf is model.q_mu or leaf is model.q_sqrt:
            q_leaf_ids.add(i)
    hyper_mask = tuple(
        (t and i not in q_leaf_ids) for i, t in enumerate(mask_trainable)
    )

    opt, run = _natgrad_runner(treedef, hyper_mask, num_steps, int(N),
                               int(B), float(gamma), float(learning_rate),
                               optimizer)
    opt_state = opt.init(leaves0)
    leaves, losses = run(leaves0, opt_state, key)
    return jax.tree_util.tree_unflatten(treedef, leaves), losses


@lru_cache(maxsize=32)
def _natgrad_runner(treedef, hyper_mask, num_steps, N, B, gamma,
                    learning_rate, optimizer):
    """Compiled-runner cache for ``fit_svgp_natgrad`` (same rationale as
    ``optimize._fit_runner``: a fresh jit closure per call would recompile
    the whole scan every fit)."""
    if optimizer is None:
        optimizer = optax.adam(learning_rate)
    # state only for the hyperparameter leaves (see optimize._fit_runner)
    optimizer = optax.masked(optimizer, list(hyper_mask))

    def batch_loss(mm, Xb, Yb):
        return -(mm.build_likelihood_batch(Xb, Yb) + mm.log_prior())

    def step(carry, k):
        leaves, opt_state = carry
        m = jax.tree_util.tree_unflatten(treedef, leaves)
        idx = jax.random.choice(k, N, shape=(B,), replace=False)
        Xb = jnp.take(m.X, idx, axis=0)
        Yb = jnp.take(m.Y, idx, axis=0)

        # 1) natural-gradient step on q
        m = natgrad_step(m, lambda mm: batch_loss(mm, Xb, Yb), gamma)

        # 2) Adam on hyperparameters
        loss, grads = jax.value_and_grad(
            lambda mm: batch_loss(mm, Xb, Yb)
        )(m)
        g_leaves = [
            g * t
            for g, t in zip(jax.tree_util.tree_leaves(grads), hyper_mask)
        ]
        new_leaves = jax.tree_util.tree_leaves(m)
        updates, new_opt_state = optimizer.update(
            g_leaves, opt_state, new_leaves
        )
        updates = [u * t for u, t in zip(updates, hyper_mask)]
        new_leaves = [l + u for l, u in zip(new_leaves, updates)]
        return (new_leaves, new_opt_state), loss

    @jax.jit
    def run(leaves, opt_state, key):
        keys = jax.random.split(key, num_steps)
        (leaves, opt_state), losses = jax.lax.scan(
            step, (leaves, opt_state), keys
        )
        return leaves, losses

    return optimizer, run
