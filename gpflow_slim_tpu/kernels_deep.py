"""Deep kernels: neural-network-warped inputs (SURVEY §3.5).

The reference's load-bearing property is that kernels accept arbitrary
tensors, so users build deep kernels by feeding ``tf.layers.dense(X, …)``
into ``kern.K`` (the NKN/fBNN pattern). That works here too — kernels are
pure functions on jnp arrays. ``DeepKernel`` packages the joint-training
case: the warp's parameters ride the model pytree, so one
``jax.grad(model.objective)`` trains GP hyperparameters and network weights
together (BASELINE config #5 "deep-kernel stretch").
"""

from __future__ import annotations

from typing import Any, Callable

import jax.numpy as jnp

from .kernels import Kernel

__all__ = ["DeepKernel", "mlp_warp"]


class DeepKernel(Kernel):
    """``K(x, x') = base.K(f(x), f(x'))`` with trainable warp params.

    ``warp_fn(params, X) -> H`` must be a pure function (e.g. a neural
    network library's ``apply`` or a hand-rolled MLP); ``warp_params`` is a pytree of
    arrays and becomes part of the model's trainable leaves.
    """

    def __init__(self, input_dim, base_kernel: Kernel, warp_fn: Callable,
                 warp_params: Any, active_dims=None, name="deep_kernel"):
        super().__init__(input_dim, active_dims, name=name)
        self.base_kernel = base_kernel
        self.warp_fn = warp_fn  # static (hash by identity)
        # wrap raw array leaves as (identity-transform) Params so they are
        # trainable — bare arrays on a Module are treated as frozen data
        import jax as _jax

        from .params import Param as _Param

        def wrap(leaf):
            if isinstance(leaf, _Param):
                return leaf
            return _Param(leaf, name=f"{name}/warp", dtype=jnp.asarray(leaf).dtype)

        self.warp_params = _jax.tree_util.tree_map(wrap, warp_params)

    def _warp(self, X):
        import jax as _jax

        from .params import Param as _Param

        raw = _jax.tree_util.tree_map(
            lambda p: p.value if isinstance(p, _Param) else p,
            self.warp_params,
            is_leaf=lambda x: isinstance(x, _Param),
        )
        return self.warp_fn(raw, X)

    def K(self, X, X2=None, presliced=False):
        if not presliced:
            X, X2 = self._slice(X, X2)
        H = self._warp(X)
        H2 = None if X2 is None else self._warp(X2)
        return self.base_kernel.K(H, H2, presliced=True)

    def Kdiag(self, X, presliced=False):
        if not presliced:
            X, _ = self._slice(X, None)
        return self.base_kernel.Kdiag(self._warp(X), presliced=True)


def mlp_warp(key, sizes, activation=jnp.tanh):
    """Hand-rolled MLP warp: returns ``(warp_fn, params)``.

    ``sizes = [d_in, h1, …, d_out]``; final layer is linear. Self-contained
    (no neural-network library needed), but any pure ``apply`` works.
    """
    import jax

    from . import config

    dtype = config.default_float()
    params = []
    keys = jax.random.split(key, len(sizes) - 1)
    for k, (din, dout) in zip(keys, zip(sizes[:-1], sizes[1:])):
        W = jax.random.normal(k, (din, dout), dtype) / jnp.sqrt(din)
        b = jnp.zeros((dout,), dtype)
        params.append({"W": W, "b": b})

    def warp_fn(params, X):
        H = X
        for i, layer in enumerate(params):
            H = H @ layer["W"] + layer["b"]
            if i < len(params) - 1:
                H = activation(H)
        return H

    return warp_fn, params
