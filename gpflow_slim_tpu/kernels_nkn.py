"""Neural Kernel Networks (Sun et al., ICML 2018 — the paper the reference
library exists to serve; SURVEY §2.1 "NKN helpers").

An NKN is a small network whose units are kernel *values*: positive-weighted
linear combinations and products of primitive kernels are again PSD kernels,
so a stack of ``NKNLinear`` (nonnegative weights) and ``NKNProduct`` layers
parameterizes a rich, trainably-structured kernel. Everything is batched
over the primitive axis ((m, N, M) tensors, one einsum) and trains
end-to-end through ``model.objective()`` like any other kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .kernels import Kernel
from .params import Module, Param
from .transforms import positive

__all__ = ["NKNLinear", "NKNProduct", "NKN"]


class NKNLinear(Module):
    """k_out[o] = Σ_i W[o,i] k_in[i] (+ b[o]); W, b ≥ 0 keeps PSD."""

    def __init__(self, input_dim, output_dim, weights=None, use_bias=False,
                 name="nkn_linear"):
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        if weights is None:
            rngw = np.random.RandomState(0)
            weights = rngw.uniform(0.2, 1.0, (output_dim, input_dim)) / input_dim
        self.weights = Param(np.asarray(weights), transform=positive(),
                             name=f"{name}/weights")
        self.use_bias = bool(use_bias)
        if use_bias:
            self.bias = Param(np.full((output_dim,), 0.01),
                              transform=positive(), name=f"{name}/bias")

    def __call__(self, Ks):
        # Ks: (in, ...) -> (out, ...)
        W = self.weights.value
        out = jnp.tensordot(W, Ks, axes=([1], [0]))
        if self.use_bias:
            b = self.bias.value
            out = out + b.reshape((-1,) + (1,) * (out.ndim - 1))
        return out


class NKNProduct(Module):
    """Elementwise product of consecutive groups of ``step`` kernels."""

    def __init__(self, input_dim, step=2, name="nkn_product"):
        if input_dim % step != 0:
            raise ValueError("input_dim must be divisible by step")
        self.input_dim = int(input_dim)
        self.step = int(step)
        self.name = name

    def __call__(self, Ks):
        shape = (self.input_dim // self.step, self.step) + Ks.shape[1:]
        return jnp.prod(jnp.reshape(Ks, shape), axis=1)


class NKN(Kernel):
    """Neural kernel network over primitive kernels.

    ``primitives``: list of Kernels (each slices its own active_dims);
    ``layers``: list of NKNLinear/NKNProduct, ending with output size 1.
    """

    def __init__(self, input_dim, primitives, layers, name="nkn"):
        super().__init__(input_dim, active_dims=slice(None), name=name)
        self.primitives = list(primitives)
        self.layers = list(layers)

    def _slice(self, X, X2):  # primitives do their own slicing
        return X, X2

    def _apply(self, Ks):
        for layer in self.layers:
            Ks = layer(Ks)
        if Ks.shape[0] != 1:
            raise ValueError("NKN must end with a single output kernel")
        return Ks[0]

    def K(self, X, X2=None, presliced=False):
        Ks = jnp.stack([k.K(X, X2) for k in self.primitives])  # (m, N, M)
        return self._apply(Ks)

    def Kdiag(self, X, presliced=False):
        Ks = jnp.stack([k.Kdiag(X) for k in self.primitives])  # (m, N)
        return self._apply(Ks)
