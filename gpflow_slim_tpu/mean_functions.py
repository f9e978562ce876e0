"""Mean functions (ref:gpflowSlim/mean_functions.py).

``MeanFunction`` instances are Modules; ``__call__(X)`` is a pure function of
the pytree. ``+`` and ``*`` build ``Additive``/``Product`` combinations,
matching the reference's operator algebra.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .params import Module, Param

__all__ = [
    "MeanFunction",
    "Zero",
    "Constant",
    "Identity",
    "Linear",
    "Additive",
    "Product",
    "SwitchedMeanFunction",
]


class MeanFunction(Module):
    def __call__(self, X):
        raise NotImplementedError

    def __add__(self, other):
        return Additive(self, other)

    def __mul__(self, other):
        return Product(self, other)


class Zero(MeanFunction):
    def __init__(self, output_dim=1):
        self.output_dim = int(output_dim)

    def __call__(self, X):
        return jnp.zeros((X.shape[0], self.output_dim), dtype=X.dtype)


class Constant(MeanFunction):
    def __init__(self, c=None, name="constant_mean"):
        c = np.zeros(1) if c is None else np.atleast_1d(np.asarray(c, dtype=np.float64))
        self.c = Param(c, name=f"{name}/c")

    def __call__(self, X):
        c = jnp.reshape(self.c.value, (1, -1))
        return jnp.tile(c, (X.shape[0], 1)).astype(X.dtype)


class Identity(MeanFunction):
    def __call__(self, X):
        return X


class Linear(MeanFunction):
    """``m(x) = A x + b``; A: (D, P), b: (P,)."""

    def __init__(self, A=None, b=None, name="linear_mean"):
        A = np.ones((1, 1)) if A is None else np.atleast_2d(np.asarray(A, dtype=np.float64))
        b = np.zeros(1) if b is None else np.atleast_1d(np.asarray(b, dtype=np.float64))
        self.A = Param(A, name=f"{name}/A")
        self.b = Param(b, name=f"{name}/b")

    def __call__(self, X):
        return X @ self.A.value + self.b.value


class Additive(MeanFunction):
    def __init__(self, first, second):
        self.add_1 = first
        self.add_2 = second

    def __call__(self, X):
        return self.add_1(X) + self.add_2(X)


class Product(MeanFunction):
    def __init__(self, first, second):
        self.prod_1 = first
        self.prod_2 = second

    def __call__(self, X):
        return self.prod_1(X) * self.prod_2(X)


class SwitchedMeanFunction(MeanFunction):
    """Per-group mean functions selected by X's LAST column (the group
    index), the companion of ``likelihoods.SwitchedLikelihood``: row n gets
    ``meanfunctions[int(X[n, -1])](X[n, :-1])``.

    Instead of the reference's dynamic_partition/stitch, every
    branch mean is evaluated on the full sliced batch and combined with a
    one-hot mask — static shapes, vmap/grad-safe.
    """

    def __init__(self, meanfunction_list):
        for m in meanfunction_list:
            if not isinstance(m, MeanFunction):
                raise TypeError("expected MeanFunction instances")
        self.meanfunctions = list(meanfunction_list)

    def __call__(self, X):
        idx = X[:, -1].astype(jnp.int32)  # (N,)
        Xd = X[:, :-1]
        outs = [m(Xd) for m in self.meanfunctions]  # each (N, P)
        stacked = jnp.stack(outs, axis=0)  # (G, N, P)
        onehot = jax.nn.one_hot(idx, len(self.meanfunctions),
                                dtype=X.dtype)  # (N, G)
        return jnp.einsum("gnp,ng->np", stacked, onehot)
