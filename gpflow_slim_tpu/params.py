"""Parameter DSL: pytree-native replacement for the reference Param machinery.

The reference (ref:gpflowSlim/params.py — the defining "slim" rewrite of
GPflow 1.x) makes ``Param`` create a raw unconstrained ``tf.get_variable``
under the caller's name scope and exposes ``constrained_tensor`` /
``prior_logp``; models are plain Python objects that build their TF graph in
``__init__``. The load-bearing property (SURVEY §3.5) is *composability with
the host framework*: kernels/models must be usable inside arbitrary user
code with no module-system ceremony.

Pytree redesign: a ``Param`` is a pytree node whose single dynamic leaf
is the **unconstrained** array; transform/prior/trainable/name are static
metadata. A ``Module`` is any object whose subclass is auto-registered as a
pytree: its array-like fields (Params, sub-Modules, jax/numpy arrays, and
containers of those) are dynamic children, everything else is static aux
data. Consequences, all deliberate:

  * ``jax.grad(lambda m: m.objective())(model)`` works directly — the model
    IS the parameter pytree, gradients come back model-shaped.
  * ``vmap`` / ``shard_map`` / ``jit`` compose with zero magic: modules are
    ordinary pytrees, methods are pure functions of ``self``.
  * MCMC over hyperparameters = flows on the unconstrained leaves; the
    transform log-Jacobian is accounted in ``prior_logp`` exactly as the
    reference does (jacobian added only when a prior is set, matching
    GPflow-1.x ``build_prior``).

Modules are treated as immutable after ``__init__`` (functional updates via
``jax.tree_util`` / ``equinox``-style ``tree_at`` helper below).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import config
from .transforms import Identity, Transform

__all__ = [
    "Param",
    "Module",
    "parameters",
    "log_prior",
    "trainable_leaf_mask",
    "tree_at",
    "pack_trainable",
    "unpack_trainable",
]


class Param:
    """A constrained trainable parameter.

    Mirrors the reference semantics (ref:gpflowSlim/params.py):
      * construction takes the **constrained** value; the stored leaf is
        ``transform.backward(value)`` (unconstrained);
      * ``.value`` is the constrained tensor ``transform.forward(u)``;
      * ``.prior_logp()`` = ``prior.logp(constrained) + log_jacobian(u)`` if a
        prior is set, else 0 — the jacobian term makes MCMC on unconstrained
        coordinates correct.
    """

    __slots__ = ("unconstrained", "transform", "prior", "trainable", "name")

    def __init__(
        self,
        value,
        transform: Transform | None = None,
        prior=None,
        trainable: bool = True,
        name: str = "param",
        dtype=None,
    ):
        transform = transform if transform is not None else Identity()
        self.transform = transform
        self.prior = prior
        self.trainable = bool(trainable)
        self.name = name
        if dtype is None:
            dtype = config.default_float()
        value = jnp.asarray(value, dtype=dtype)
        self.unconstrained = jnp.asarray(transform.backward(value), dtype=dtype)

    # -- constrained views -------------------------------------------------
    @property
    def value(self):
        """Constrained tensor (reference ``constrained_tensor``)."""
        return self.transform.forward(self.unconstrained)

    @property
    def shape(self):
        return jnp.shape(self.value)

    @property
    def dtype(self):
        return self.unconstrained.dtype

    def __jax_array__(self):
        return self.value

    def prior_logp(self):
        if self.prior is None:
            return jnp.zeros((), dtype=self.unconstrained.dtype)
        lp = jnp.sum(self.prior.logp(self.value))
        return lp + self.transform.log_jacobian(self.unconstrained)

    # -- pytree plumbing ---------------------------------------------------
    def _replace_unconstrained(self, u) -> "Param":
        new = object.__new__(Param)
        new.unconstrained = u
        new.transform = self.transform
        new.prior = self.prior
        new.trainable = self.trainable
        new.name = self.name
        return new

    def __repr__(self):
        return (
            f"Param(name={self.name!r}, transform={type(self.transform).__name__},"
            f" trainable={self.trainable}, unconstrained={self.unconstrained!r})"
        )


def _param_flatten_with_keys(p: Param):
    return ((jax.tree_util.GetAttrKey("unconstrained"), p.unconstrained),), (
        p.transform,
        p.prior,
        p.trainable,
        p.name,
    )


def _param_unflatten(aux, children) -> Param:
    new = object.__new__(Param)
    (new.unconstrained,) = children
    new.transform, new.prior, new.trainable, new.name = aux
    return new


jax.tree_util.register_pytree_with_keys(
    Param, _param_flatten_with_keys, _param_unflatten
)


# ---------------------------------------------------------------------------
# Module: auto-registered pytree base class
# ---------------------------------------------------------------------------

_DYNAMIC_TYPES = (Param, jax.Array, np.ndarray)


def _is_dynamic(v: Any) -> bool:
    if isinstance(v, (Param, Module)) or isinstance(v, _DYNAMIC_TYPES):
        return True
    if isinstance(v, (list, tuple)):
        return any(_is_dynamic(e) for e in v)
    if isinstance(v, dict):
        return any(_is_dynamic(e) for e in v.values())
    return False


def _hashable(v: Any):
    """Sanitize a static field value into something hashable."""
    if isinstance(v, list):
        return ("__list__",) + tuple(_hashable(e) for e in v)
    if isinstance(v, tuple):
        return tuple(_hashable(e) for e in v)
    if isinstance(v, dict):
        return ("__dict__",) + tuple(
            (k, _hashable(x)) for k, x in sorted(v.items())
        )
    if isinstance(v, np.generic):
        return v.item()
    return v


def _unhashable(v: Any):
    if isinstance(v, tuple):
        if len(v) >= 1 and v[0] == "__list__":
            return [_unhashable(e) for e in v[1:]]
        if len(v) >= 1 and v[0] == "__dict__":
            return {k: _unhashable(x) for k, x in v[1:]}
        return tuple(_unhashable(e) for e in v)
    return v


class Module:
    """Base class whose subclasses are automatically pytree-registered.

    Fields holding Params, Modules, arrays, or containers thereof become
    dynamic pytree children (sorted by field name for determinism); all other
    fields are static aux data and participate in jit cache keys.
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        jax.tree_util.register_pytree_with_keys(
            cls,
            _module_flatten_with_keys,
            _make_module_unflatten(cls),
        )

    # Convenience: every module can report its Params and prior logp.
    def parameters(self):
        return parameters(self)

    def log_prior(self):
        return log_prior(self)

    def __repr__(self):
        fields = ", ".join(f"{k}={type(v).__name__}" for k, v in sorted(vars(self).items()))
        return f"{type(self).__name__}({fields})"


def _module_flatten_with_keys(m: Module):
    d = vars(m)
    dyn_keys = []
    static_items = []
    for k in sorted(d):
        v = d[k]
        if _is_dynamic(v):
            dyn_keys.append(k)
        else:
            static_items.append((k, _hashable(v)))
    children = tuple(
        (jax.tree_util.GetAttrKey(k), d[k]) for k in dyn_keys
    )
    aux = (tuple(dyn_keys), tuple(static_items))
    return children, aux


def _make_module_unflatten(cls):
    def unflatten(aux, children) -> Module:
        dyn_keys, static_items = aux
        obj = object.__new__(cls)
        for k, v in zip(dyn_keys, children):
            object.__setattr__(obj, k, v)
        for k, v in static_items:
            object.__setattr__(obj, k, _unhashable(v))
        return obj

    return unflatten


# ---------------------------------------------------------------------------
# Tree utilities over Params
# ---------------------------------------------------------------------------

def _is_param(x) -> bool:
    return isinstance(x, Param)


def parameters(tree) -> list[tuple[str, Param]]:
    """All Params in a pytree with dotted path names."""
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=_is_param)
    out = []
    for path, leaf in leaves:
        if isinstance(leaf, Param):
            out.append((jax.tree_util.keystr(path).lstrip("."), leaf))
    return out


def log_prior(tree):
    """Sum of prior log-probs (+ transform Jacobians) over all Params."""
    ps = [p for _, p in parameters(tree)]
    if not ps:
        return jnp.zeros((), dtype=config.default_float())
    total = ps[0].prior_logp()
    for p in ps[1:]:
        total = total + p.prior_logp()
    return total


def trainable_leaf_mask(tree) -> list[bool]:
    """Boolean per-leaf mask aligned with ``jax.tree_util.tree_leaves(tree)``.

    True for leaves that are the unconstrained value of a trainable Param;
    False for non-trainable Params and raw array fields (data).
    """
    outer = jax.tree_util.tree_leaves(tree, is_leaf=_is_param)
    mask: list[bool] = []
    for leaf in outer:
        if isinstance(leaf, Param):
            mask.append(leaf.trainable)
        else:
            # a raw array leaf contributes exactly one leaf to the full
            # flatten as well
            mask.append(False)
    n_full = len(jax.tree_util.tree_leaves(tree))
    if len(mask) != n_full:  # pragma: no cover - structural invariant
        raise AssertionError(
            f"leaf alignment broken: {len(mask)} vs {n_full}"
        )
    return mask


def tree_at(where: Callable, tree, replace):
    """Minimal equinox-style functional field replacement.

    ``where`` maps the tree to one node (or tuple of nodes); those nodes are
    replaced by ``replace`` (or tuple) in a copy of the tree.
    """
    targets = where(tree)
    single = not isinstance(targets, tuple)
    if single:
        targets = (targets,)
        replace = (replace,)
    ids = {id(t): i for i, t in enumerate(targets)}

    def is_target(x):
        return id(x) in ids

    def replace_fn(x):
        if id(x) in ids:
            return replace[ids[id(x)]]
        return x

    return jax.tree_util.tree_map(
        replace_fn, tree, is_leaf=lambda x: is_target(x) or _is_param(x)
    )


# ---------------------------------------------------------------------------
# Flat-vector packing of the trainable unconstrained parameters (for MCMC and
# L-BFGS style optimizers that want a single 1-D state vector).
# ---------------------------------------------------------------------------

def pack_trainable(tree):
    """Concatenate trainable unconstrained leaves into one 1-D vector.

    Returns ``(vector, unpack)`` where ``unpack(vector)`` rebuilds a full
    pytree with the trainable leaves replaced from the vector.
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree, is_leaf=_is_param)
    infos = []  # (index, shape, size) for trainable params
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, Param) and leaf.trainable:
            shape = jnp.shape(leaf.unconstrained)
            infos.append((i, shape, int(np.prod(shape)) if shape else 1))
    if not infos:
        raise ValueError("no trainable parameters in tree")
    vec = jnp.concatenate(
        [jnp.ravel(leaves[i].unconstrained) for i, _, _ in infos]
    )

    def unpack(v, _leaves=tuple(leaves), _treedef=treedef, _infos=tuple(infos)):
        new_leaves = list(_leaves)
        off = 0
        for i, shape, size in _infos:
            chunk = jnp.reshape(v[off : off + size], shape)
            new_leaves[i] = new_leaves[i]._replace_unconstrained(chunk)
            off += size
        return jax.tree_util.tree_unflatten(_treedef, new_leaves)

    return vec, unpack


def unpack_trainable(tree, vector):
    _, unpack = pack_trainable(tree)
    return unpack(vector)
