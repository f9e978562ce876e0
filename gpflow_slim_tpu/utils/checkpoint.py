"""Checkpoint / resume (SURVEY §5).

The reference gets checkpointing for free because every Param is a named
``tf.get_variable`` restorable by ``tf.train.Saver``. The pytree analog:
models/optimizer states are ordinary pytrees, saved as their leaf list in
one ``.npz`` archive (arrays by value, structure from a template on load).
Recovery story for a preempted job = restart from the last checkpoint.

``save_checkpoint(path, tree)`` / ``load_checkpoint(path, template)`` for
any pytree (model, ``(model, opt_state, step)``, HMC/NUTS chain state…).
Atomic write (tmp + rename) so a preempted job never sees a torn file.
"""

from __future__ import annotations

import os

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]


def save_checkpoint(path: str, tree, step: int | None = None) -> str:
    """Save a pytree's leaves to ``path`` (npz). Returns the final path.

    With ``step``, writes ``{path}-{step}`` (keeps a numbered history).
    """
    if step is not None:
        path = f"{path}-{step}"
    # custom pytree nodes (Module/Param) carry static metadata that is not
    # array data; save the leaf list — the template supplies the structure
    leaves = jax.tree_util.tree_leaves(jax.device_get(tree))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, *[np.asarray(l) for l in leaves])
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, template):
    """Restore a pytree from ``path`` using ``template`` for structure.

    The template supplies static metadata (transforms, priors, shapes);
    array leaves are replaced by the stored values. Raises ``ValueError``
    when the file's leaf count or a leaf's shape disagrees with the
    template.
    """
    t_leaves, treedef = jax.tree_util.tree_flatten(template)
    with np.load(path, allow_pickle=False) as data:
        if len(data.files) != len(t_leaves):
            raise ValueError(
                f"checkpoint {path!r} holds {len(data.files)} leaves, the "
                f"template has {len(t_leaves)}"
            )
        leaves = [data[f"arr_{i}"] for i in range(len(t_leaves))]
    for i, (t, v) in enumerate(zip(t_leaves, leaves)):
        if np.shape(t) != v.shape:
            raise ValueError(
                f"checkpoint {path!r} leaf {i} has shape {v.shape}, the "
                f"template expects {np.shape(t)}"
            )
    return jax.tree_util.tree_unflatten(treedef, leaves)


def latest_checkpoint(path: str) -> str | None:
    """Highest-numbered ``{path}-{step}`` file, or ``path`` itself."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    best, best_step = None, -1
    if os.path.exists(path):
        best = path
    if os.path.isdir(d):
        for name in os.listdir(d):
            if name.startswith(base + "-"):
                try:
                    step = int(name[len(base) + 1 :])
                except ValueError:
                    continue
                if step > best_step:
                    best, best_step = os.path.join(d, name), step
    return best
