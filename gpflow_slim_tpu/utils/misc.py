"""Misc helpers (ref:gpflowSlim/misc.py — shape helpers, name_scope decor).

JAX analogs: ``named_scope`` profiling annotations (profiler attribution
for the gram/chol/leapfrog regions, SURVEY §5 tracing), determinism check,
a NaN-guard toggle, and the persistent compile cache switch.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import subprocess

import jax
import numpy as np

__all__ = ["named_scope", "debug_nans", "check_determinism", "print_summary",
           "enable_compile_cache", "require_gpu"]

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives at ``<repo>/.jax_cache``
    (git-ignored): a fixed path, because the path is part of the cache key.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(_REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> dict:
    """Describe the GPU that JAX runs on; raise ``RuntimeError`` if none.

    Returns ``platform``, ``kind`` and ``count`` as JAX reports them, and
    ``nvidia_smi``: the cards' ``name, power.limit`` lines. Measurements
    name the card and its power limit, since a card capped below its
    maximum runs slower under load.
    """
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devs[0].platform} ({devs[0].device_kind})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi}


def named_scope(name: str):
    """Profiler annotation context (jax.named_scope passthrough)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """NaN-guard debug mode (SURVEY §5 'race detection' analog)."""
    old = jax.config.read("jax_debug_nans")
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


def check_determinism(fn, *args, reps: int = 2) -> bool:
    """Same inputs ⇒ bit-identical outputs (determinism check, SURVEY §5)."""
    outs = [jax.device_get(fn(*args)) for _ in range(reps)]
    flat0 = jax.tree_util.tree_leaves(outs[0])
    for o in outs[1:]:
        for a, b in zip(flat0, jax.tree_util.tree_leaves(o)):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                return False
    return True


def print_summary(model, max_width: int = 100):
    """GPflow-style parameter table for any Module tree."""
    import numpy as np

    from ..params import parameters

    rows = [("name", "transform", "prior", "trainable", "shape", "value")]
    for name, p in parameters(model):
        val = np.asarray(p.value)
        if val.size <= 4:
            vstr = np.array2string(val, precision=4, suppress_small=True)
        else:
            vstr = f"[{val.size} values] mean={val.mean():.4g}"
        rows.append((
            name,
            type(p.transform).__name__,
            type(p.prior).__name__ if p.prior is not None else "-",
            str(p.trainable),
            str(tuple(val.shape)),
            vstr.replace("\n", " "),
        ))
    widths = [min(max(len(r[i]) for r in rows), max_width)
              for i in range(len(rows[0]))]
    lines = []
    for j, r in enumerate(rows):
        lines.append("  ".join(c[:w].ljust(w) for c, w in zip(r, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    out = "\n".join(lines)
    print(out)
    return out
