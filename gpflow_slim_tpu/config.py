"""Global numeric settings.

Replaces the reference's configparser-backed ``settings.py`` + ``gpflowslimrc``
(ref:gpflowSlim/settings.py): ``float_type`` (float64 default there),
``jitter_level`` (~1e-6) and quadrature sizes, with a context-manager override.

Instead of a mutable global read from inside graph construction, we keep a
tiny immutable ``Settings`` dataclass plus a context-manager override. Nothing inside a jitted function reads mutable
global state — settings are baked in at trace time (they are static Python
values), which is exactly the XLA-friendly behavior we want.

The dtype story (SURVEY §7.2 hard-part #1): correctness/parity mode runs
under ``jax_enable_x64`` (tests do this on CPU); perf mode runs f32 with
jitter. ``default_float()`` resolves
to float64 iff x64 is enabled, mirroring how the reference defaulted to
float64 under TF.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Settings:
    """Immutable numeric configuration.

    Attributes:
      jitter: diagonal jitter added before Cholesky factorizations
        (reference ``settings.numerics.jitter_level`` ~ 1e-6).
      positive_minimum: lower shift of the default positive transform
        (reference ``Log1pe`` lower bound, 1e-6).
      num_gauss_hermite_points: quadrature order for non-analytic
        likelihood expectations (reference default 20).
      dist_block_size: block size for distributed/blocked linear algebra.
    """

    jitter: float = 1e-6
    jitter_f32: float = 1e-4
    positive_minimum: float = 1e-6
    num_gauss_hermite_points: int = 20
    dist_block_size: int = 256


_settings = Settings()


def settings() -> Settings:
    """Current global settings (immutable snapshot)."""
    return _settings


def set_settings(new: Settings) -> None:
    global _settings
    _settings = new


@contextlib.contextmanager
def temp_settings(**overrides):
    """Temporarily override settings fields (reference rc-override analog)."""
    global _settings
    old = _settings
    _settings = dataclasses.replace(old, **overrides)
    try:
        yield _settings
    finally:
        _settings = old


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def default_float():
    """float64 when x64 is on (parity mode), else float32 (perf mode)."""
    return jnp.float64 if x64_enabled() else jnp.float32


def default_int():
    return jnp.int64 if x64_enabled() else jnp.int32


def default_jitter() -> float:
    """Dtype-aware jitter: the reference's 1e-6 is an f64 policy; f32
    Cholesky (perf mode) needs a larger floor (SURVEY §7.2 #1)."""
    return _settings.jitter if x64_enabled() else max(
        _settings.jitter, _settings.jitter_f32
    )


def enable_x64(enable: bool = True) -> None:
    """Convenience switch for parity mode (f64 math, CPU-friendly)."""
    jax.config.update("jax_enable_x64", enable)
