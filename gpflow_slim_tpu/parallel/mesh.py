"""Device-mesh helpers (no reference counterpart — single-device library).

All distributed capabilities are expressed against a ``jax.sharding.Mesh``;
a 1×…×1 mesh makes every code path the single-device identity (SURVEY §7.1
step 11), so the same code runs on 1 chip, 1 host, or a multi-host slice.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "Mesh", "NamedSharding", "P", "replicated",
           "shard_rows", "initialize_distributed"]


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Multi-host bring-up (SURVEY §2.2 collective-backend row).

    Thin wrapper over ``jax.distributed.initialize``. Where no cluster
    manager describes the job, pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` explicitly. After this,
    ``jax.devices()`` spans the slice and ``make_mesh`` lays global meshes.
    Gang-scheduled semantics: no elasticity — recover by restarting from a
    checkpoint (utils.checkpoint).
    """
    import jax as _jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    _jax.distributed.initialize(**kwargs)


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Create a mesh from an ``{axis: size}`` spec.

    Default: all local devices on a single ``"data"`` axis. Sizes must
    multiply to the device count; a ``-1`` size is inferred.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if axes is None:
        axes = {"data": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, tuple(names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_rows(mesh: Mesh, axis: str) -> NamedSharding:
    return NamedSharding(mesh, P(axis))
