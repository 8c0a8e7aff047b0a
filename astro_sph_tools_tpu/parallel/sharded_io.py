"""Host-parallel snapshot ingestion into globally-sharded device arrays.

The mesh-parallel replacement for the reference's MPI data-parallel reads
(SURVEY.md §2.8 row 1: ``pyread_eagle.split_selection`` hands each rank
disjoint file chunks, `io/EAGLE/_SnapshotEAGLE.py:119-130`): each JAX
process opens its slice of the snapshot's file set
(``SnapshotEAGLE(path, process_index=jax.process_index(), ...)``), reads its
local particles with h5py, and the helpers here assemble the per-process
blocks into one global jax.Array sharded over the mesh with
``jax.make_array_from_process_local_data`` — no gather, no host round trips.

Single-process runs degrade to a plain device_put with the same API, so the
pipeline is testable on one host.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data_structures.particle_types import ParticleType
from ..units import UnitArray

if TYPE_CHECKING:  # the IO layer needs h5py; the device path does not
    from ..io.snapshot import SnapshotBase


def open_process_local_snapshot(snapshot_cls, filepath: str, **kwargs):
    """Open a snapshot with this process's slice of the parallel file set."""
    return snapshot_cls(
        filepath,
        process_index=jax.process_index(),
        n_processes=jax.process_count(),
        **kwargs,
    )


def sharded_from_local(
    local: np.ndarray,
    mesh: Mesh,
    axis_name: str = "data",
    pad_value: float = 0.0,
    pad_to_multiple: int = 1,
) -> jax.Array:
    """Build a global array sharded along axis 0 from per-process blocks.

    Local blocks may have unequal lengths across processes; they are padded
    to the (allgathered) maximum rounded to *pad_to_multiple* so the global
    shape is uniform. Returns the global jax.Array.
    """
    local = np.asarray(local)
    n_local = local.shape[0]
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        all_n = np.asarray(multihost_utils.process_allgather(np.asarray(n_local)))
        n_max = int(all_n.max())
    else:
        n_max = n_local
    unit = max(1, pad_to_multiple)
    n_max = ((n_max + unit - 1) // unit) * unit
    if n_local != n_max:
        pad = [(0, n_max - n_local)] + [(0, 0)] * (local.ndim - 1)
        local = np.pad(local, pad, constant_values=pad_value)

    sharding = NamedSharding(mesh, P(axis_name))
    if jax.process_count() == 1:
        # single-process: the mesh shards one host's data directly (a host
        # array goes to its shards, never whole onto one device)
        return jax.device_put(local, sharding)
    global_shape = (n_max * jax.process_count(),) + local.shape[1:]
    return jax.make_array_from_process_local_data(sharding, local, global_shape)


def load_particle_fields_sharded(
    snapshot: SnapshotBase,
    particle_type: ParticleType,
    fields: Sequence[str],
    mesh: Mesh,
    axis_name: str = "data",
    dtype=jnp.float32,
    pad_to_multiple: int = 512,
) -> dict:
    """Read fields process-locally and return globally-sharded device arrays.

    ``fields`` name ``get_*`` getters without the prefix (e.g. "positions",
    "masses", "smoothing_lengths"). Smoothing lengths are padded with 1.0
    (division safety); everything else with 0 — matching the deposit
    engines' padding conventions so the result feeds them directly.
    """
    out = {}
    for name in fields:
        value = getattr(snapshot, f"get_{name}")(particle_type)
        if isinstance(value, UnitArray):
            value = value.value
        pad_value = 1.0 if name == "smoothing_lengths" else 0.0
        out[name] = sharded_from_local(
            np.asarray(value, dtype=np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)),
            mesh,
            axis_name=axis_name,
            pad_value=pad_value,
            pad_to_multiple=pad_to_multiple,
        )
    return out
