"""Multi-device sightline columns and spectra (config 4 over a mesh).

Sightline columns and velocity-space spectra are *sums over particles*
(``total_r = sum_i q_i Y(b_ri, h_i)``), so the multi-device decomposition is
data-parallel with no halo exchange: every process/device integrates its
local particle shard against the full (replicated, tiny) ray set with the
cell-binned single-device engine, and the per-shard partials are reduced by
addition. This mirrors the reference's MPI data-parallel reads
(`io/EAGLE/_SnapshotEAGLE.py:119-130`) + root-gather pattern.

The deposit path needs ``ppermute`` halo rings because tiles are spatial;
rays are not tiled across devices, so this module is deliberately simple —
the engines themselves (``ops.sightlines``, ``ops.spectra``) do the work.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sightlines import column_integrate_binned
from ..ops.spectra import absorption_spectra_binned

Array = jax.Array


def column_integrate_sharded(
    shards: Sequence[tuple],  # per-shard (x, y, h, values) local arrays
    ray_x,
    ray_y,
    *,
    kernel: str = "cubic_spline",
    projection: str = "integrated",
    periodic_box: Optional[float] = None,
    devices: Optional[Sequence] = None,
) -> Array:
    """Per-ray columns from particle shards: run the binned engine per shard
    (on its device when ``devices`` is given), tree-sum the partials.

    In a multi-host deployment each process passes its single local shard
    (``shards=[local]``) and reduces across processes with
    ``jax.lax.psum`` / ``multihost_utils``; this entry point also serves the
    single-process many-device layout used by the CI mesh.
    """
    partials = []
    for si, (x, y, h, values) in enumerate(shards):
        if devices is not None:
            dev = devices[si % len(devices)]
            with jax.default_device(dev):
                part = column_integrate_binned(
                    x, y, h, values, ray_x, ray_y,
                    kernel=kernel, projection=projection,
                    periodic_box=periodic_box,
                )
        else:
            part = column_integrate_binned(
                x, y, h, values, ray_x, ray_y,
                kernel=kernel, projection=projection,
                periodic_box=periodic_box,
            )
        partials.append(part)
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    return total


def absorption_spectra_sharded(
    shards: Sequence[tuple],  # per-shard (pos, h, values, v_los, T) locals
    ray_x,
    ray_y,
    *,
    cosmology=None,
    box_size: Optional[float] = None,
    atomic_weight: float = 1.008,
    n_bins: int = 512,
    kernel: str = "cubic_spline",
    periodic: bool = True,
):
    """Per-ray spectra from particle shards (additive over particles).

    Requires a cosmology + box_size so every shard uses the same box-derived
    velocity bins; data-dependent bin ranges would differ per shard and the
    partials could not be summed.
    """
    if cosmology is None or box_size is None:
        raise ValueError(
            "sharded spectra need cosmology and box_size (shared, box-derived "
            "velocity bins); per-shard data-dependent ranges cannot be summed"
        )
    total = None
    v_centres = None
    for pos, h, values, v_los, T in shards:
        tau, v_centres = absorption_spectra_binned(
            pos, h, values, v_los, T, ray_x, ray_y,
            cosmology=cosmology, box_size=box_size,
            atomic_weight=atomic_weight, n_bins=n_bins, kernel=kernel,
            periodic=periodic,
        )
        total = tau if total is None else total + tau
    return total, v_centres
