"""Mesh-parallel execution: sharded deposits and distributed reorder."""

from .rebalance import rebalance_evenly
from .reorder import distributed_reorder
from .sharded_io import (
    load_particle_fields_sharded,
    open_process_local_snapshot,
    sharded_from_local,
)
from .sharded import (
    deposit_2d_sharded,
    deposit_3d_sharded,
    make_mesh,
    pad_for_mesh,
    partition_particles_by_slab,
)
from .sightlines import absorption_spectra_sharded, column_integrate_sharded

__all__ = [
    "absorption_spectra_sharded",
    "column_integrate_sharded",
    "deposit_2d_sharded",
    "deposit_3d_sharded",
    "rebalance_evenly",
    "distributed_reorder",
    "load_particle_fields_sharded",
    "open_process_local_snapshot",
    "sharded_from_local",
    "make_mesh",
    "pad_for_mesh",
    "partition_particles_by_slab",
]
