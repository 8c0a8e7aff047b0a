"""Analysis-tools namespace (reference-API-compatible re-exports).

The reference exposes its periodic-box functions and the ArrayReorder family
under ``astro_sph_tools.tools`` (`tools/__init__.py:5-7`); this package
mirrors that surface over the JAX implementations in ``ops``, and
additionally ships the *working* projection engine the reference only
intended (`tools/projections`, broken in-tree — SURVEY.md §2.9.1).
"""

from ..ops.deposit import MapSpec, deposit_2d, deposit_weighted_mean
from ..ops.deposit_pallas import deposit_2d_auto, deposit_2d_pallas
from ..ops.grid3d import GridSpec, deposit_3d, deposit_3d_auto
from ..ops.periodic import (
    calculate_periodic,
    make_periodic,
    shift_centre,
    shift_origin,
    wrapped_displacement,
    wrapped_distance,
)
from ..ops.reorder import ArrayMapping, ArrayReorder
from ..ops.sightlines import column_integrate, los_profiles
from ..ops.spectra import absorption_spectra, doppler_parameter_kms
from . import projections
from .projections import create_image, quartic_spline_kernel

# reference naming aliases
calculate_wrapped_displacement = wrapped_displacement
calculate_wrapped_distance = wrapped_distance

# The reference also exports ArrayReorder_2 (its same-semantics v2 rewrite,
# `tools/_ArrayReorder.py:660`) and the MPI variants (`:88,262`). Here the
# modern ArrayReorder IS the v2 semantics, and the distributed engine lives
# in ``parallel.distributed_reorder`` (owner-sharded all_to_all exchange).
ArrayReorder_2 = ArrayReorder


def ArrayReorder_MPI(*args, **kwargs):  # pragma: no cover - guidance shim
    raise NotImplementedError(
        "ArrayReorder_MPI is replaced by the mesh-native "
        "astro_sph_tools_tpu.parallel.distributed_reorder (owner-sharded "
        "lax.all_to_all exchange across the device mesh)."
    )


ArrayReorder_MPI_2 = ArrayReorder_MPI

__all__ = [
    "ArrayMapping",
    "ArrayReorder",
    "ArrayReorder_2",
    "ArrayReorder_MPI",
    "ArrayReorder_MPI_2",
    "GridSpec",
    "MapSpec",
    "calculate_periodic",
    "calculate_wrapped_displacement",
    "calculate_wrapped_distance",
    "absorption_spectra",
    "column_integrate",
    "create_image",
    "projections",
    "quartic_spline_kernel",
    "doppler_parameter_kms",
    "deposit_2d",
    "deposit_2d_auto",
    "deposit_2d_pallas",
    "deposit_3d",
    "deposit_3d_auto",
    "deposit_weighted_mean",
    "los_profiles",
    "make_periodic",
    "shift_centre",
    "shift_origin",
    "wrapped_displacement",
    "wrapped_distance",
]
