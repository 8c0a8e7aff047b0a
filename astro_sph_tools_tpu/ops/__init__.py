"""Device-side operations: periodic geometry, cell lists, deposit passes."""

from .cells import CellList, build_cell_list, linear_cell_id, morton_encode_3d
from .deposit import MapSpec, deposit_2d, deposit_2d_fixed_h, deposit_weighted_mean
from .deposit_pallas import (
    PALLAS_LEVELS,
    TiledParticles,
    deposit_2d_auto,
    deposit_2d_pallas,
    deposit_tiled,
    tile_particles,
)
from .grid3d import GridSpec, deposit_3d, deposit_3d_auto
from .interp import cubic_spline_1d, regular_grid_interpolate
from .neighbors import (
    knn_distances,
    knn_distances_grid,
    nearest_points,
    nearest_points_device,
    nearest_points_grid,
)
from .reorder import ArrayMapping, ArrayReorder, MatchPlan, match_ids
from .sightlines import column_integrate, column_integrate_binned, los_profiles
from .spectra import (
    absorption_spectra,
    absorption_spectra_binned,
    doppler_parameter_kms,
    voigt_damping_kms,
    voigt_hjerting,
)

from .periodic import (
    calculate_periodic,
    make_periodic,
    shift_centre,
    shift_origin,
    wrapped_displacement,
    wrapped_distance,
)

__all__ = [
    "ArrayMapping",
    "ArrayReorder",
    "CellList",
    "GridSpec",
    "MapSpec",
    "MatchPlan",
    "PALLAS_LEVELS",
    "build_cell_list",
    "absorption_spectra",
    "absorption_spectra_binned",
    "voigt_damping_kms",
    "voigt_hjerting",
    "column_integrate",
    "column_integrate_binned",
    "doppler_parameter_kms",
    "cubic_spline_1d",
    "deposit_2d",
    "deposit_2d_auto",
    "deposit_2d_fixed_h",
    "deposit_2d_pallas",
    "deposit_3d",
    "deposit_3d_auto",
    "deposit_weighted_mean",
    "deposit_tiled",
    "tile_particles",
    "TiledParticles",
    "knn_distances",
    "linear_cell_id",
    "los_profiles",
    "match_ids",
    "morton_encode_3d",
    "nearest_points",
    "nearest_points_device",
    "nearest_points_grid",
    "knn_distances_grid",
    "regular_grid_interpolate",
    "calculate_periodic",
    "make_periodic",
    "shift_centre",
    "shift_origin",
    "wrapped_displacement",
    "wrapped_distance",
]
