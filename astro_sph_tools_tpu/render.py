"""High-level rendering API: snapshot -> multi-field map stacks.

The user-facing composition of the IO layer and the deposit engines — the
working realisation of the reference's intended ``create_image`` surface
(`tools/projections/_projector.py:75-120`, broken in-tree). One call reads
the needed fields, stacks the deposit payloads (weighted quantities ride the
same fused pass as the weights), renders on the chosen engine, and derives
weighted means.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from .data_structures.particle_types import CoordinateAxes, ParticleType
from .ops.deposit import MapSpec, deposit_2d
from .ops.deposit_pallas import deposit_2d_auto
from .utils.profiling import PhaseTimer

if TYPE_CHECKING:  # the IO layer needs h5py; the device path does not
    from .io.snapshot import SnapshotBase

# field name -> (payload builder, weighted?)
_KNOWN_FIELDS = ("density", "mass", "temperature", "metallicity", "velocity_los", "sfr")


@dataclass
class MapStack:
    """Result of a render: named maps + derived weighted means."""

    maps: dict
    spec: MapSpec
    axis: CoordinateAxes
    particle_type: ParticleType
    timings: dict = field(default_factory=dict)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.maps[name]

    def keys(self):
        return self.maps.keys()


def render_map_stack(
    snapshot: SnapshotBase,
    fields: Sequence[str] = ("density",),
    *,
    particle_type: ParticleType = ParticleType.gas,
    axis: CoordinateAxes = CoordinateAxes.Z,
    resolution: int = 1024,
    extent: Optional[tuple] = None,
    kernel: str = "cubic_spline",
    engine: str = "pallas",
    projection: str = "kernel3d",
    periodic: Optional[bool] = None,
) -> MapStack:
    """Render a stack of SPH-projected maps from a snapshot.

    fields: any of "density" (surface density), "mass", "sfr", and the
    mass-weighted quantities "temperature", "metallicity", "velocity_los"
    (weighted means are derived automatically from a mass map that rides the
    same fused deposit pass).
    """
    timer = PhaseTimer()
    i, j = axis.projection_plane
    box = float(snapshot.box_size.value[0])
    if extent is None:
        extent = (0.0, box, 0.0, box)
        if periodic is None:
            periodic = True
    periodic = bool(periodic)

    with timer.phase("io"):
        pos = snapshot.get_positions(particle_type).to_value("Mpc")
        h = snapshot.get_smoothing_lengths(particle_type).to_value("Mpc")
        if particle_type == ParticleType.black_hole:
            mass = snapshot.get_black_hole_dynamical_masses().to_value("Msun")
        else:
            mass = snapshot.get_masses(particle_type).to_value("Msun")

        payloads: list = []
        names: list = []
        weighted: list = []
        for name in fields:
            if name == "density":
                payloads.append(mass)
                names.append("surface_density")
            elif name == "mass":
                payloads.append(mass)
                names.append("mass")
            elif name == "sfr":
                payloads.append(snapshot.get_sfr().to_value("Msun/yr"))
                names.append("sfr")
            elif name == "temperature":
                payloads.append(mass * snapshot.get_temperatures(particle_type).to_value("K"))
                names.append("mass_weighted_temperature")
                weighted.append("mass_weighted_temperature")
            elif name == "metallicity":
                payloads.append(mass * snapshot.get_metallicities(particle_type).value)
                names.append("mass_weighted_metallicity")
                weighted.append("mass_weighted_metallicity")
            elif name == "velocity_los":
                v = snapshot.get_velocities(particle_type).to_value("km/s")
                los_axis = axis.value
                payloads.append(mass * v[:, los_axis])
                names.append("mass_weighted_velocity_los")
                weighted.append("mass_weighted_velocity_los")
            else:
                raise ValueError(f"Unknown map field {name!r}; known: {_KNOWN_FIELDS}")
        if weighted and "surface_density" not in names and "mass" not in names:
            payloads.append(mass)
            names.append("mass")

    spec = MapSpec(
        shape=(resolution, resolution),
        extent=tuple(float(v) for v in extent),
        periodic_wrap=periodic,
    )
    values = np.stack(payloads, axis=0)

    with timer.phase("deposit"):
        if engine == "pallas":
            maps = deposit_2d_auto(
                pos[:, i], pos[:, j], h, values, spec, kernel=kernel,
                projection=projection,
            )
        elif engine == "xla":
            maps = deposit_2d(
                pos[:, i], pos[:, j], h, values.T, spec, kernel=kernel, projection=projection
            )
            maps = np.moveaxis(np.asarray(maps), -1, 0)
        else:
            raise ValueError(f"Unknown engine {engine!r} (pallas | xla)")
        maps = np.asarray(maps)
        if maps.ndim == 2:
            maps = maps[None]

    result = {name: m for name, m in zip(names, maps)}
    with timer.phase("derive"):
        denom_name = "mass" if "mass" in result else (
            "surface_density" if "surface_density" in result else None
        )
        if denom_name:
            denom = result[denom_name]
            for name in weighted:
                mean = np.where(denom > 0, result[name] / np.maximum(denom, 1e-30), 0.0)
                result[name.replace("mass_weighted", "mean")] = mean

    return MapStack(
        maps=result,
        spec=spec,
        axis=axis,
        particle_type=particle_type,
        timings=timer.report(),
    )


def render_halo_maps(
    snapshot: SnapshotBase,
    catalogue,
    halo_indexes,
    *,
    radius_multiple: float = 2.0,
    radius_definition=None,
    fields: Sequence[str] = ("density",),
    particle_type: ParticleType = ParticleType.gas,
    axis: CoordinateAxes = CoordinateAxes.Z,
    resolution: int = 256,
    kernel: str = "cubic_spline",
    engine: str = "pallas",
    mesh=None,
) -> list[MapStack]:
    """Halo-centric multi-field map stacks (BASELINE config 5's analysis shape).

    With ``mesh`` given, dispatches to :func:`render_halo_maps_sharded`
    (surface-density cutouts rendered from the mesh-sharded particle set).

    For each requested halo, recentres the box on the halo's centre of
    potential (periodic ``shift_centre``) and renders a cutout of
    ``radius_multiple x R_def`` half-width. ``radius_definition`` defaults to
    SO 200 crit (the reference pipeline's choice,
    `_scripts/find_nearest_haloes.py:161-187`).
    """
    from .io.catalogue import BasicHaloDefinitions
    from .kernels.splines import get_kernel
    from .ops.periodic import shift_centre

    if mesh is not None:
        if radius_definition is None:
            radius_definition = BasicHaloDefinitions.SO_200_CRIT.value
        return render_halo_maps_sharded(
            snapshot.get_positions(particle_type).to_value("Mpc"),
            snapshot.get_smoothing_lengths(particle_type).to_value("Mpc"),
            snapshot.get_masses(particle_type).to_value("Msun"),
            catalogue.get_halo_centres_of_potential().to_value("Mpc"),
            catalogue.get_halo_radii(radius_definition).to_value("Mpc"),
            halo_indexes,
            mesh,
            box=float(snapshot.box_size.value[0]),
            radius_multiple=radius_multiple,
            axis=axis,
            resolution=resolution,
            kernel=kernel,
            particle_type=particle_type,
        )

    if radius_definition is None:
        radius_definition = BasicHaloDefinitions.SO_200_CRIT.value

    box = float(snapshot.box_size.value[0])
    centres = catalogue.get_halo_centres_of_potential().to_value("Mpc")
    radii = catalogue.get_halo_radii(radius_definition).to_value("Mpc")

    i, j = axis.projection_plane
    pos = snapshot.get_positions(particle_type).to_value("Mpc")
    h = snapshot.get_smoothing_lengths(particle_type).to_value("Mpc")
    mass = snapshot.get_masses(particle_type).to_value("Msun")

    # build the payload stack once (same semantics as render_map_stack)
    payloads = [mass]
    names = ["surface_density"]
    weighted = []
    for name in fields:
        if name == "density":
            continue
        if name == "temperature":
            payloads.append(mass * snapshot.get_temperatures(particle_type).to_value("K"))
            names.append("mass_weighted_temperature")
            weighted.append("mass_weighted_temperature")
        elif name == "metallicity":
            payloads.append(mass * snapshot.get_metallicities(particle_type).value)
            names.append("mass_weighted_metallicity")
            weighted.append("mass_weighted_metallicity")
        else:
            raise ValueError(f"Unknown halo-map field {name!r}")
    values = np.stack(payloads, axis=0)

    from .ops.deposit import deposit_2d
    from .ops.deposit_pallas import deposit_2d_auto

    stacks = []
    for halo_index in np.atleast_1d(halo_indexes):
        centre = centres[halo_index]
        half_width = radius_multiple * float(radii[halo_index])
        recentred = np.asarray(shift_centre(pos, centre, box))
        lo, hi = box / 2 - half_width, box / 2 + half_width
        spec = MapSpec(
            shape=(resolution, resolution), extent=(lo, hi, lo, hi), periodic_wrap=False
        )
        # pre-cut to the cutout (+ kernel support radius S_f*h, not a literal
        # 2h: quintic/Wendland kernels reach 3h) to keep the deposit small
        support = get_kernel(kernel).support_factor * h
        sel = (
            (np.abs(recentred[:, i] - box / 2) < half_width + support)
            & (np.abs(recentred[:, j] - box / 2) < half_width + support)
        )
        if engine == "pallas":
            maps = deposit_2d_auto(
                recentred[sel, i], recentred[sel, j], h[sel], values[:, sel], spec,
                kernel=kernel,
            )
        else:
            maps = deposit_2d(
                recentred[sel, i], recentred[sel, j], h[sel], values[:, sel].T, spec,
                kernel=kernel,
            )
            maps = np.moveaxis(np.asarray(maps), -1, 0)
        maps = np.asarray(maps)
        if maps.ndim == 2:
            maps = maps[None]
        result = {name: m for name, m in zip(names, maps)}
        denom = result["surface_density"]
        for name in weighted:
            result[name.replace("mass_weighted", "mean")] = np.where(
                denom > 0, result[name] / np.maximum(denom, 1e-30), 0.0
            )
        stacks.append(
            MapStack(
                maps=result, spec=spec, axis=axis, particle_type=particle_type,
                timings={},
            )
        )
    return stacks


def render_halo_maps_sharded(
    positions,  # (N, 3) Mpc — sharded (or shardable) over the mesh
    h,  # (N,)
    mass,  # (N,)
    centres,  # (n_haloes, 3) host catalogue centres
    radii,  # (n_haloes,) host catalogue radii (R_def)
    halo_indexes,
    mesh,
    *,
    box: float,
    radius_multiple: float = 2.0,
    axis: CoordinateAxes = CoordinateAxes.Z,
    resolution: int = 256,
    kernel: str = "cubic_spline",
    particle_type: ParticleType = ParticleType.gas,
    axis_name: str = "data",
) -> list[MapStack]:
    """Halo cutout surface-density maps from a mesh-sharded particle array
    (BASELINE config 5's multi-chip analysis shape).

    Each halo's render is one jit program over the mesh: periodic recentre
    (elementwise over the sharded axis), then the sharded tiled deposit +
    psum. No host-side particle selection — out-of-cutout
    particles contribute nothing to the tile windows, so the full sharded
    array feeds every halo and the catalogue arrays stay host-side.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .kernels.splines import get_kernel
    from .ops.periodic import shift_centre
    from .parallel.sharded import _ALIGN, deposit_2d_sharded, pad_for_mesh

    support_max = get_kernel(kernel).support_factor * float(np.asarray(h).max())
    i, j = axis.projection_plane
    n_dev = mesh.shape[axis_name]
    pos_p, h_p, m_p = pad_for_mesh(
        [np.asarray(positions, np.float32), np.asarray(h, np.float32),
         np.asarray(mass, np.float32)],
        n_dev, _ALIGN, pad_values=[0.0, 1.0, 0.0],
    )
    # each device receives only its particle shard
    sharded = NamedSharding(mesh, P(axis_name))
    pos_d, h_d, m_d = (jax.device_put(a, sharded) for a in (pos_p, h_p, m_p))

    centres = np.asarray(centres)
    radii = np.asarray(radii)

    stacks = []
    for halo_index in np.atleast_1d(halo_indexes):
        half_width = radius_multiple * float(radii[halo_index])
        lo, hi = box / 2 - half_width, box / 2 + half_width
        spec = MapSpec(
            shape=(resolution, resolution), extent=(lo, hi, lo, hi),
            periodic_wrap=False,
        )
        centre = jnp.asarray(centres[halo_index], jnp.float32)
        # level sized to the largest footprint at this cutout's pixel scale
        px = 2 * half_width / resolution
        K = max(8, 2 * int(np.ceil(support_max / px)) + 2)

        @jax.jit
        def render(pos_, h_, m_, centre_):
            recentred = shift_centre(pos_, centre_, box)
            return deposit_2d_sharded(
                recentred[:, i], recentred[:, j], h_, m_, spec, mesh,
                K=K, engine="pallas",
            )

        img = np.asarray(render(pos_d, h_d, m_d, centre))
        stacks.append(
            MapStack(
                maps={"surface_density": img}, spec=spec, axis=axis,
                particle_type=particle_type, timings={},
            )
        )
    return stacks
