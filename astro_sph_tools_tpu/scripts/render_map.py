"""ast-tpu-render: snapshot -> SPH-projected map(s), the flagship pipeline.

The working incarnation of the reference's design-intent projector CLI (its
``tools/projections`` never shipped working, SURVEY.md §2.9.1): load a
snapshot (EAGLE/SWIFT/TNG), project a particle species onto a 2D map with
the fused deposit engine, and write the result to HDF5 (and optionally PNG).
"""

from __future__ import annotations

import sys
from typing import Optional

import h5py
import numpy as np

from ..data_structures.particle_types import ParticleType
from ..ops.deposit import MapSpec, deposit_2d
from ..ops.deposit_pallas import deposit_2d_auto
from ..utils.console import print_info, timed_phase
from .params import Param, ScriptWrapper, comma_separated

PARAMS = (
    Param("snapshot", "i", "Path to the first snapshot file.", str, required=True),
    Param("format", "f", "Snapshot format: eagle | swift | tng.", str, default="eagle"),
    Param("output", "o", "Output HDF5 path.", str, required=True),
    Param("png", None, "Also write a log10 PNG preview here.", str, default=None),
    Param("particle_type", "p", "gas | dark_matter | star | black_hole.", str, default="gas"),
    Param("resolution", "r", "Map resolution (pixels per side).", int, default=1024),
    Param("axis", "a", "Projection axis: x | y | z.", str, default="z"),
    Param(
        "fields", None,
        "Comma-separated map fields: density, mass, temperature, metallicity.",
        conversion=comma_separated(str), default=["density"],
    ),
    Param("kernel", "k", "SPH kernel name.", str, default="cubic_spline"),
    Param(
        "projection", None, "kernel3d (reference parity) | integrated (physical column).",
        str, default="integrated",
    ),
    Param("engine", None, "pallas (adaptive tiled deposit) | xla (plain scatter stencil).", str, default="pallas"),
    Param("region", None, "x0,x1,y0,y1 map extent in cMpc (default full box).",
          conversion=comma_separated(float), default=None),
    Param(
        "region_pad", None,
        "Loading-region margin in cMpc around --region so kernels that "
        "straddle the map edge still contribute. Default: starts at 5% of "
        "the smaller region side, then grows automatically to the largest "
        "loaded smoothing length (re-reading as needed) so no edge kernel "
        "is dropped. An explicit value disables the auto-grow: pick it "
        ">= the max smoothing length near the edge or accept missing "
        "edge flux. Reads prune to the padded region via the backend's "
        "spatial index (EAGLE block bboxes / SWIFT Cells).",
        float, default=None,
    ),
)


def load_snapshot(path: str, fmt: str):
    if fmt == "eagle":
        from ..io.eagle import SnapshotEAGLE

        return SnapshotEAGLE(path)
    if fmt == "swift":
        from ..io.swift import SnapshotSWIFT

        return SnapshotSWIFT(path)
    if fmt == "tng":
        from ..io.tng import SnapshotTNG

        return SnapshotTNG(path)
    raise SystemExit(f"error: unknown snapshot format {fmt!r}")


def main(argv: Optional[list] = None) -> int:
    wrapper = ScriptWrapper(
        command="ast-tpu-render",
        description="Render SPH-projected maps from a simulation snapshot.",
        parameters=PARAMS,
    )
    return run(**wrapper.parse(argv))


def run(
    snapshot: str,
    format: str,
    output: str,
    png: Optional[str],
    particle_type: str,
    resolution: int,
    axis: str,
    fields,
    kernel: str,
    projection: str,
    engine: str,
    region,
    region_pad: Optional[float] = None,
) -> int:
    from ..data_structures.particle_types import CoordinateAxes

    snap = load_snapshot(snapshot, format)
    pt = ParticleType[particle_type]
    ax = CoordinateAxes.from_string(axis)
    i, j = ax.projection_plane

    if region and len(region) != 4:
        raise SystemExit("error: --region needs x0,x1,y0,y1")
    restricted = region and hasattr(
        snap, "restrict_data_comoving_loading_region"
    )
    pad = None
    if restricted:
        # O(region) IO: restrict loading to the (padded) map region before
        # reading — the spatial index prunes to intersecting file chunks
        box_full = float(snap.box_size.value[0])
        pad = (
            region_pad
            if region_pad is not None
            else 0.05 * min(region[1] - region[0], region[3] - region[2])
        )

        def _restrict(p):
            bounds = [[0.0, box_full] for _ in range(3)]
            bounds[i] = [region[0] - p, region[1] + p]
            bounds[j] = [region[2] - p, region[3] + p]
            snap.restrict_data_comoving_loading_region(
                bounds[0][0], bounds[0][1],
                bounds[1][0], bounds[1][1],
                bounds[2][0], bounds[2][1],
            )

        with timed_phase("restrict loading region"):
            _restrict(pad)

    with timed_phase("read snapshot fields"):
        pos = snap.get_positions(pt).to_value("Mpc")
        h = snap.get_smoothing_lengths(pt).to_value("Mpc")
        if restricted and region_pad is None:
            # data-driven pad: a default guessed before reading can be
            # smaller than the largest kernel near the map edge, silently
            # dropping its contribution. Grow the pad to the max loaded
            # smoothing length and re-restrict until it covers every
            # kernel that could straddle the edge (converges: h bounded).
            for _ in range(3):
                h_max = float(h.max()) if h.size else 0.0
                if h_max <= pad:
                    break
                pad = 1.05 * h_max
                with timed_phase("grow region pad for kernel support"):
                    _restrict(pad)
                pos = snap.get_positions(pt).to_value("Mpc")
                h = snap.get_smoothing_lengths(pt).to_value("Mpc")
        mass = (
            snap.get_masses(pt).to_value("Msun")
            if pt != ParticleType.black_hole
            else snap.get_black_hole_dynamical_masses().to_value("Msun")
        )

    payloads = []
    names = []
    for f in fields:
        if f in ("density", "mass"):
            payloads.append(mass)
            names.append("surface_density" if f == "density" else "mass")
        elif f == "temperature":
            payloads.append(mass * snap.get_temperatures(pt).to_value("K"))
            names.append("mass_weighted_temperature")
        elif f == "metallicity":
            payloads.append(mass * snap.get_metallicities(pt).value)
            names.append("mass_weighted_metallicity")
        else:
            raise SystemExit(f"error: unknown field {f!r}")
    weighted = [n for n in names if n.startswith("mass_weighted")]
    if weighted and "surface_density" not in names and "mass" not in names:
        payloads.append(mass)
        names.append("mass")  # denominator for weighted means

    box = float(snap.box_size.value[0])
    if region:
        extent = tuple(region)
    else:
        extent = (0.0, box, 0.0, box)
    spec = MapSpec(
        shape=(resolution, resolution),
        extent=extent,
        periodic_wrap=not bool(region),
    )

    values = np.stack(payloads, axis=0)
    with timed_phase("deposit"):
        if engine == "pallas":
            maps = deposit_2d_auto(
                pos[:, i], pos[:, j], h, values, spec, kernel=kernel,
                projection=projection,
            )
        else:
            maps = deposit_2d(
                pos[:, i], pos[:, j], h, values.T, spec,
                kernel=kernel, projection=projection,
            )
            maps = np.moveaxis(np.asarray(maps), -1, 0)
    maps = np.asarray(maps)
    if maps.ndim == 2:
        maps = maps[None]

    with timed_phase("write output"):
        with h5py.File(output, "w") as f:
            hdr = f.create_group("Header")
            hdr.attrs["Redshift"] = snap.redshift
            hdr.attrs["BoxSize_cMpc"] = box
            hdr.attrs["Extent_cMpc"] = extent
            hdr.attrs["Axis"] = str(ax)
            hdr.attrs["Kernel"] = kernel
            hdr.attrs["ParticleType"] = pt.common_hdf5_name
            for name, m in zip(names, maps):
                f.create_dataset(name, data=m)
            # derive weighted means where possible
            if "mass" in names or "surface_density" in names:
                denom = maps[names.index("mass" if "mass" in names else "surface_density")]
                for name, m in zip(names, maps):
                    if name.startswith("mass_weighted"):
                        mean = np.where(denom > 0, m / np.maximum(denom, 1e-30), 0.0)
                        f.create_dataset(name.replace("mass_weighted", "mean"), data=mean)
    print_info(f"Wrote {len(names)} map(s) to {output}")

    if png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        img = maps[0]
        plt.figure(figsize=(8, 8))
        plt.imshow(
            np.log10(np.maximum(img, img[img > 0].min() if (img > 0).any() else 1e-30)),
            origin="lower", extent=(extent[0], extent[1], extent[2], extent[3]),
            cmap="inferno",
        )
        plt.colorbar(label=f"log10 {names[0]}")
        plt.xlabel("cMpc")
        plt.ylabel("cMpc")
        plt.tight_layout()
        plt.savefig(png, dpi=150)
        print_info(f"Wrote preview to {png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
