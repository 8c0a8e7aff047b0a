"""ast-tpu-sightlines: column densities and absorption spectra from a snapshot.

The CLI face of BASELINE config 4: cast rays through a snapshot (random or
from a file of positions), integrate per-ray kernel columns, and optionally
synthesise velocity-space absorption spectra; results go to HDF5.
"""

from __future__ import annotations

import sys
from typing import Optional

import h5py
import numpy as np

from ..data_structures.particle_types import ParticleType
from ..ops.sightlines import column_integrate, column_integrate_binned
from ..ops.spectra import absorption_spectra, absorption_spectra_binned
from ..utils.console import print_info, timed_phase
from .params import Param, ScriptWrapper, comma_separated
from .render_map import load_snapshot

PARAMS = (
    Param("snapshot", "i", "Path to the first snapshot file.", str, required=True),
    Param("format", "f", "Snapshot format: eagle | swift | tng.", str, default="eagle"),
    Param("output", "o", "Output HDF5 path.", str, required=True),
    Param("n_rays", "n", "Number of random rays (ignored with --ray-file).", int, default=1000),
    Param("ray_file", None, "Text file of 'x y' ray positions in cMpc.", str, default=None),
    Param("seed", None, "Random-ray seed.", int, default=8),
    Param("axis", "a", "Projection axis: x | y | z.", str, default="z"),
    Param("kernel", "k", "SPH kernel name.", str, default="cubic_spline"),
    Param("spectra", None, "Also synthesise velocity-space spectra.", is_flag=True),
    Param("spectra_bins", None, "Velocity bins for spectra.", int, default=512),
    Param("atomic_weight", None, "Ion mass (amu) for Doppler widths.", float, default=1.008),
    Param(
        "profile", None,
        "Line profile for spectra: gaussian (thermal core) | voigt "
        "(adds natural damping wings; needs --gamma).",
        str, default="gaussian",
    ),
    Param(
        "gamma", None,
        "Damping rate Gamma (1/s) for --profile voigt; H I Lya: 6.265e8.",
        float, default=None,
    ),
    Param(
        "rest_wavelength", None,
        "Line rest wavelength in Angstrom (default Lya 1215.67).",
        float, default=1215.67,
    ),
    Param(
        "engine", None,
        "Integration engine: auto | binned | dense (auto = cell-binned pass "
        "for large ray x particle workloads, dense sweep otherwise).",
        str, default="auto",
    ),
)


def _use_binned(engine: str, n_pairs: float) -> bool:
    if engine == "binned":
        return True
    if engine == "dense":
        return False
    if engine != "auto":
        raise SystemExit(f"error: unknown engine {engine!r}")
    # small sweeps stay on the dense path (no schedule/compile overhead)
    return n_pairs >= 1e7


def main(argv: Optional[list] = None) -> int:
    wrapper = ScriptWrapper(
        command="ast-tpu-sightlines",
        description="Integrate sightline columns (and optional spectra) through a snapshot.",
        parameters=PARAMS,
    )
    return run(**wrapper.parse(argv))


def run(
    snapshot: str,
    format: str,
    output: str,
    n_rays: int,
    ray_file: Optional[str],
    seed: int,
    axis: str,
    kernel: str,
    spectra: bool,
    spectra_bins: int,
    atomic_weight: float,
    engine: str = "auto",
    profile: str = "gaussian",
    gamma: Optional[float] = None,
    rest_wavelength: float = 1215.67,
) -> int:
    from ..data_structures.particle_types import CoordinateAxes

    snap = load_snapshot(snapshot, format)
    ax = CoordinateAxes.from_string(axis)
    i, j = ax.projection_plane
    box = float(snap.box_size.value[0])

    if ray_file:
        rays = np.loadtxt(ray_file, ndmin=2)
        if rays.shape[1] != 2:
            raise SystemExit("error: --ray-file needs two columns (x y in cMpc)")
        rx, ry = rays[:, 0], rays[:, 1]
    else:
        rng = np.random.default_rng(seed)
        rx = rng.uniform(0.0, box, n_rays)
        ry = rng.uniform(0.0, box, n_rays)

    with timed_phase("read snapshot fields"):
        pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
        h = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
        m = snap.get_masses(ParticleType.gas).to_value("Msun")

    with timed_phase("column integration"):
        column_fn = (
            column_integrate_binned
            if _use_binned(engine, float(len(h)) * len(rx))
            else column_integrate
        )
        cols = np.asarray(
            column_fn(
                pos[:, i], pos[:, j], h, m, rx, ry,
                kernel=kernel, projection="integrated", periodic_box=box,
            )
        )

    spec_data = None
    if spectra:
        with timed_phase("spectra synthesis"):
            v = snap.get_velocities(ParticleType.gas).to_value("km/s")
            T = snap.get_temperatures(ParticleType.gas).to_value("K")
            # rotate so the LOS axis is z for the spectra engine
            pos_rot = pos[:, [i, j, ax.value]]
            spectra_fn = (
                absorption_spectra_binned
                if _use_binned(engine, float(len(h)) * len(rx))
                else absorption_spectra
            )
            tau, v_centres = spectra_fn(
                pos_rot, h, m, v[:, ax.value], T, rx, ry,
                cosmology=snap.cosmology, box_size=box, n_bins=spectra_bins,
                atomic_weight=atomic_weight, kernel=kernel,
                profile=profile, gamma=gamma,
                rest_wavelength_angstrom=rest_wavelength,
            )
            spec_data = (np.asarray(tau), v_centres)

    with h5py.File(output, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["Redshift"] = snap.redshift
        hdr.attrs["BoxSize_cMpc"] = box
        hdr.attrs["Axis"] = str(ax)
        hdr.attrs["Kernel"] = kernel
        f.create_dataset("ray_x", data=rx).attrs["Description"] = "cMpc"
        f.create_dataset("ray_y", data=ry).attrs["Description"] = "cMpc"
        f.create_dataset("column_density", data=cols).attrs["Description"] = (
            "Mass column density, Msun / cMpc^2 (integrated kernel)."
        )
        if spec_data is not None:
            tau, v_centres = spec_data
            g = f.create_group("Spectra")
            g.create_dataset("velocity_kms", data=v_centres)
            g.create_dataset("tau", data=tau).attrs["Description"] = (
                "Doppler-broadened kernel column per velocity bin "
                "(multiply by the line cross-section for optical depth)."
            )
    print_info(f"Wrote {len(rx)} sightlines to {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
