"""ast-tpu-find-nearest-haloes: nearest-halo search per gas particle.

Parity target: the ``ast-find-nearest-haloes`` pipeline
(`/root/reference/src/astro_sph_tools/_scripts/find_nearest_haloes.py:90-261`):
pick the catalogue closest to a target redshift, build per-mass-threshold
halo masks from M_200crit, find each gas particle's nearest halo (periodic),
and write per-threshold results (halo index, comoving distance, R_200) to an
HDF5 output with an existing-dataset guard and ``--overwrite`` flag.

Multi-process runs write one file per process (``output.{rank}.hdf5``,
`:104-110`), with the existence check all-gathered over JAX processes
instead of mpi4py.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import h5py
import numpy as np

from ..data_structures.particle_types import ParticleType
from ..io.catalogue import BasicHaloDefinitions
from ..io.filetree import FileTreeScraper_EAGLE
from ..utils.console import print_error, print_info, print_warning
from .params import Param, ScriptWrapper, comma_separated

PARAMS = (
    Param("target_redshift", "z", "Redshift to search for data at.", float, required=True),
    Param("eagle", "e", "Input data is EAGLE-format.", is_flag=True, conflicts=("swift",)),
    Param("swift", "s", "Input data is SWIFT-format.", is_flag=True, conflicts=("eagle",)),
    Param("input_directory", "i", "Simulation data directory.", str, required=True),
    Param("snipshots", None, "Use snipshot data.", is_flag=True),
    Param(
        "skip_file_numbers", None, "File numbers to ignore (comma separated).",
        conversion=comma_separated(str), default=[],
    ),
    Param("output_filepath", "o", "Output file stem (\".hdf5\" appended).", str, required=True),
    Param("overwrite", None, "Allow overwriting an existing dataset.", is_flag=True),
    Param(
        "minimum_log10_halo_masses", "m",
        "Comma-separated log10(M_200crit/Msun) thresholds.",
        conversion=comma_separated(float), default=[],
    ),
)


def _process_info() -> tuple[int, int]:
    try:
        import jax

        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def main(argv: Optional[list] = None) -> int:
    wrapper = ScriptWrapper(
        command="ast-tpu-find-nearest-haloes",
        description="Find the nearest halo to each gas particle at several halo-mass cuts.",
        parameters=PARAMS,
    )
    args = wrapper.parse(argv)
    return run(**args)


def run(
    target_redshift: float,
    eagle: bool,
    swift: bool,
    input_directory: str,
    snipshots: bool,
    skip_file_numbers,
    output_filepath: str,
    overwrite: bool,
    minimum_log10_halo_masses,
) -> int:
    from ..ops.neighbors import nearest_points

    rank, n_proc = _process_info()
    out_path = (
        f"{output_filepath}.{rank}.hdf5" if n_proc > 1 else f"{output_filepath}.hdf5"
    )
    file_exists = os.path.exists(out_path)
    if n_proc > 1:
        from jax.experimental import multihost_utils

        file_exists = bool(np.any(multihost_utils.process_allgather(np.asarray(file_exists))))
    if file_exists:
        print_info(
            "Output file already exists.\nCheck for existing data will be performed "
            "after loading the snapshot."
        )

    if not (eagle or swift):
        print_error("Must specify either EAGLE or SWIFT simulation type.")
        print_info("Terminating...")
        return 1
    if swift:
        if snipshots:
            print_error("SWIFT simulations have no snipshot outputs.")
            print_info("Terminating...")
            return 1
        print_info(f'Using SWIFT data from "{input_directory}".')
        from ..io.filetree import FileTreeScraper_SWIFT

        sim_files = FileTreeScraper_SWIFT(
            input_directory, skip_snapshot_numbers=skip_file_numbers
        )
        catalogues = sim_files.catalogues
    else:
        print_info(f"Using sn[{'I' if snipshots else 'A'}]pshot files.")
        print_info(f'Using EAGLE data from "{input_directory}".')
        sim_files = FileTreeScraper_EAGLE(
            input_directory,
            skip_snapshot_numbers=skip_file_numbers if not snipshots else None,
            skip_snipshot_numbers=skip_file_numbers if snipshots else None,
        )
        catalogues = (
            sim_files.snipshot_catalogues if snipshots else sim_files.catalogues
        )
    file_number = catalogues.find_file_number_from_redshift(target_redshift)
    print_info(f"Selected file number {file_number} for target redshift {target_redshift}.")

    cat = catalogues.get_by_number(file_number).load()
    snap = cat.snapshot
    data_redshift = snap.redshift
    print_info(f"Loaded snapshot and catalogue at redshift {data_redshift}.")

    root_dataset_name = f"redshift_{data_redshift}"
    group_already_exists = False
    if file_exists and os.path.exists(out_path):
        with h5py.File(out_path, "r") as f:
            group_already_exists = root_dataset_name in f
        if group_already_exists and not overwrite:
            print_error("Output file already contains a dataset for this redshift.")
            print_info("Terminating...")
            return 1

    box_width = float(snap.box_size.value[0])
    print_info(f"Box size is {box_width} cMpc.")

    print_info("Reading halo masses.")
    halo_masses = cat.get_halo_masses(BasicHaloDefinitions.SO_200_CRIT.value).value

    print_info("Creating halo mass masks.")
    mask_keys = [-np.inf] + list(minimum_log10_halo_masses)
    halo_masks = {-np.inf: halo_masses > 0.0}
    for log_mass in minimum_log10_halo_masses:
        print_info(f"    log10(M_200) > {log_mass}")
        halo_masks[log_mass] = halo_masses > 10.0**log_mass

    print_info("Reading snapshot particle positions.")
    positions = snap.get_positions(ParticleType.gas).to_value("Mpc")
    halo_ids = cat.get_halo_indexes()
    halo_centres = cat.get_halo_centres_of_potential().to_value("Mpc")
    halo_radii = cat.get_halo_radii(BasicHaloDefinitions.SO_200_CRIT.value).to_value("Mpc")

    n_part = positions.shape[0]
    n_masks = len(mask_keys)
    nearest_id = np.empty((n_part, n_masks), dtype=int)
    nearest_distance = np.empty((n_part, n_masks), dtype=float)
    nearest_radius = np.empty((n_part, n_masks), dtype=float)

    print_info("Searching.")
    for i, key in enumerate(mask_keys):
        mask = halo_masks[key]
        print_info(f"    Searching all haloes with log10(M) > {key}.")
        if mask.sum() == 0:
            print_warning("No haloes above this mass limit.")
            print_warning("Setting null values.")
            nearest_id[:, i] = -1
            nearest_distance[:, i] = np.inf
            nearest_radius[:, i] = 0.0
            continue
        # device shell-walking grid query for big catalogues, dense
        # blocks for small ones (scipy KDTree stays available as the host
        # oracle via method="kdtree"); replaces the reference's threaded
        # KDTree (`_scripts/find_nearest_haloes.py:212-215`)
        idx, distances = nearest_points(
            positions, halo_centres[mask], periodic_box=box_width
        )
        nearest_id[:, i] = halo_ids[mask][idx]
        nearest_distance[:, i] = distances
        nearest_radius[:, i] = halo_radii[mask][idx]

    print_info("Writing results.")
    with h5py.File(out_path, "w" if not os.path.exists(out_path) else "a") as f:
        if group_already_exists:
            del f[root_dataset_name]
        g = f.create_group(root_dataset_name)
        g.attrs["halo_masses"] = mask_keys[1:]
        _write_result(g, nearest_id[:, 0], nearest_distance[:, 0], nearest_radius[:, 0])
        g2 = g.create_group("minimum_halo_mass_limited")
        for i, log_mass in enumerate(mask_keys[1:], start=1):
            g3 = g2.create_group(f"{log_mass:.2f}")
            g3.attrs["minimum_halo_log10_M_200"] = log_mass
            _write_result(g3, nearest_id[:, i], nearest_distance[:, i], nearest_radius[:, i])
    print_info(f"Done: {out_path}")
    return 0


def _write_result(group, ids, distances, radii) -> None:
    group.create_dataset("halo_indexes", data=ids).attrs["Description"] = (
        "Catalogue index of the nearest halo."
    )
    group.create_dataset("halo_comoving_distance", data=distances).attrs["Description"] = (
        "Distance to the centre of the nearest halo in comoving Mpc."
    )
    group.create_dataset("halo_comoving_radius", data=radii).attrs["Description"] = (
        "R_200 of the nearest halo in comoving Mpc."
    )


if __name__ == "__main__":
    sys.exit(main())
