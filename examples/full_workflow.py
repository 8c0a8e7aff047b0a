"""End-to-end workflow tour of astro-sph-tools-tpu.

Generates a synthetic EAGLE-format simulation directory, then walks every
major capability: discovery, snapshot/catalogue reads, maps (2D stacks, halo
cutouts), 3D cubes, sightlines + spectra, ID reorder, nearest haloes,
ionisation tables, and the particle-filter sidecar. Runs anywhere
(CPU-safe); on a GPU host the 2D deposit runs its compiled Triton kernel.

    python examples/full_workflow.py [workdir]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    workdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        tempfile.gettempdir(), "ast_workflow"
    )
    os.makedirs(workdir, exist_ok=True)

    from astro_sph_tools_tpu.data_structures import CoordinateAxes, ParticleType
    from astro_sph_tools_tpu.io import FileTreeScraper_EAGLE
    from astro_sph_tools_tpu.io.ionisation import (
        IonisationTable_HM01,
        SupportedIons,
        write_synthetic_hm01_table,
    )
    from astro_sph_tools_tpu.io.particle_filter import (
        ParticleFilterFile,
        SnapshotParticleFilter,
    )
    from astro_sph_tools_tpu.io.synthetic import (
        SyntheticSnapshotSpec,
        write_catalogue,
        write_los_file,
        write_snapshot,
    )
    from astro_sph_tools_tpu.ops.grid3d import GridSpec, deposit_3d_auto
    from astro_sph_tools_tpu.ops.reorder import ArrayReorder
    from astro_sph_tools_tpu.ops.sightlines import column_integrate
    from astro_sph_tools_tpu.ops.spectra import absorption_spectra
    from astro_sph_tools_tpu.ops.neighbors import nearest_points
    from astro_sph_tools_tpu.render import render_halo_maps, render_map_stack

    # --- 1. make a synthetic EAGLE-format simulation tree --------------------
    spec = SyntheticSnapshotSpec(
        n_gas=30_000, n_dm=10_000, n_star=2_000, n_bh=8,
        n_files=4, clustered=True, n_groups=8,
    )
    snap_path, truth = write_snapshot(workdir, spec)
    write_catalogue(workdir, spec, truth)
    write_los_file(workdir, spec)
    print(f"[1] synthetic EAGLE tree under {workdir}")

    # --- 2. discovery + load ---------------------------------------------------
    tree = FileTreeScraper_EAGLE(workdir)
    number = tree.catalogues.find_file_number_from_redshift(0.5)
    cat = tree.catalogues.get_by_number(number).load()
    snap = cat.snapshot
    print(f"[2] loaded snapshot z={snap.z:.2f} with {len(cat)} FOF groups")

    # --- 3. multi-field map stack ----------------------------------------------
    stack = render_map_stack(
        snap, fields=("density", "temperature"), resolution=256, engine="pallas"
    )
    sd = stack["surface_density"]
    print(f"[3] 256^2 map stack: total surface density {sd.sum():.3e}")

    # --- 4. halo-centric cutouts --------------------------------------------------
    cutouts = render_halo_maps(snap, cat, [0, 1], resolution=64, engine="xla")
    print(f"[4] {len(cutouts)} halo cutouts, extents {cutouts[0].spec.extent}")

    # --- 5. 3D voxel cube ----------------------------------------------------------
    pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
    h = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
    m = snap.get_masses(ParticleType.gas).to_value("Msun")
    box = float(snap.box_size.value[0])
    cube = deposit_3d_auto(
        pos, np.minimum(h, 0.4), m,
        GridSpec(shape=(64, 64, 64), extent=(0.0, box) * 3, periodic_wrap=True),
    )
    print(f"[5] 64^3 density cube: mass recon {float(np.asarray(cube).sum()) * (box/64)**3 / m.sum():.3f}")

    # --- 6. sightlines + spectra -----------------------------------------------------
    rng = np.random.default_rng(1)
    rx, ry = rng.uniform(0, box, 64), rng.uniform(0, box, 64)
    cols = column_integrate(pos[:, 0], pos[:, 1], h, m, rx, ry, periodic_box=box)
    v = snap.get_velocities(ParticleType.gas).to_value("km/s")
    T = snap.get_temperatures(ParticleType.gas).to_value("K")
    tau, vc = absorption_spectra(
        pos, h, m, v[:, 2], T, rx[:4], ry[:4],
        cosmology=snap.cosmology, box_size=box, n_bins=256,
    )
    # saturated-absorber studies need the natural damping wings:
    tau_v, _ = absorption_spectra(
        pos, h, m, v[:, 2], T, rx[:4], ry[:4],
        cosmology=snap.cosmology, box_size=box, n_bins=256,
        profile="voigt", gamma=6.265e8,  # H I Lya
    )
    print(f"[6] 64 sightline columns (median {np.median(np.asarray(cols)):.3e}); 4 spectra x {len(vc)} bins (+ Voigt wings)")

    # --- 7. catalogue analytics + nearest haloes -----------------------------------
    from astro_sph_tools_tpu.io.catalogue import BasicHaloDefinitions

    centres = cat.get_halo_centres_of_potential().to_value("Mpc")
    m200 = cat.get_halo_masses(BasicHaloDefinitions.SO_200_MEAN.value)  # works here!
    idx, dist = nearest_points(pos[:500], centres, periodic_box=box)
    print(f"[7] nearest halo of 500 particles: median distance {np.median(dist):.2f} cMpc; "
          f"M200_mean range {m200.value.min():.2e}..{m200.value.max():.2e} Msun")

    # --- 8. ID-matched reorder between two orderings ----------------------------------
    ids = snap.get_IDs(ParticleType.gas)
    shuffled = np.random.default_rng(2).permutation(ids)
    op = ArrayReorder.create(ids, shuffled)
    reordered = op(m)
    print(f"[8] reorder {len(ids)} IDs: lossless={op.lossless}")

    # --- 9. ionisation table ------------------------------------------------------------
    write_synthetic_hm01_table(workdir, SupportedIons.O_VI)
    table = IonisationTable_HM01(SupportedIons.O_VI, workdir)
    frac = table.evaluate_at_redshift(np.array([[-4.0, 5.5]]), snap.z)
    print(f"[9] O VI ion fraction at (n_H=1e-4, T=10^5.5, z={snap.z:.1f}): 10^{float(frac[0]):.2f}")

    # --- 10. particle-filter sidecar -------------------------------------------------------
    mask = np.asarray(cols := m > np.median(m))
    pf = ParticleFilterFile(
        filepath=os.path.join(workdir, "filters.hdf5"),
        description="gas above median mass", simulation_type="EAGLE",
    )
    pf.add_snapshot_filter(SnapshotParticleFilter(
        particle_type=ParticleType.gas, redshift=snap.z,
        snapshot_number=snap.number, filepath=snap.filepath,
        allowed_ids=ids[mask], mask=mask,
    ))
    pf.save()
    print(f"[10] particle filter saved ({int(mask.sum())} selected)")
    print("workflow complete.")


if __name__ == "__main__":
    main()
