"""BASELINE config 2 end-to-end: EAGLE-format snapshot -> 1024^2 map stack.

Generates (once) a clustered synthetic EAGLE snapshot on disk, then times the
full pipeline: HDF5 read -> unit conversion -> fused deposit -> weighted-mean
derivation. Reports per-phase breakdown. Needs h5py.

    python benchmarks/e2e_snapshot_to_map.py [n_gas]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from astro_sph_tools_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    from astro_sph_tools_tpu.data_structures import ParticleType
    from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE
    from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_snapshot
    from astro_sph_tools_tpu.render import render_map_stack

    n_gas = int(sys.argv[1]) if len(sys.argv) > 1 else 4_000_000
    cache_dir = os.path.join(tempfile.gettempdir(), f"ast_e2e_snapshot_{n_gas}")
    spec = SyntheticSnapshotSpec(
        box_size_mpc=25.0,
        n_gas=n_gas,
        n_dm=n_gas // 4,
        n_star=n_gas // 16,
        n_bh=max(8, n_gas // 10_000),
        n_files=8,
        clustered=True,
    )
    first_file = os.path.join(
        cache_dir, f"snapshot_{spec.tag}", f"snap_{spec.tag}.0.hdf5"
    )
    if not os.path.exists(first_file):
        os.makedirs(cache_dir, exist_ok=True)
        t0 = time.perf_counter()
        write_snapshot(cache_dir, spec)
        print(f"wrote synthetic snapshot ({n_gas:.0e} gas): {time.perf_counter() - t0:.1f}s")

    # two passes: the first pays compilation and cold caches; the second is
    # the steady-state number. The host-to-device transfer rides inside the
    # deposit phase either way.
    for label in ("cold", "steady"):
        t_total = time.perf_counter()
        snap = SnapshotEAGLE(first_file)
        stack = render_map_stack(
            snap,
            fields=("density", "temperature", "metallicity"),
            particle_type=ParticleType.gas,
            resolution=1024,
            engine="pallas",
        )
        # force full materialisation
        for name in stack.keys():
            np.asarray(stack[name])
        wall = time.perf_counter() - t_total

        print(
            f"[{label}] end-to-end snapshot->3-field 1024^2 map stack: "
            f"{wall:.2f}s for {n_gas:.0e} gas particles"
        )
        for phase, secs in stack.timings.items():
            print(f"  {phase:<10s} {secs:.2f}s")
    print(f"maps: {sorted(stack.keys())}")


if __name__ == "__main__":
    main()
