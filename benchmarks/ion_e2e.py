"""Ion-physics production benchmark.

Promotes the ion-weighted workflow (`tests/test_science_workflow.py`) to
production scale: HM01-style ionisation table -> device-side interp of
per-particle (log n_H, log T) at the snapshot redshift -> ion-weighted
masses fused into the render payload stage -> the adaptive tiled render
(``deposit_2d_auto``) of an O VI column-density + ion-weighted-temperature
1024^2 map stack.

The gas state never returns to the host: the payload program (interp +
weighting) and the render are chained device programs. Reference
capability being composed: `_IonisationTable.py:44-58` interpolation +
the projector the reference never finished
(`tools/projections/_projector.py`). Needs h5py (the table is written to
a temporary HDF5 file).

    python benchmarks/ion_e2e.py [--n 16777216] [--repeats 3] [--out f.json]

Prints one JSON line (and writes it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BOX = 25.0  # cMpc
RES = 1024


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    from astro_sph_tools_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from astro_sph_tools_tpu.io.ionisation import (
        IonisationTable_HM01,
        SupportedIons,
        write_synthetic_hm01_table,
    )
    from astro_sph_tools_tpu.ops.deposit import MapSpec
    from astro_sph_tools_tpu.ops.deposit_pallas import deposit_2d_auto
    from astro_sph_tools_tpu.ops.interp import regular_grid_interpolate

    n = args.n
    tmp = tempfile.mkdtemp(prefix="ion_e2e_")
    write_synthetic_hm01_table(tmp, SupportedIons.O_VI)
    table = IonisationTable_HM01(SupportedIons.O_VI, tmp)
    redshift = 0.5

    # --- device-side generation (untimed): Morton-coherent clustered gas
    key = jax.random.key(7)
    kc, kp, kh, km, knh, kt = jax.random.split(key, 6)
    n_cells = 1 << 14
    cell = jnp.sort(jax.random.randint(kc, (n,), 0, n_cells, dtype=jnp.int32))
    # 2D morton decode of the cell id -> cell origin (coherent storage order)
    def unspread(v):
        v = v & 0x55555555
        v = (v | (v >> 1)) & 0x33333333
        v = (v | (v >> 2)) & 0x0F0F0F0F
        v = (v | (v >> 4)) & 0x00FF00FF
        v = (v | (v >> 8)) & 0x0000FFFF
        return v

    side = 1 << 7  # 128x128 cells
    cx = unspread(cell.astype(jnp.uint32)).astype(jnp.float32)
    cy = unspread((cell.astype(jnp.uint32)) >> jnp.uint32(1)).astype(jnp.float32)
    cw = BOX / side
    x = (cx + jax.random.uniform(kp, (n,))) * cw
    y = (cy + jax.random.uniform(jax.random.fold_in(kp, 1), (n,))) * cw
    px = BOX / RES
    h = jnp.exp(
        jax.random.normal(kh, (n,)) * 0.5 + jnp.log(1.2 * px)
    ).clip(0.1 * px, 14.0 * px)
    mass = jnp.exp(jax.random.normal(km, (n,)) * 0.3) * 1.0e6  # Msun
    log_nh = jax.random.normal(knh, (n,)) * 1.2 - 4.0  # log10 cm^-3
    log_t = jax.random.normal(kt, (n,)) * 0.6 + 4.8  # log10 K
    jax.block_until_ready((x, y, h, mass, log_nh, log_t))

    # constant snapshot z: collapse the redshift plane once, then the
    # per-particle lookup is the gather-free 2-D one-hot path
    axes2, grid2 = table.table_at_redshift(redshift)
    axes2 = tuple(a.astype(jnp.float32) for a in axes2)
    grid2 = grid2.astype(jnp.float32)

    @jax.jit
    def ion_payload(log_nh, log_t, mass, temp_lin):
        """Device payload stage: table interp fused with the weighting."""
        logf = regular_grid_interpolate(
            axes2, grid2, jnp.stack([log_nh, log_t], axis=1),
            fill_value=-jnp.inf,
        )
        frac = jnp.exp2(logf * jnp.float32(np.log2(10.0)))
        ion_mass = mass * frac
        return jnp.stack([ion_mass, ion_mass * temp_lin], axis=0)

    temp_lin = jnp.exp2(log_t * jnp.float32(np.log2(10.0))) * jnp.float32(
        2.0**-16
    )  # scaled K (f32 range hygiene)

    spec = MapSpec(shape=(RES, RES), extent=(0.0, BOX, 0.0, BOX),
                   periodic_wrap=True)

    def render():
        fields = ion_payload(log_nh, log_t, mass, temp_lin)
        return deposit_2d_auto(x, y, h, fields, spec)

    t0 = time.perf_counter()
    maps = render()
    float(maps[0].sum())
    warm_s = time.perf_counter() - t0

    best = float("inf")
    interp_s = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        maps = render()
        float(maps[0].sum())
        best = min(best, time.perf_counter() - t0)
        t0 = time.perf_counter()
        f = ion_payload(log_nh, log_t, mass, temp_lin)
        float(f[0, 0])
        interp_s = min(interp_s, time.perf_counter() - t0)

    sigma = np.asarray(maps[0])
    assert np.isfinite(sigma).all() and sigma.sum() > 0

    res = {
        "metric": (
            "ion-weighted 2-field 1024^2 map stack (device HM01 interp "
            "feeding the adaptive tiled render)"
        ),
        "n_particles": n,
        "wall_s": round(best, 4),
        "particles_per_sec": round(n / best, 1),
        "interp_payload_s": round(interp_s, 4),
        "warm_first_s": round(warm_s, 2),
        "backend": jax.default_backend(),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
