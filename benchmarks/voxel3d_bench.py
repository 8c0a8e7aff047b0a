"""Config-3-class 3D voxel benchmark: 512^3 periodic cube from a clustered
16.8M-particle distribution with adaptive smoothing lengths, through
``deposit_3d_auto`` (support-level binning + XLA's K^3 stencil
scatter-add per level).

Usage: python benchmarks/voxel3d_bench.py [--n 16777216] [--grid 512] [--out f.json]

Prints one JSON line (and writes it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_particles(n: int, box: float, seed: int = 11):
    """Clustered positions + density-correlated lognormal h (the config-3
    regime: most particles within a few-voxel footprint, tail to K=16)."""
    rng = np.random.default_rng(seed)
    n_blob = int(0.6 * n)
    n_bg = n - n_blob
    n_groups = 256
    centres = rng.uniform(0, box, (n_groups, 3))
    sigma = rng.uniform(0.01, 0.05, n_groups) * box
    gidx = rng.integers(0, n_groups, n_blob)
    pos_blob = centres[gidx] + rng.normal(0, 1, (n_blob, 3)) * sigma[gidx][:, None]
    pos_bg = rng.uniform(0, box, (n_bg, 3))
    pos = np.concatenate([pos_blob, pos_bg]).astype(np.float32) % box
    # lognormal h: blobs dense (small h), background coarse
    h_blob = np.exp(rng.normal(np.log(0.0015 * box), 0.35, n_blob))
    h_bg = np.exp(rng.normal(np.log(0.006 * box), 0.35, n_bg))
    h = np.concatenate([h_blob, h_bg]).astype(np.float32)
    vals = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return pos, h, vals


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from astro_sph_tools_tpu.ops.grid3d import GridSpec, deposit_3d_auto
    from astro_sph_tools_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()

    box = 25.0
    g = args.grid
    spec = GridSpec(
        shape=(g, g, g), extent=(0, box, 0, box, 0, box), periodic_wrap=True
    )
    # cap h inside the K=16 stencil level (no dense fallback)
    vox = box / g
    h_max = 0.45 * 16 * vox

    t0 = time.perf_counter()
    pos, h, vals = build_particles(args.n, box)
    h = np.minimum(h, h_max)
    gen_s = time.perf_counter() - t0

    def full():
        return deposit_3d_auto(pos, h, vals, spec)

    t0 = time.perf_counter()
    out = full()
    checksum = float(out.sum())
    warm_s = time.perf_counter() - t0

    wall = 1e30
    for _ in range(args.repeats):
        del out
        t0 = time.perf_counter()
        out = full()
        s = float(out.sum())
        wall = min(wall, time.perf_counter() - t0)
        assert abs(s / checksum - 1) < 1e-5

    res = {
        "metric": "3D voxel deposit wall (config-3 class)",
        "n_particles": args.n,
        "grid": g,
        "wall_s": round(wall, 4),
        "particles_per_sec": round(args.n / wall, 1),
        "warm_first_s": round(warm_s, 2),
        "gen_s": round(gen_s, 2),
        "checksum": checksum,
        "backend": jax.default_backend(),
    }
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
