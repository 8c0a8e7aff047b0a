"""k-NN crossover: device shell-walk grid vs host scipy KDTree.

Measures the 32-NN distance derivation (SWIFT DM smoothing lengths,
`_SnapshotSWIFT.py:58-85`) at several scales on clustered periodic boxes,
locating the crossover that sets ``SnapshotSWIFT.DM_HSML_DEVICE_THRESHOLD``.

    python benchmarks/knn_crossover.py [out.json]

Prints one JSON line (and writes it to ``out.json`` when given).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def clustered(rng, m, box):
    nb = max(8, m // 1500)
    centres = rng.uniform(0, box, (nb, 3))
    half = m // 2
    blob = centres[rng.integers(0, nb, half)] + rng.normal(0, box / 40, (half, 3))
    return np.vstack(
        [np.mod(blob, box), rng.uniform(0, box, (m - half, 3))]
    ).astype(np.float32)


def main() -> int:
    import jax

    from astro_sph_tools_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    from scipy.spatial import KDTree

    from astro_sph_tools_tpu.ops.neighbors import knn_distances_grid

    box = 25.0
    k = 32
    rng = np.random.default_rng(3)
    rows = []
    for m in (30_000, 100_000, 300_000, 1_000_000, 3_000_000):
        pts = clustered(rng, m, box)
        # device grid (warm once, then best-of-2 with host round-trip close)
        d = knn_distances_grid(pts, pts, k, periodic_box=box)
        t_grid = 1e30
        for _ in range(2):
            t0 = time.perf_counter()
            d = knn_distances_grid(pts, pts, k, periodic_box=box)
            _ = float(d[0, -1])
            t_grid = min(t_grid, time.perf_counter() - t0)
        # host KDTree (single weak core here; real hosts have more)
        t0 = time.perf_counter()
        tree = KDTree(np.mod(pts, box), boxsize=box)
        exp, _idx = tree.query(np.mod(pts[:20_000], box), k=k, workers=-1)
        t_kd = (time.perf_counter() - t0) * (m / 20_000)
        err = float(
            np.abs(d[:20_000, -1] - exp[:, -1]).max()
            / max(1e-9, exp[:, -1].max())
        )
        rows.append(
            {
                "m": m,
                "grid_s": round(t_grid, 3),
                "kdtree_s_extrapolated": round(t_kd, 3),
                "rel_err_vs_kdtree": err,
            }
        )
        print(f"m={m}: grid {t_grid:.3f}s kdtree ~{t_kd:.3f}s err {err:.2e}",
              file=sys.stderr, flush=True)

    payload = {"metric": "32-NN distance wall (clustered periodic)", "rows": rows,
               "backend": jax.default_backend()}
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(payload, f, indent=1)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
