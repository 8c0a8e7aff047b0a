"""Resident render-service pattern: amortised compiles, donated buffers.

A production map service renders a stream of snapshot chunks against a
fixed map geometry. Two properties of the adaptive tiled engine
(``ops.deposit_pallas``) make the steady state fast, and this example
demonstrates both:

1. **Bounded program variety** — every compiled program is keyed on
   *size classes* (padded particle counts, 3-bit-class level buckets), so
   chunk-to-chunk count jitter does NOT recompile. After the first chunk
   of a given shape class, later chunks reuse every executable.
2. **Donated inputs** — ``tile_particles(..., donate=True)`` lets XLA reuse
   the input buffers for the layout, lowering peak device memory in the
   build. The service must not touch the donated arrays afterwards (it
   streams fresh chunks anyway).

    python examples/render_service.py

Runs anywhere (CPU-safe, small sizes); on a GPU the deposit runs its
compiled Triton kernel.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_chunk(rng, n, box, px):
    """Snapshot-ordered clustered chunk (stand-in for one macro-chunk of a
    real EAGLE read; see io.prefetch.stream_macro_chunks for the IO side)."""
    cx = rng.uniform(0, box, n)
    cy = rng.uniform(0, box, n)
    # 32x32 storage cells in snapshot (space-filling-curve-like) order
    cell = (
        np.floor(cy / (box / 32)).astype(int) * 32
        + np.floor(cx / (box / 32)).astype(int)
    )
    order = np.argsort(cell, kind="stable")
    x, y = cx[order].astype(np.float32), cy[order].astype(np.float32)
    dens = rng.uniform(0.3, 3.0, 1024)[cell[order]]
    h = np.clip(
        0.6 * px * dens ** (-1 / 3) * np.exp(0.5 * rng.normal(size=n)),
        0.05 * px,
        12.0 * px,
    ).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    t = rng.uniform(1e4, 1e6, n).astype(np.float32)
    return x, y, h, np.stack([m, m * t])


def main() -> None:
    import jax.numpy as jnp

    from astro_sph_tools_tpu.ops.deposit import MapSpec
    from astro_sph_tools_tpu.ops.deposit_pallas import deposit_tiled, tile_particles

    box = 25.0
    res = 256
    spec = MapSpec(shape=(res, res), extent=(0, box, 0, box), periodic_wrap=True)
    rng = np.random.default_rng(0)
    n_chunks = 4
    n = 120_000  # per chunk; a real service streams ~2^25 per macro-chunk

    total = None
    for ci in range(n_chunks):
        # count jitter between chunks stays inside one size class
        x, y, h, fields = synthetic_chunk(
            rng, n - int(rng.integers(0, 1000)), box, box / res
        )
        t0 = time.perf_counter()
        # donate=True: the layout may reuse the device copies of x/y/h/fields
        # — do not read them after this call
        layout = tile_particles(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(h), jnp.asarray(fields),
            spec, need_perm=False, donate=True,
        )
        maps = deposit_tiled(layout)
        total = maps if total is None else total + maps
        dt = time.perf_counter() - t0
        levels = {f"K={g.cfg.K}": count for g, _, _, count in layout.geoms}
        print(f"chunk {ci + 1}/{n_chunks}: {dt * 1e3:7.1f} ms  {levels}", flush=True)

    sigma = np.asarray(total[0])
    mean_t = np.where(sigma > 0, np.asarray(total[1]) / np.maximum(sigma, 1e-30), 0)
    print(
        f"final map: sigma sum={sigma.sum():.3e}, "
        f"T range=[{mean_t[mean_t > 0].min():.2e}, {mean_t.max():.2e}] K-ish"
    )
    # chunk 1 pays every compile; later chunks reuse the executables —
    # that is the resident-service guarantee this example demonstrates.


if __name__ == "__main__":
    main()
