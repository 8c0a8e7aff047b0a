"""North-star per-card proxy: 2^27-particle adaptive-h 1024^2 two-field
device-resident render on one card.

The north star is 1024^2 multi-field maps from a 1e9-particle snapshot; one
card's share on a four-card host is 2.5e8 particles, and this proxy renders
N = 2^27 = 1.34e8 of them end to end (layout + deposit).

Workload:
- positions: Morton-coherent clustered draw — a 256^2 Morton-ordered cell
  grid with a blob-mixture density field; consecutive particles are
  spatially adjacent, as in Peano-Hilbert-ordered EAGLE/SWIFT snapshots on
  disk (cf. pyread_eagle's hash-cell chunk reads,
  `io/EAGLE/_SnapshotEAGLE.py:115-130`). ``--order random`` draws the
  cells independently for the incoherent worst case.
- smoothing lengths: density-correlated (h ~ rho^(-1/3)) with lognormal
  scatter, median ~0.5 px (mostly sub-pixel), tail clipped into the K=64
  level so every particle stays on the tiled path.
- a 2-field map stack (surface density + mass-weighted quantity).

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BOX = 25.0
SHAPE = (1024, 1024)


def _morton_order_2d(bits: int) -> np.ndarray:
    """Morton (z-order) rank of each cell of a (2^bits, 2^bits) grid,
    flattened row-major; rank[i * n + j] = interleave(bits of i, j)."""
    n = 1 << bits
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    rank = np.zeros((n, n), dtype=np.int64)
    for b in range(bits):
        rank |= ((ii >> b) & 1) << (2 * b + 1)
        rank |= ((jj >> b) & 1) << (2 * b)
    return rank.reshape(-1)


def build_particles(
    n: int, box: float, shape, *, order: str, seed: int = 7,
    shard: int = 0, n_shards: int = 1,
):
    """Device-resident clustered particle set (x, y, h, fields), made on the
    default device. ``shard`` of ``n_shards`` draws that share of one
    snapshot: the same density field, its own slice of the Morton curve (as
    the files of a snapshot split it) and its own random stream."""
    import jax
    import jax.numpy as jnp

    bits = 8
    n_cells = 1 << (2 * bits)  # 256^2
    grid = 1 << bits
    rng = np.random.default_rng(seed)

    # blob-mixture density on the cell grid: point-mass splat + periodic FFT
    # Gaussian smoothing at three scales (a cheap lognormal-ish clustered
    # field)
    dens = np.zeros((grid, grid))
    fi = np.fft.fftfreq(grid)
    k2 = fi[:, None] ** 2 + fi[None, :] ** 2
    for n_blobs, sig_cells in ((400, 1.5), (1200, 3.0), (600, 6.0)):
        ci = rng.integers(0, grid, n_blobs)
        cj = rng.integers(0, grid, n_blobs)
        w = np.exp(rng.normal(0.0, 1.0, n_blobs))
        point = np.zeros((grid, grid))
        np.add.at(point, (ci, cj), w)
        kernel_ft = np.exp(-2.0 * (np.pi * sig_cells) ** 2 * k2)
        dens += np.real(np.fft.ifft2(np.fft.fft2(point) * kernel_ft))
    # raise the contrast toward the ~4-dex dynamic range of real gas
    # density fields (voids host the large-h tail)
    dens = np.maximum(dens, 0.0) ** 1.5
    dens = dens + 0.02 * dens.mean()
    dens = dens.reshape(-1)

    # order cells along the Morton curve -> coherent on-disk-like layout
    morton = _morton_order_2d(bits)
    cell_seq = np.argsort(morton)  # cell index visited at each curve step
    p = dens[cell_seq] / dens.sum()
    cum = np.cumsum(p)

    jx = jax.random  # device-side per-particle draws
    key = jx.fold_in(jx.PRNGKey(seed), shard) if shard else jx.PRNGKey(seed)
    k1, k2, k3, k4, k5, k6 = jx.split(key, 6)
    u01 = (shard + (jnp.arange(n, dtype=jnp.float32) + 0.5) / n) / n_shards
    step = jnp.searchsorted(jnp.asarray(cum, jnp.float32), u01)  # curve step
    step = jnp.clip(step, 0, n_cells - 1)
    if order == "random":
        # incoherent worst case with the same density field: iid inverse-CDF
        # draws instead of the sequential curve sweep
        step = jnp.searchsorted(
            jnp.asarray(cum, jnp.float32), jx.uniform(k6, (n,))
        )
        step = jnp.clip(step, 0, n_cells - 1)
    cell = jnp.asarray(cell_seq, jnp.int32)[step]
    ci = (cell // grid).astype(jnp.float32)
    cj = (cell % grid).astype(jnp.float32)
    cw = box / grid
    x = (cj + jx.uniform(k1, (n,))) * cw
    y = (ci + jx.uniform(k2, (n,))) * cw

    # density-correlated smoothing lengths, median ~0.5 px, K=64-capped
    px = box / shape[0]
    rho = jnp.asarray(dens / dens.mean(), jnp.float32)[cell]
    h_base = 0.5 * px * rho ** (-1.0 / 3.0)
    h = h_base * jnp.exp(0.6 * jx.normal(k3, (n,)))
    h = jnp.clip(h, 0.02 * px, 15.4 * px).astype(jnp.float32)

    m = jx.uniform(k4, (n,), jnp.float32, 0.5, 2.0)
    t = jx.uniform(k5, (n,), jnp.float32, 1e4, 1e6)
    fields = jnp.stack([m, m * t], axis=0)
    del m, t
    jax.block_until_ready((x, y, h, fields))
    return x, y, h, fields


def run(n: int, order: str, repeats: int = 3, use_kernel: bool = True) -> dict:
    """Best-of-``repeats`` wall of layout + deposit (inputs regenerated
    before each timed window, because the layout donates them).
    ``use_kernel=False`` feeds the same layout to XLA's scatter-add."""
    import jax

    from astro_sph_tools_tpu.ops.deposit import MapSpec
    from astro_sph_tools_tpu.ops.deposit_pallas import _deposit_tiled, tile_particles

    spec = MapSpec(shape=SHAPE, extent=(0.0, BOX, 0.0, BOX), periodic_wrap=True)
    gen = lambda: build_particles(n, BOX, SHAPE, order=order)

    def full():
        tp = tile_particles(*gen(), spec, need_perm=False, donate=True)
        return tp, _deposit_tiled(tp, "kernel3d", use_kernel, False)

    t0 = time.perf_counter()
    tp, out = full()
    jax.block_until_ready(out)
    warm_s = time.perf_counter() - t0
    level_counts = {f"K={meta[0].cfg.K}": int(meta[3]) for meta in tp.geoms}
    n_oversize = int(tp.n_oversize)
    del tp, out

    walls = []
    for _ in range(repeats):
        x, y, h, fields = gen()
        t0 = time.perf_counter()
        tp = tile_particles(x, y, h, fields, spec, need_perm=False, donate=True)
        out = _deposit_tiled(tp, "kernel3d", use_kernel, False)
        jax.block_until_ready(out)
        walls.append(time.perf_counter() - t0)
        del tp, out
    return {
        "n_particles": n,
        "order": order,
        "route": "triton-kernel" if use_kernel else "xla-scatter",
        "wall_s": min(walls),
        "walls_s": walls,
        "level_counts": level_counts,
        "n_oversize": n_oversize,
        "warm_first_s": warm_s,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 27)
    ap.add_argument("--order", choices=("morton", "random"), default="morton")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--xla-route", action="store_true",
                    help="feed the layout to XLA's scatter-add, not the kernel")
    args = ap.parse_args()

    from astro_sph_tools_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    print(json.dumps(run(args.n, args.order, args.repeats, not args.xla_route)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
