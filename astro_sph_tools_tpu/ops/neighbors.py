"""Nearest-neighbor queries: device brute-force + host KDTree dispatch.

The reference's neighbor workloads are (a) nearest-halo searches with scipy
``KDTree(boxsize=...)`` thread fan-out (`_scripts/find_nearest_haloes.py:212-215`)
and (b) k-NN smoothing lengths for SWIFT dark matter
(`io/SWIFT/_SnapshotSWIFT.py:58-85`). On an accelerator, tree walks are
hostile (data-dependent branching); instead:

- :func:`nearest_points_device` — chunked dense distance blocks
  with periodic minimum-image handling and an ``argmin`` reduction:
  O(N_query x M_points) but fully vectorized. For the halo workload
  (M ~ 1e4-1e6 haloes), a 1e8-particle query sweep is ~1e13 flop-class —
  viable on the device, and far simpler than emulating a tree.
- :func:`nearest_points_grid` — the shell-walking grid query for huge M:
  statically-unrolled Chebyshev shells over a periodic cell grid with
  per-chunk early exit, a residual spill pass, and a dense void fallback;
  exact match vs scipy KDTree on clustered periodic boxes.
- :func:`knn_distances_grid` — the k-nearest generalization (fixed-k
  insertion into per-query best lists over the same shell walk), used for
  SWIFT dark-matter smoothing lengths at scale.
- :func:`nearest_points` — dispatcher: device path when M is small enough
  to make dense blocks efficient, scipy KDTree (all cores) otherwise. Its
  thresholds are not yet measured on the GPU.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_DEVICE_MAX_POINTS = 200_000


@partial(jax.jit, static_argnames=("chunk", "periodic_box"))
def _nearest_impl(queries, points, *, chunk, periodic_box):
    n = queries.shape[0]
    n_chunks = n // chunk

    def body(_, q):
        d = q[:, None, :] - points[None, :, :]  # (C, M, 3)
        if periodic_box is not None:
            box = periodic_box
            d = d - jnp.round(d / box) * box
        d2 = (d * d).sum(axis=-1)
        idx = jnp.argmin(d2, axis=1)
        return None, (idx.astype(jnp.int32), jnp.sqrt(d2[jnp.arange(chunk), idx]))

    _, (idx, dist) = jax.lax.scan(body, None, queries.reshape(n_chunks, chunk, 3))
    return idx.reshape(-1), dist.reshape(-1)


def nearest_points_device(
    queries, points, *, periodic_box: Optional[float] = None, chunk: int = 1024
) -> tuple[np.ndarray, np.ndarray]:
    """(index, distance) of the nearest point for every query, on device."""
    queries = np.asarray(queries, np.float32)
    points = np.asarray(points, np.float32)
    n = queries.shape[0]
    n_pad = max(chunk, ((n + chunk - 1) // chunk) * chunk)
    q = np.pad(queries, [(0, n_pad - n), (0, 0)])
    idx, dist = _nearest_impl(
        jnp.asarray(q), jnp.asarray(points), chunk=chunk, periodic_box=periodic_box
    )
    return np.asarray(idx[:n]), np.asarray(dist[:n])


_DENSE_MAX_POINTS = 20_000  # below this, dense blocks beat grid setup


def nearest_points(
    queries, points, *, periodic_box: Optional[float] = None,
    prefer_device: Optional[bool] = None, method: Optional[str] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-point query dispatching between the device engines and scipy.

    Matches the reference pipeline's outputs (index into ``points`` and the
    periodic distance). Device paths: dense blocks for small point sets,
    the shell-walking grid query (:func:`nearest_points_grid`) for large
    ones — the scipy KDTree remains available via ``method="kdtree"`` as the
    host oracle.
    """
    points = np.asarray(points)
    if method is None:
        if prefer_device is False:
            method = "kdtree"
        elif points.shape[0] <= _DENSE_MAX_POINTS:
            method = "dense"
        else:
            method = "grid"
    if method == "dense":
        return nearest_points_device(queries, points, periodic_box=periodic_box)
    if method == "grid":
        return nearest_points_grid(queries, points, periodic_box=periodic_box)
    if method != "kdtree":
        raise ValueError(f"Unknown method {method!r} (dense | grid | kdtree)")
    from scipy.spatial import KDTree

    if periodic_box is not None:
        tree = KDTree(np.mod(points, periodic_box), boxsize=periodic_box)
        dist, idx = tree.query(np.mod(np.asarray(queries), periodic_box), workers=-1)
    else:
        tree = KDTree(points)
        dist, idx = tree.query(np.asarray(queries), workers=-1)
    return idx.astype(np.int64), dist


@partial(jax.jit, static_argnames=("k", "chunk", "periodic_box"))
def _knn_impl(queries, points, *, k, chunk, periodic_box):
    n = queries.shape[0]
    n_chunks = n // chunk

    def body(_, q):
        d = q[:, None, :] - points[None, :, :]
        if periodic_box is not None:
            box = periodic_box
            d = d - jnp.round(d / box) * box
        d2 = (d * d).sum(axis=-1)
        kth = -jax.lax.top_k(-d2, k)[0]  # (C, k) smallest distances, sorted asc
        return None, jnp.sqrt(kth)

    _, dists = jax.lax.scan(body, None, queries.reshape(n_chunks, chunk, 3))
    return dists.reshape(-1, k)


def knn_distances(
    queries, points, k: int, *, periodic_box: Optional[float] = None, chunk: int = 512
) -> np.ndarray:
    """Distances to the k nearest points (ascending), on device.

    The device analogue of the SWIFT DM smoothing-length derivation
    (32-nearest-neighbour distance, `_SnapshotSWIFT.py:58-85`).
    """
    queries = np.asarray(queries, np.float32)
    points = np.asarray(points, np.float32)
    n = queries.shape[0]
    n_pad = max(chunk, ((n + chunk - 1) // chunk) * chunk)
    q = np.pad(queries, [(0, n_pad - n), (0, 0)])
    d = _knn_impl(jnp.asarray(q), jnp.asarray(points), k=k, chunk=chunk, periodic_box=periodic_box)
    return np.asarray(d[:n])


# ---------------------------------------------------------------------------
# Shell-walking grid query (huge point sets)
# ---------------------------------------------------------------------------

_GRID_CHUNK = 256
_R_CAP = 3  # statically unrolled shells; beyond -> dense fallback per chunk


def _shell_offsets(r: int) -> np.ndarray:
    """Cell offsets at Chebyshev radius exactly r, shape (n, 3)."""
    rng = np.arange(-r, r + 1)
    g = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1).reshape(-1, 3)
    cheb = np.abs(g).max(axis=1)
    return g[cheb == r].astype(np.int32)


@partial(
    jax.jit,
    static_argnames=("g", "cap", "chunk", "periodic", "cell", "origin", "m_pad"),
)
def _grid_query_impl(
    queries,  # (n_pad, 3)
    points,  # (m_pad, 3) — row m is an inf sentinel
    buckets,  # (g^3, cap) int32 point indices, sentinel = m_pad - 1
    residual_idx,  # (n_res_pad,) spilled point indices (sentinel-padded)
    *,
    g, cap, chunk, periodic, cell, origin, m_pad,
):
    n = queries.shape[0]
    n_chunks = n // chunk
    box = g * cell  # world size of the grid (periodic wrap length)

    def min_image(d):
        if periodic:
            return d - jnp.round(d / box) * box
        return d

    def chunk_fn(_, q):  # q: (chunk, 3)
        ci = jnp.floor((q - jnp.asarray(origin)) / cell).astype(jnp.int32)
        ci = jnp.mod(ci, g) if periodic else jnp.clip(ci, 0, g - 1)
        best_d2 = jnp.full((chunk,), jnp.inf, jnp.float32)
        best_i = jnp.full((chunk,), -1, jnp.int32)

        def probe(offs, carry):
            best_d2, best_i, any_full = carry
            cc = ci[:, None, :] + jnp.asarray(offs)[None, :, :]  # (C, O, 3)
            if periodic:
                cc = jnp.mod(cc, g)
                in_grid = jnp.ones(cc.shape[:2], bool)
            else:
                in_grid = ((cc >= 0) & (cc < g)).all(axis=-1)
                cc = jnp.clip(cc, 0, g - 1)
            flat = (cc[..., 2] * g + cc[..., 1]) * g + cc[..., 0]  # (C, O)
            cand = buckets[flat]  # (C, O, cap)
            cand = jnp.where(in_grid[..., None], cand, m_pad - 1)
            # a probed bucket whose last slot is real hit its cap, so its
            # overflow lives in the residual list -> this chunk must run the
            # spill pass (chunks that only saw under-cap buckets skip it)
            any_full = any_full | (cand[..., -1] != m_pad - 1).any()
            p = points[cand]  # (C, O, cap, 3)
            d = min_image(q[:, None, None, :] - p)
            d2 = (d * d).sum(-1)  # (C, O, cap)
            d2 = jnp.where(cand == m_pad - 1, jnp.inf, d2)
            d2f = d2.reshape(chunk, -1)
            cf = cand.reshape(chunk, -1)
            j = jnp.argmin(d2f, axis=1)
            ar = jnp.arange(chunk)
            better = d2f[ar, j] < best_d2
            return (
                jnp.where(better, d2f[ar, j], best_d2),
                jnp.where(better, cf[ar, j], best_i),
                any_full,
            )

        carry = (best_d2, best_i, jnp.asarray(False))
        for r in range(_R_CAP + 1):
            offs = _shell_offsets(r)
            if r == 0:
                carry = probe(offs, carry)
            else:
                # after finishing shell r-1, any unexplored point is at least
                # (r-1)*cell away; skip deeper shells once every query is
                # settled (runtime branch per chunk)
                settled = carry[0] <= ((r - 1) * cell) ** 2
                carry = jax.lax.cond(
                    jnp.all(settled),
                    lambda c: c,
                    lambda c: probe(offs, c),
                    carry,
                )

        # residual spill (bucket overflow) — only for chunks that actually
        # probed a full bucket (exact: overflow belongs to probed full
        # buckets; unprobed cells are covered by the shell-distance bound)
        if residual_idx.shape[0] > 0:

            def spill(c):
                best_d2, best_i, any_full = c
                p = points[residual_idx]  # (n_res, 3)
                d = min_image(q[:, None, :] - p[None, :, :])
                d2 = (d * d).sum(-1)
                d2 = jnp.where(residual_idx[None, :] == m_pad - 1, jnp.inf, d2)
                j = jnp.argmin(d2, axis=1)
                ar = jnp.arange(chunk)
                better = d2[ar, j] < best_d2
                return (
                    jnp.where(better, d2[ar, j], best_d2),
                    jnp.where(better, residual_idx[j], best_i),
                    any_full,
                )

            carry = jax.lax.cond(carry[2], spill, lambda c: c, carry)
        carry = carry[:2]

        # dense fallback for queries still unsettled after R_CAP shells
        # (empty neighbourhoods — voids); runs per chunk only when needed
        def dense(carry):
            best_d2, best_i = carry
            pchunk = 4096
            n_pc = points.shape[0] // pchunk

            def body(c, carry):
                best_d2, best_i = carry
                p = jax.lax.dynamic_slice(points, (c * pchunk, 0), (pchunk, 3))
                d = min_image(q[:, None, :] - p[None, :, :])
                d2 = (d * d).sum(-1)
                gidx = c * pchunk + jnp.arange(pchunk)
                d2 = jnp.where(gidx[None, :] >= m_pad - 1, jnp.inf, d2)
                j = jnp.argmin(d2, axis=1)
                ar = jnp.arange(chunk)
                better = d2[ar, j] < best_d2
                return (
                    jnp.where(better, d2[ar, j], best_d2),
                    jnp.where(better, (c * pchunk + j).astype(jnp.int32), best_i),
                )

            return jax.lax.fori_loop(0, n_pc, body, carry)

        settled = carry[0] <= (_R_CAP * cell) ** 2
        carry = jax.lax.cond(jnp.all(settled), lambda c: c, dense, carry)
        return None, (carry[1], jnp.sqrt(carry[0]))

    _, (idx, dist) = jax.lax.scan(chunk_fn, None, queries.reshape(n_chunks, chunk, 3))
    return idx.reshape(-1), dist.reshape(-1)


def _build_cell_grid(queries, points_in, periodic_box, cap, chunk,
                     points_per_cell: float = 8.0):
    """Host-side one-pass grid build shared by the shell-walking queries.

    ``cap=None`` sizes the bucket from the occupancy tail (p99.9, pow2,
    <=128) so the residual spill stays tiny on clustered inputs.

    Returns (q_pad, pts_full, buckets, res_pad, geometry dict)."""
    m = points_in.shape[0]
    if periodic_box is not None:
        origin = (0.0, 0.0, 0.0)
        span = float(periodic_box)
        pts = np.mod(points_in, span)
        qs = np.mod(queries, span)
    else:
        lo = np.minimum(points_in.min(0), queries.min(0)) - 1e-4
        hi = np.maximum(points_in.max(0), queries.max(0)) + 1e-4
        origin = tuple(float(v) for v in lo)
        span = float((hi - lo).max())
        pts = points_in
        qs = queries

    g = int(np.clip(round((m / points_per_cell) ** (1 / 3)), 1, 128))
    cell = span / g

    cidx = np.floor((pts - np.asarray(origin, np.float32)) / cell).astype(np.int64)
    cidx = np.clip(cidx, 0, g - 1)
    flat = (cidx[:, 2] * g + cidx[:, 1]) * g + cidx[:, 0]
    order = np.argsort(flat, kind="stable")
    flat_sorted = flat[order]
    start = np.searchsorted(flat_sorted, np.arange(g**3))
    end = np.searchsorted(flat_sorted, np.arange(g**3), side="right")

    m_pad = m + 1  # sentinel row
    pts_pad = np.vstack([pts, np.full((1, 3), 1e30, np.float32)])
    counts = end - start
    if cap is None:
        # size the bucket to the occupancy tail: p99 keeps the residual
        # spill small while every chunk's probe width (scales with cap)
        # stays narrow — spilled chunks pay the conditional residual pass
        tail = int(np.percentile(counts[counts > 0], 99.0)) if m else 1
        cap = int(min(128, max(8, 2 ** int(np.ceil(np.log2(max(1, tail)))))))
    buckets = np.full((g**3, cap), m_pad - 1, np.int32)
    # vectorized bucket fill: rank of each (cell-sorted) point within its cell
    pos_in_cell = np.arange(m, dtype=np.int64) - start[flat_sorted]
    keep = pos_in_cell < cap
    buckets[flat_sorted[keep], pos_in_cell[keep]] = order[keep]
    residual = order[~keep].astype(np.int32)
    n_res_pad = 0 if residual.size == 0 else max(8, int(2 ** np.ceil(np.log2(residual.size))))
    res_pad = np.full(n_res_pad, m_pad - 1, np.int32)
    res_pad[: residual.size] = residual

    n = qs.shape[0]
    n_pad = max(chunk, ((n + chunk - 1) // chunk) * chunk)
    q_pad = np.zeros((n_pad, 3), np.float32)
    q_pad[:n] = qs
    # park padding queries on the first real point so they settle instantly
    q_pad[n:] = pts[0]

    # pad points to a multiple of the dense-fallback chunk
    pchunk = 4096
    m_full = max(pchunk, ((m_pad + pchunk - 1) // pchunk) * pchunk)
    pts_full = np.full((m_full, 3), 1e30, np.float32)
    pts_full[:m_pad] = pts_pad

    geom = dict(
        g=g, cell=float(cell), origin=origin, m_pad=m_pad,
        periodic=periodic_box is not None,
    )
    return q_pad, pts_full, buckets, res_pad, geom


def nearest_points_grid(
    queries,
    points,
    *,
    periodic_box: Optional[float] = None,
    chunk: int = _GRID_CHUNK,
    cap: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Shell-walking nearest-point query over an on-device cell grid.

    The device replacement for the reference's threaded KDTree
    (`_scripts/find_nearest_haloes.py:212-215`, SURVEY.md §2.8): points are
    bucketed into a cubic cell grid (host, one pass); each query chunk walks
    Chebyshev shells 0.._R_CAP (statically unrolled, runtime-skipped per
    chunk once every query's best distance proves no deeper shell can win),
    spilled bucket overflow rides one dense residual pass, and rare
    void-region chunks fall back to a dense sweep. O(N_query * shell
    candidates) instead of O(N_query * M).
    """
    queries = np.asarray(queries, np.float32)
    points_in = np.asarray(points, np.float32)
    if points_in.shape[0] == 0:
        raise ValueError("no points to query against")
    n = queries.shape[0]
    q_pad, pts_full, buckets, res_pad, geom = _build_cell_grid(
        queries, points_in, periodic_box, cap, chunk
    )
    idx, dist = _grid_query_impl(
        jnp.asarray(q_pad), jnp.asarray(pts_full), jnp.asarray(buckets),
        jnp.asarray(res_pad),
        cap=buckets.shape[1], chunk=chunk, **geom,
    )
    return np.asarray(idx[:n]).astype(np.int64), np.asarray(dist[:n])


_SPILL_BLOCK = 2048
_W_SENTINEL = np.float32(1e30)  # validity channel for padded bucket slots


@partial(
    jax.jit,
    static_argnames=("g", "cap", "chunk", "periodic", "cell", "origin", "k"),
)
def _knn_stage_impl(
    queries,  # (n_pad, 3)
    bucket_pts,  # (G_pad, cap, 4): [x, y, z, w] w=0 valid / 1e30 pad slot
    full_cells,  # (G_pad,) bool: bucket hit its cap (overflow in residual)
    *,
    g, cap, chunk, periodic, cell, origin, k,
):
    """One cascade stage: probe the 27-cell (r<=1) neighbourhood of each
    query on this stage's grid. Buckets hold point *coordinates* (not
    indices), so the probe gathers whole (cap, 4) cell rows — large-granule
    DMA instead of per-element random access — and the x axis is padded so
    each (dy, dz) row of the stencil is 3 physically consecutive rows.

    A query settles when its k-th best distance is <= one cell width: every
    unexplored point (Chebyshev cell distance >= 2) is at least that far.
    Queries whose own 27-cell stencil touched a capped bucket are flagged;
    they must merge the residual spill (a separate compact pass) before the
    settle test. Returns (best_d2 (n, k) ascending, q_full (n,) bool)."""
    n = queries.shape[0]
    n_chunks = n // chunk
    nx = g + 2
    box = g * cell

    def min_image(d):
        if periodic:
            return d - jnp.round(d / box) * box
        return d

    # (dy, dz) row offsets of the 3x3x3 stencil; x rides the padded axis
    offs = np.stack(
        np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), indexing="ij"), axis=-1
    ).reshape(-1, 2).astype(np.int32)  # (9, 2) [dy, dz]
    sentinel_base = g * g * nx

    def chunk_fn(_, q):  # q: (chunk, 3)
        ci = jnp.floor((q - jnp.asarray(origin)) / cell).astype(jnp.int32)
        ci = jnp.mod(ci, g) if periodic else jnp.clip(ci, 0, g - 1)
        cy = ci[:, 1, None] + offs[None, :, 0]  # (C, 9)
        cz = ci[:, 2, None] + offs[None, :, 1]
        if periodic:
            cy = jnp.mod(cy, g)
            cz = jnp.mod(cz, g)
            in_grid = jnp.ones(cy.shape, bool)
        else:
            in_grid = (cy >= 0) & (cy < g) & (cz >= 0) & (cz < g)
            cy = jnp.clip(cy, 0, g - 1)
            cz = jnp.clip(cz, 0, g - 1)
        # padded-x layout: row (z, y) starts at (z*g + y)*nx; column cx+1
        # holds real cell cx, so the dx=-1..1 run begins at column cx
        base = (cz * g + cy) * nx + ci[:, 0, None]  # (C, 9)
        base = jnp.where(in_grid, base, sentinel_base)
        rows = base[..., None] + jnp.arange(3, dtype=jnp.int32)  # (C, 9, 3)
        p = bucket_pts[rows]  # (C, 9, 3, cap, 4) — (cap,4)-row gathers
        q_full = full_cells[rows].any(axis=(1, 2))  # (C,) per-query flag
        d = min_image(q[:, None, None, None, :] - p[..., :3])
        d2 = (d * d).sum(-1) + p[..., 3]  # + w: pad slots ride to ~1e30
        best_d2 = -jax.lax.top_k(-d2.reshape(chunk, -1), k)[0]
        return None, (best_d2, q_full)

    _, (best_d2, q_full) = jax.lax.scan(
        chunk_fn, None, queries.reshape(n_chunks, chunk, 3)
    )
    return best_d2.reshape(-1, k), q_full.reshape(-1)


@partial(jax.jit, static_argnames=("chunk", "periodic", "box", "k"))
def _knn_spill_impl(
    q_spill,  # (n_spill_pad, 3)
    d2_in,  # (n_spill_pad, k) carried best lists from the stage probe
    residual_pts,  # (n_res_pad, 4): [x,y,z,w] — w is 1e30 on pad rows
    *,
    chunk, periodic, box, k,
):
    """Compact residual pass: merge the bucket-overflow points into the
    k-lists of the (few) queries whose own stencil hit a capped bucket.
    The overflow is carried as coordinates, so blocks are contiguous
    dynamic slices — no gather at all."""
    n = q_spill.shape[0]
    n_chunks = n // chunk
    n_blk = residual_pts.shape[0] // _SPILL_BLOCK

    def min_image(d):
        if periodic:
            return d - jnp.round(d / box) * box
        return d

    def chunk_fn(_, qb):
        q, best_d2 = qb

        def body(b, best_d2):
            p = jax.lax.dynamic_slice(
                residual_pts, (b * _SPILL_BLOCK, 0), (_SPILL_BLOCK, 4)
            )
            d = min_image(q[:, None, :] - p[None, :, :3])
            d2 = (d * d).sum(-1) + p[None, :, 3]
            alld2 = jnp.concatenate([best_d2, d2], axis=1)
            return -jax.lax.top_k(-alld2, k)[0]

        return None, jax.lax.fori_loop(0, n_blk, body, best_d2)

    _, out = jax.lax.scan(
        chunk_fn,
        None,
        (q_spill.reshape(n_chunks, chunk, 3), d2_in.reshape(n_chunks, chunk, k)),
    )
    return out.reshape(-1, k)


def _bucketize_coords(pts, g, cap, cell, origin, periodic):
    """Host bucket build: padded-x coordinate buckets for one stage grid.

    Returns (bucket_pts (G_pad, cap, 4) f32, full_cells (G_pad,) bool,
    residual point indices (unpadded))."""
    m = pts.shape[0]
    cidx = np.floor((pts - np.asarray(origin, np.float32)) / cell).astype(np.int64)
    cidx = np.clip(cidx, 0, g - 1)
    flat = (cidx[:, 2] * g + cidx[:, 1]) * g + cidx[:, 0]
    order = np.argsort(flat, kind="stable")
    flat_sorted = flat[order]
    start = np.searchsorted(flat_sorted, flat_sorted)  # first of each run
    pos_in_cell = np.arange(m, dtype=np.int64) - start
    keep = pos_in_cell < cap
    bucket = np.zeros((g**3, cap, 4), np.float32)
    bucket[..., 3] = _W_SENTINEL
    bucket[flat_sorted[keep], pos_in_cell[keep], :3] = pts[order[keep]]
    bucket[flat_sorted[keep], pos_in_cell[keep], 3] = 0.0
    counts = np.bincount(flat, minlength=g**3)
    full = counts >= cap

    # pad x: column 0 <- cell x=g-1 (periodic) or empty; column g+1 <- x=0
    nx = g + 2
    b3 = bucket.reshape(g * g, g, cap, 4)
    f3 = full.reshape(g * g, g)
    bp = np.zeros((g * g, nx, cap, 4), np.float32)
    bp[..., 3] = _W_SENTINEL
    fp = np.zeros((g * g, nx), bool)
    bp[:, 1 : g + 1] = b3
    fp[:, 1 : g + 1] = f3
    if periodic:
        bp[:, 0] = b3[:, g - 1]
        bp[:, g + 1] = b3[:, 0]
        fp[:, 0] = f3[:, g - 1]
        fp[:, g + 1] = f3[:, 0]
    # 3 sentinel cells at the end: off-grid stencil rows land here
    bucket_pts = np.concatenate(
        [bp.reshape(-1, cap, 4),
         np.concatenate([np.zeros((3, cap, 3), np.float32),
                         np.full((3, cap, 1), _W_SENTINEL)], axis=-1)]
    )
    full_cells = np.concatenate([fp.reshape(-1), np.zeros(3, bool)])
    residual = order[~keep].astype(np.int32)
    return bucket_pts, full_cells, residual


def _quantize_pad(n: int, chunk: int) -> int:
    """Round n up to {1, 1.5} x 2^a chunks: bounds the set of compiled
    scan lengths (~2 shapes per octave) at <= 50% padded compute."""
    n_chunks = max(1, -(-n // chunk))
    c = 1
    while c < n_chunks:
        if c >= 2 and (c * 3) // 2 >= n_chunks:
            c = (c * 3) // 2
            break
        c *= 2
    return c * chunk


def knn_distances_grid(
    queries,
    points,
    k: int,
    *,
    periodic_box: Optional[float] = None,
    chunk: int = 256,
    cap: int = 64,
    max_stages: int = 4,
) -> np.ndarray:
    """Distances to the k nearest points (ascending) via a fine-to-coarse
    cell-grid cascade — the at-scale device path for SWIFT dark-matter
    smoothing lengths (`_SnapshotSWIFT.py:58-85`: 32-NN distance), where the
    dense :func:`knn_distances` is O(N*M).

    Each stage probes only the 27-cell neighbourhood of its grid: buckets
    hold point *coordinates* with a validity channel, padded along x so the
    3x3x3 stencil is 9 runs of 3 physically-consecutive rows — large-granule
    DMA, no per-element gathers — followed by one ``top_k`` merge per query
    chunk. Queries whose k-th best distance fits inside one cell width are
    exact and exit; queries whose own stencil touched a capped bucket first
    merge the overflow in a compact spill pass; the remainder —
    sparse-region queries whose neighbourhood held fewer than k points —
    continue on an adaptively coarser grid (sized from the unsettled
    queries' k-th-distance upper bounds), and stragglers after the last
    stage take a dense sweep. Query chunks are processed in cell-sorted
    order so spill flags stay confined to the clustered chunks. The stage-1
    grid is sized so the occupancy tail fits the bucket cap: dense clusters
    settle immediately, which is what defeats tree-based queries' worst
    case on an accelerator.

    Exact: matches ``scipy.spatial.KDTree.query(k=k)`` distances (to f32).
    """
    queries = np.asarray(queries, np.float32)
    points_in = np.asarray(points, np.float32)
    m = points_in.shape[0]
    if m == 0:
        raise ValueError("no points to query against")
    if k > m:
        raise ValueError(f"k={k} exceeds the number of points ({m})")
    n = queries.shape[0]
    if m <= 8192:
        return knn_distances(queries, points_in, k, periodic_box=periodic_box)

    if periodic_box is not None:
        origin = (0.0, 0.0, 0.0)
        span = float(periodic_box)
        pts = np.mod(points_in, span)
        qs = np.mod(queries, span)
    else:
        lo = np.minimum(points_in.min(0), queries.min(0)) - 1e-4
        hi = np.maximum(points_in.max(0), queries.max(0)) + 1e-4
        origin = tuple(float(v) for v in lo)
        span = float((hi - lo).max())
        pts = points_in
        qs = queries

    periodic = periodic_box is not None

    # stage-1 grid: start at ~cap/4 mean occupancy, then refine until the
    # p99 occupancy tail fits the bucket (clusters resolved into many cells)
    g = int(np.clip(round((m / (cap / 4)) ** (1 / 3)), 3, 192))
    org = np.asarray(origin, np.float32)
    for _ in range(3):
        cell = span / g
        cidx = np.clip(np.floor((pts - org) / cell).astype(np.int64), 0, g - 1)
        flat = (cidx[:, 2] * g + cidx[:, 1]) * g + cidx[:, 0]
        counts = np.bincount(flat, minlength=g**3)
        p99 = np.percentile(counts[counts > 0], 99.0)
        if p99 <= cap or g >= 192:
            break
        g = int(np.clip(round(g * (p99 / cap) ** (1 / 3)), g + 1, 192))

    qs_dev = jnp.asarray(qs)  # one upload; stages compact via index take
    out = np.empty((n, k), np.float32)
    active = np.arange(n)
    for _ in range(max_stages):
        if g < 3 or active.size == 0:  # g<3: periodic 27-stencil would wrap
            break  # onto duplicate cells (duplicates corrupt a k-list)
        cell = span / g
        bucket_pts, full_cells, residual = _bucketize_coords(
            pts, g, cap, cell, origin, periodic
        )
        # cell-sort the active queries: chunks become spatially coherent, so
        # spill flags stay confined to the queries inside clusters
        qa = qs[active]
        qi = np.clip(np.floor((qa - org) / cell).astype(np.int64), 0, g - 1)
        qflat = (qi[:, 2] * g + qi[:, 1]) * g + qi[:, 0]
        qord = np.argsort(qflat, kind="stable")
        idx = active[qord].astype(np.int32)
        na = idx.shape[0]
        n_pad = _quantize_pad(na, chunk)
        idx_pad = np.full(n_pad, idx[0], np.int32)  # pad on a real query:
        idx_pad[:na] = idx  # wastes a little compute, rows dropped below
        q_act = jnp.take(qs_dev, jnp.asarray(idx_pad), axis=0)
        d2, q_full = _knn_stage_impl(
            q_act, jnp.asarray(bucket_pts), jnp.asarray(full_cells),
            g=g, cap=cap, chunk=chunk, periodic=periodic,
            cell=float(cell), origin=origin, k=k,
        )
        kth2 = np.array(d2[:, -1])[:na]
        full = np.asarray(q_full)[:na] if residual.size else np.zeros(na, bool)
        cell2 = np.float32(cell) * np.float32(cell)
        d2_sp = None
        flag_pos = np.zeros(0, np.int64)
        if full.any():
            # compact spill: only flagged queries meet the bucket-overflow
            # coordinates (exact: overflow of unprobed cells is covered by
            # the shell-distance settle bound)
            n_res = ((residual.size + _SPILL_BLOCK - 1) // _SPILL_BLOCK) * _SPILL_BLOCK
            res_pts = np.zeros((n_res, 4), np.float32)
            res_pts[: residual.size, :3] = pts[residual]
            res_pts[residual.size :, 3] = _W_SENTINEL
            flag_pos = np.nonzero(full)[0]
            nf = flag_pos.shape[0]
            nf_pad = _quantize_pad(nf, chunk)
            fp_pad = np.full(nf_pad, flag_pos[0], np.int64)
            fp_pad[:nf] = flag_pos
            fp_dev = jnp.asarray(fp_pad.astype(np.int32))
            d2_sp = _knn_spill_impl(
                jnp.take(q_act, fp_dev, axis=0), jnp.take(d2, fp_dev, axis=0),
                jnp.asarray(res_pts),
                chunk=chunk, periodic=periodic, box=float(span), k=k,
            )
            kth2[flag_pos] = np.array(d2_sp[:, -1])[:nf]
        settled = kth2 <= cell2
        # pull full k-lists only for the queries that settle this stage
        set_pos = np.nonzero(settled)[0]
        if set_pos.size:
            rows = np.sqrt(np.asarray(jnp.take(
                d2, jnp.asarray(set_pos.astype(np.int32)), axis=0)))
            if flag_pos.size:
                # flagged & settled rows come from the spill output instead
                in_flag = np.isin(set_pos, flag_pos, assume_unique=True)
                if in_flag.any():
                    sp_rows = np.searchsorted(flag_pos, set_pos[in_flag])
                    rows[in_flag] = np.sqrt(np.asarray(jnp.take(
                        d2_sp, jnp.asarray(sp_rows.astype(np.int32)), axis=0)))
            out[idx[set_pos]] = rows
        active = idx[~settled].astype(np.int64)
        # next stage: coarsen to the cell width that would settle ~80% of
        # the remaining queries (their current k-th distances are upper
        # bounds, so settling on the bound implies settling on the truth)
        kth = np.sqrt(kth2[~settled])
        finite = kth[kth < 1e14]
        if finite.size:
            cell_next = float(np.percentile(finite, 80.0))
            g = max(3, min(g - 1, int(span / max(cell_next, 1e-30))))
        else:
            g //= 2

    if active.size:
        out[active] = knn_distances(
            qs[active], pts, k, periodic_box=periodic_box
        )
    return out
