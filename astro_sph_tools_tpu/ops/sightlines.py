"""Sightline integration: ray x particle SPH kernel integrals (config 4).

BASELINE config 4: "Line-of-sight absorption sightlines: 1e4 rays through a
snapshot with per-ray SPH kernel integration (SpecWizard-style)". The
reference ships LOS *file readers* but no integration engine; this module
supplies it, device-side:

- :func:`column_integrate` — per-ray column totals
  ``sum_i q_i * Y(b_i, h_i)`` with ``b`` the ray-particle impact parameter
  and ``Y`` the line-integrated kernel LUT (physical column densities), or
  the 3D-kernel-at-projected-radius convention
  (`tools/projections/_pixel_calculations.pyx:32-34`) for parity with maps.
- :func:`los_profiles` — per-ray 1-D profiles along the LOS axis, sampling
  the 3D kernel at the true 3D distance of each bin point (the map
  semantics extended to rays), e.g. density/temperature/velocity runs for
  absorption-spectrum synthesis.

Execution — two engines:

- :func:`column_integrate` (dense): a ``lax.scan`` over particle chunks
  evaluating dense (rays, chunk) blocks — O(R * N), the portable
  oracle.
- :func:`column_integrate_binned` (production): particles are partitioned
  into footprint levels and cell-sorted per level (cell size >= the level's
  max support, so a ray's candidates live in its own + 1-ring cells); rays
  are cell-sorted too and processed in blocks, each block scanning only the
  contiguous cell-row span covering its 1-ring neighbourhood — O(R *
  N_local). This is the deposit engine's tile-binned architecture applied to
  scattered sample points, replacing the dense sweep that wedged the device
  at the 1e4-ray x 1e7-particle BASELINE config-4 scale.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.splines import (
    get_kernel,
    integrated_kernel_lookup,
    integrated_kernel_table,
)

Array = jax.Array

_DEF_CHUNK = 2048


def _pad_chunk(arrays, chunk, h_index):
    n = arrays[0].shape[0]
    n_pad = max(chunk, ((n + chunk - 1) // chunk) * chunk)
    out = []
    for i, a in enumerate(arrays):
        fill = 1.0 if i == h_index else 0.0
        pad = [(0, n_pad - n)] + [(0, 0)] * (a.ndim - 1)
        out.append(jnp.asarray(np.pad(np.asarray(a), pad, constant_values=fill), jnp.float32))
    return out


_RAY_TILE = 1024


@partial(jax.jit, static_argnames=("kernel_name", "projection", "chunk", "periodic_box"))
def _column_integrate_impl(
    px, py, h, values, ray_x, ray_y, lut,
    *, kernel_name, projection, chunk, periodic_box,
):
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    n_chunks = px.shape[0] // chunk
    reshape = lambda a: a.reshape(n_chunks, chunk, *a.shape[1:])
    # rays are tiled too: an unbounded (R, C) block at 1e4 rays x 8k chunk
    # is multi-GB of fused intermediates — enough to OOM-crash the device
    n_ray_tiles = ray_x.shape[0] // _RAY_TILE
    rx_t = ray_x.reshape(n_ray_tiles, _RAY_TILE)
    ry_t = ray_y.reshape(n_ray_tiles, _RAY_TILE)
    totals0 = jnp.zeros((values.shape[1], n_ray_tiles, _RAY_TILE), jnp.float32)

    def body(tot, inputs):
        cx, cy, ch, cv = inputs

        def ray_tile(rt, tot):
            dx = rx_t[rt][:, None] - cx[None, :]
            dy = ry_t[rt][:, None] - cy[None, :]
            if periodic_box is not None:
                box = periodic_box
                dx = dx - jnp.round(dx / box) * box
                dy = dy - jnp.round(dy / box) * box
            b2 = dx * dx + dy * dy  # (RT, C)
            b = jnp.sqrt(b2)
            if projection == "integrated":
                w = integrated_kernel_lookup(lut, b, ch[None, :], S)
            else:
                w = kernel.w(b, ch[None, :])
            w = jnp.where(b2 < (S * ch[None, :]) ** 2, w, 0.0)
            # (F, RT) += (F, C) @ (C, RT)
            return tot.at[:, rt, :].add(jnp.einsum(
                "cf,rc->fr", cv, w, precision=jax.lax.Precision.HIGHEST
            ))

        tot = jax.lax.fori_loop(0, n_ray_tiles, ray_tile, tot)
        return tot, None

    totals, _ = jax.lax.scan(
        body, totals0, (reshape(px), reshape(py), reshape(h), reshape(values))
    )
    return totals.reshape(values.shape[1], -1)


# Bounds on the work handed to one XLA program invocation. The dense ray
# sweep is compute-heavy, so both the particle axis and the ray axis are
# macro-batched at the Python level (per program: <= _MACRO_BATCH x
# _RAY_MACRO pair evaluations) to keep each program's run and memory
# bounded.
_MACRO_BATCH = 1 << 19
_RAY_MACRO = 2048


def column_integrate(
    x, y, h, values, ray_x, ray_y,
    *,
    kernel: str = "cubic_spline",
    projection: str = "integrated",
    chunk: int = _DEF_CHUNK,
    periodic_box: Optional[float] = None,
) -> Array:
    """Per-ray column totals over all particles.

    ``values`` (N,) or (N, F); returns (R,) or (F, R). With
    ``projection='integrated'`` and values = masses the result is the
    physical column density (mass / area); ``'kernel3d'`` reproduces the
    reference map convention.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    h = np.asarray(h)
    values = np.asarray(values)
    single = values.ndim == 1
    if single:
        values = values[:, None]
    lut = (
        jnp.asarray(integrated_kernel_table(kernel), jnp.float32)
        if projection == "integrated"
        else jnp.zeros(2, jnp.float32)
    )
    # pad rays to a tile multiple (padding rays are discarded afterwards)
    n_rays = np.asarray(ray_x).shape[0]
    n_ray_pad = max(_RAY_TILE, ((n_rays + _RAY_TILE - 1) // _RAY_TILE) * _RAY_TILE)
    rx = jnp.asarray(np.pad(np.asarray(ray_x, np.float32), (0, n_ray_pad - n_rays)))
    ry = jnp.asarray(np.pad(np.asarray(ray_y, np.float32), (0, n_ray_pad - n_rays)))

    n = x.shape[0]
    ray_blocks = []
    for r0 in range(0, n_ray_pad, _RAY_MACRO):
        r1 = min(r0 + _RAY_MACRO, n_ray_pad)
        block_totals = None
        for start in range(0, max(n, 1), _MACRO_BATCH):
            stop = min(start + _MACRO_BATCH, n)
            px, py, hh, vv = _pad_chunk(
                [x[start:stop], y[start:stop], h[start:stop], values[start:stop]],
                chunk, h_index=2,
            )
            part = _column_integrate_impl(
                px, py, hh, vv, rx[r0:r1], ry[r0:r1], lut,
                kernel_name=kernel, projection=projection, chunk=chunk,
                periodic_box=periodic_box,
            )
            block_totals = part if block_totals is None else block_totals + part
        ray_blocks.append(block_totals)
    totals = jnp.concatenate(ray_blocks, axis=1)[:, :n_rays]
    return totals[0] if single else totals


@partial(
    jax.jit,
    static_argnames=("kernel_name", "chunk", "n_bins", "periodic_box"),
)
def _los_profiles_impl(
    px, py, pz, h, values, ray_x, ray_y, z_edges,
    *, kernel_name, chunk, n_bins, periodic_box,
):
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    n_chunks = px.shape[0] // chunk
    reshape = lambda a: a.reshape(n_chunks, chunk, *a.shape[1:])
    R = ray_x.shape[0]
    F = values.shape[1]
    z_centres = 0.5 * (z_edges[:-1] + z_edges[1:])  # (B,)
    prof0 = jnp.zeros((F, R, n_bins), jnp.float32)

    def body(prof, inputs):
        cx, cy, cz, ch, cv = inputs
        dx = ray_x[:, None] - cx[None, :]
        dy = ray_y[:, None] - cy[None, :]
        if periodic_box is not None:
            box = periodic_box
            dx = dx - jnp.round(dx / box) * box
            dy = dy - jnp.round(dy / box) * box
        b2 = dx * dx + dy * dy  # (R, C)
        dz = z_centres[:, None] - cz[None, :]  # (B, C)
        if periodic_box is not None:
            dz = dz - jnp.round(dz / periodic_box) * periodic_box
        r2 = b2[:, None, :] + (dz * dz)[None, :, :]  # (R, B, C)
        w = kernel.w(jnp.sqrt(r2), ch[None, None, :])
        w = jnp.where(r2 < (S * ch[None, None, :]) ** 2, w, 0.0)
        prof = prof + jnp.einsum(
            "cf,rbc->frb", cv, w, precision=jax.lax.Precision.HIGHEST
        )
        return prof, None

    prof, _ = jax.lax.scan(
        body, prof0, (reshape(px), reshape(py), reshape(pz), reshape(h), reshape(values))
    )
    return prof


def los_profiles(
    pos, h, values, ray_x, ray_y,
    *,
    z_range: tuple[float, float],
    n_bins: int,
    kernel: str = "cubic_spline",
    chunk: int = 512,
    periodic_box: Optional[float] = None,
) -> Array:
    """1-D field profiles along each ray (projection axis = z; pre-rotate
    positions for other axes via ``CoordinateAxes.projection_plane``).

    Returns (R, B) for single-field input, else (F, R, B): the 3D kernel
    evaluated at each bin sample point, i.e. ``profile[r, b] = sum_i q_i *
    W(|ray_point_rb - pos_i|, h_i)`` — density-run semantics matching the
    map engine; divide weighted fields by a mass profile for averages.
    """
    pos = np.asarray(pos)
    values = np.asarray(values)
    single = values.ndim == 1
    if single:
        values = values[:, None]
    z_edges = jnp.linspace(z_range[0], z_range[1], n_bins + 1)
    px, py, pz, hh, vv = _pad_chunk(
        [pos[:, 0], pos[:, 1], pos[:, 2], h, values], chunk, h_index=3
    )
    prof = _los_profiles_impl(
        px, py, pz, hh, vv,
        jnp.asarray(ray_x, jnp.float32), jnp.asarray(ray_y, jnp.float32), z_edges,
        kernel_name=kernel, chunk=chunk, n_bins=n_bins, periodic_box=periodic_box,
    )
    return prof[0] if single else prof


# ---------------------------------------------------------------------------
# Tile-binned engine (BASELINE config 4 at scale)
# ---------------------------------------------------------------------------

_BLOCK_RAYS = 128
_BIN_CHUNK = 1024
_MAX_BIN_LEVELS = 6


@partial(
    jax.jit,
    static_argnames=(
        "kernel_name", "projection", "chunk", "n_blocks", "B",
        "ncx", "ncy", "periodic", "n_pad",
    ),
)
def _binned_columns_impl(
    px, py, h, values,  # cell-sorted particles, padded to n_pad
    row_start, row_end,  # (ncy,) particle ranges per cell-grid row
    rx, ry, ray_row,  # cell-sorted rays (padded to n_blocks*B) + their rows
    lut, box,  # box: (2,) [Lx, Ly] world box for min-image (ignored if not periodic)
    *,
    kernel_name, projection, chunk, n_blocks, B, ncx, ncy, periodic, n_pad,
):
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    F = values.shape[1]
    n_chunk_rows = n_pad // chunk

    def block_fn(_, b):
        r0 = ray_row[b * B]
        r1 = ray_row[b * B + B - 1]
        rxb = jax.lax.dynamic_slice(rx, (b * B,), (B,))
        ryb = jax.lax.dynamic_slice(ry, (b * B,), (B,))

        # main span: rows [r0-1, r1+1] clamped; periodic y-wrap rows ride a
        # second (usually empty) span
        lo_r = jnp.maximum(r0 - 1, 0)
        hi_r = jnp.minimum(r1 + 1, ncy - 1)
        loA = row_start[lo_r]
        hiA = row_end[hi_r]
        if periodic:
            # wrap spans only when the wrapped row is not already inside the
            # clamped main span (coarse grids: r1 + 1 can reach ncy - 1)
            need_top = (r0 == 0) & (r1 + 1 < ncy - 1)  # wrap to last row
            need_bot = (r1 == ncy - 1) & (r0 - 1 > 0)  # wrap to first row
            loB = jnp.where(need_top, row_start[ncy - 1], 0)
            hiB = jnp.where(need_top, row_end[ncy - 1], 0)
            loC = jnp.where(need_bot, row_start[0], 0)
            hiC = jnp.where(need_bot, row_end[0], 0)
        else:
            loB = hiB = loC = hiC = jnp.int32(0)

        def range_sum(tot, lo, hi):
            c0 = lo // chunk
            c1 = jnp.minimum((hi + chunk - 1) // chunk, n_chunk_rows)

            def inner(c, tot):
                g0 = c * chunk
                xs = jax.lax.dynamic_slice(px, (g0,), (chunk,))
                ys = jax.lax.dynamic_slice(py, (g0,), (chunk,))
                hs = jax.lax.dynamic_slice(h, (g0,), (chunk,))
                vs = jax.lax.dynamic_slice(values, (g0, 0), (chunk, F))
                gidx = g0 + jax.lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)[:, 0]
                live = (gidx >= lo) & (gidx < hi)
                dx = rxb[:, None] - xs[None, :]
                dy = ryb[:, None] - ys[None, :]
                if periodic:
                    dx = dx - jnp.round(dx / box[0]) * box[0]
                    dy = dy - jnp.round(dy / box[1]) * box[1]
                b2 = dx * dx + dy * dy  # (B, C)
                bb = jnp.sqrt(b2)
                if projection == "integrated":
                    w = integrated_kernel_lookup(lut, bb, hs[None, :], S)
                else:
                    w = kernel.w(bb, hs[None, :])
                w = jnp.where(
                    live[None, :] & (b2 < (S * hs[None, :]) ** 2), w, 0.0
                )
                # HIGHEST: a GPU f32 einsum may otherwise run in TF32
                return tot + jnp.einsum(
                    "cf,rc->fr", vs, w, precision=jax.lax.Precision.HIGHEST
                )

            return jax.lax.fori_loop(c0, c1, inner, tot)

        tot = jnp.zeros((F, B), jnp.float32)
        tot = range_sum(tot, loA, hiA)
        if periodic:
            tot = range_sum(tot, loB, hiB)
            tot = range_sum(tot, loC, hiC)
        return None, tot

    _, totals = jax.lax.scan(block_fn, None, jnp.arange(n_blocks, dtype=jnp.int32))
    return totals.transpose(1, 0, 2).reshape(F, n_blocks * B)


def column_integrate_binned(
    x, y, h, values, ray_x, ray_y,
    *,
    kernel: str = "cubic_spline",
    projection: str = "integrated",
    periodic_box: Optional[float] = None,
    chunk: int = _BIN_CHUNK,
    ray_block: int = _BLOCK_RAYS,
) -> Array:
    """Cell-binned per-ray column totals — the production sightline engine.

    Same result as :func:`column_integrate` (tested to 1e-5) at O(R *
    N_local): particles are split into footprint levels (support halving per
    level), cell-sorted per level with cell size >= the level's max support,
    and each block of ``ray_block`` cell-sorted rays scans only the
    contiguous particle span of its 1-ring cell rows. Handles BASELINE
    config 4 (1e4 rays x 1e7 particles) on one chip.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    h = np.asarray(h, np.float32)
    values = np.asarray(values, np.float32)
    single = values.ndim == 1
    if single:
        values = values[:, None]
    kspec = get_kernel(kernel)
    lut = (
        jnp.asarray(integrated_kernel_table(kernel), jnp.float32)
        if projection == "integrated"
        else jnp.zeros(2, jnp.float32)
    )

    n_rays = np.asarray(ray_x).shape[0]
    rays = np.stack([np.asarray(ray_x, np.float64), np.asarray(ray_y, np.float64)])

    # domain: the periodic box, or the bounding box of everything + support
    s = kspec.support_factor * h.astype(np.float64)
    if periodic_box is not None:
        x0 = y0 = 0.0
        Lx = Ly = float(periodic_box)
        x = np.mod(x, Lx)
        y = np.mod(y, Ly)
        rays = np.mod(rays, Lx)
    else:
        pad = float(s.max()) if s.size else 1.0
        x0 = min(x.min() if x.size else 0.0, rays[0].min()) - pad
        y0 = min(y.min() if y.size else 0.0, rays[1].min()) - pad
        Lx = max(x.max() if x.size else 1.0, rays[0].max()) + pad - x0
        Ly = max(y.max() if y.size else 1.0, rays[1].max()) + pad - y0

    # footprint levels: support halving, largest first
    s_max = float(s.max()) if s.size else 1.0
    level = np.zeros(x.shape[0], np.int64)
    if s.size:
        with np.errstate(divide="ignore"):
            level = np.floor(np.log2(s_max / np.maximum(s, 1e-30))).astype(np.int64)
        level = np.clip(level, 0, _MAX_BIN_LEVELS - 1)

    totals = jnp.zeros((values.shape[1], n_rays), jnp.float32)
    for li in range(_MAX_BIN_LEVELS):
        sel = np.nonzero(level == li)[0]
        if sel.size == 0:
            continue
        cell = s_max / (1 << li)  # >= this level's max support
        ncx = max(1, int(Lx / cell))
        ncy = max(1, int(Ly / cell))
        # cap the grid so row spans stay meaningful and row tables small
        ncx, ncy = min(ncx, 4096), min(ncy, 4096)
        cx = np.clip(((x[sel] - x0) / (Lx / ncx)).astype(np.int64), 0, ncx - 1)
        cy = np.clip(((y[sel] - y0) / (Ly / ncy)).astype(np.int64), 0, ncy - 1)
        cid = cy * ncx + cx
        order = np.argsort(cid, kind="stable")
        sel = sel[order]
        cid = cid[order]
        n = sel.size
        n_pad = max(chunk, ((n + chunk - 1) // chunk) * chunk)
        pxp = np.zeros(n_pad, np.float32); pxp[:n] = x[sel]
        pyp = np.zeros(n_pad, np.float32); pyp[:n] = y[sel]
        hp = np.ones(n_pad, np.float32); hp[:n] = h[sel]
        vp = np.zeros((n_pad, values.shape[1]), np.float32); vp[:n] = values[sel]
        # per-row particle ranges (padding sits beyond the last row's end)
        row_start = np.searchsorted(cid, np.arange(ncy, dtype=np.int64) * ncx).astype(np.int32)
        row_end = np.searchsorted(cid, (np.arange(ncy, dtype=np.int64) + 1) * ncx).astype(np.int32)

        # rays on the same grid, sorted, blocked
        rcx = np.clip(((rays[0] - x0) / (Lx / ncx)).astype(np.int64), 0, ncx - 1)
        rcy = np.clip(((rays[1] - y0) / (Ly / ncy)).astype(np.int64), 0, ncy - 1)
        rorder = np.argsort(rcy * ncx + rcx, kind="stable")
        B = ray_block
        r_pad = max(B, ((n_rays + B - 1) // B) * B)
        rxp = np.full(r_pad, rays[0][rorder[-1]], np.float32)
        ryp = np.full(r_pad, rays[1][rorder[-1]], np.float32)
        rxp[:n_rays] = rays[0][rorder]
        ryp[:n_rays] = rays[1][rorder]
        rrow = np.full(r_pad, rcy[rorder[-1]], np.int32)
        rrow[:n_rays] = rcy[rorder].astype(np.int32)

        part = _binned_columns_impl(
            jnp.asarray(pxp), jnp.asarray(pyp), jnp.asarray(hp), jnp.asarray(vp),
            jnp.asarray(row_start), jnp.asarray(row_end),
            jnp.asarray(rxp), jnp.asarray(ryp), jnp.asarray(rrow),
            lut, jnp.asarray([Lx, Ly], jnp.float32),
            kernel_name=kernel, projection=projection, chunk=chunk,
            n_blocks=r_pad // B, B=B, ncx=ncx, ncy=ncy,
            periodic=periodic_box is not None, n_pad=n_pad,
        )
        # unsort ray results back to caller order
        inv = np.empty(n_rays, np.int64)
        inv[rorder] = np.arange(n_rays)
        totals = totals + jnp.asarray(np.asarray(part)[:, :n_rays][:, inv])

    return totals[0] if single else totals
