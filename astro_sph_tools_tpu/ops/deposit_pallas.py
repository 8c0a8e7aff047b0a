"""Adaptive-h 2D deposit: tile-sorted layout + fused per-tile deposit kernels.

The north-star inner loop (1024^2 multi-field maps of 1e8+ particles):

1. **Bin**: particles are assigned a footprint level (by ``support_factor *
   h`` in pixels) and, under that level's geometry, an image tile (TY x TX
   pixels) by their *center*; no duplication. Footprint spill into
   neighbouring tiles is captured by a margin M = K/2 on every side of the
   tile's extended accumulator (R = TY + K rows by S = TX + K columns).
2. **Sort**: one ``lax.sort`` on the composite (level, tile) key with the
   payloads riding along — amortised across every field of the map stack.
3. **Deposit** each level, by one of two routes chosen from the platform
   (:func:`_use_kernel`):

   - *GPU*: two Pallas kernels compiled through Triton. In the first, one
     program owns one unit — at most ``_UNIT`` consecutive particles of
     one tile — and one band of RB <= 32 accumulator rows. It loops over
     the unit in chunks of C, evaluating the SPH kernel on the (RB rows) x
     (K columns) x (C particles) footprint block and *placing* each column
     offset k with a one-hot matmul on the tensor cores:
     ``acc[f] (RB, S) += W_k[f] (RB, C) @ P_k (C, S)``,
     ``P_k[c, s] = [s == col0(c) + k]``. The one-hot is exact in bf16, so
     the weights ride as three bf16 limbs (hi + two residuals, ~2^-24
     relative) and the map holds the 1e-5 fidelity budget. The band lives
     in registers and is written once, to the unit's own slot. In the
     second, one program per (tile, band) sums the tile's units in unit
     order. No state passes between the programs of a kernel, so blocks
     run in any order, and no sum depends on that order: the map is
     bitwise reproducible (``utils.determinism``).
   - *CPU*: the same layout feeds XLA's scatter-add — the K x K stencil
     pass of :mod:`.deposit`, evaluated in each particle's tile-local frame.

4. **Overlap-add**: extended tiles are summed into the image with nine
   static-sliced band adds (regular memory movement, no scatter).

Numerics match `tools/projections/_pixel_calculations.pyx:9-36` (3D kernel at
projected 2D radius, ``r^2 < (S_f h)^2`` mask), with the same pixel
conventions as ``ops.deposit``. Up to 5 fields ride one pass.

Tile-local coordinates: a particle's position is stored relative to the
centre of its own tile's extended accumulator (magnitude <= K/2). Global
pixel coordinates at 1024^2 carry ~6e-5 px of f32 rounding — enough to bust
the 1e-5 budget for sub-pixel smoothing lengths — so f64 host inputs are
converted to local coordinates in f64 before the f32 cast. Centring them
keeps that cast's rounding at ~2^-24 K px: a particle with h = 0.02 px
sits at a pixel's sample point to ~1e-5 of h.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..kernels.splines import (
    clenshaw,
    get_kernel,
    integrated_kernel_chebyshev,
    integrated_kernel_table,
)
from .deposit import MapSpec, _stencil_scan

Array = jax.Array

# Particle-count granularity of the layout: level buckets and padded inputs
# are multiples of this, so the XLA route's power-of-two stencil chunks
# always divide a bucket.
_ALIGN = 2048
# Most particles one kernel program deposits. A dense tile splits into
# several units that run on different SMs; their extended tiles are summed
# in unit order.
_UNIT = 8192
# Stencil chunk of the XLA route at K=8 (scaled by 64 / K^2 above that).
_XLA_CHUNK = 32 * 1024
# Trailing slots the kernel's particle arrays carry past the last real
# particle (>= every level's chunk C), so a masked chunk load never reads
# out of bounds — in the interpreter, whose loads are clamped slices, too.
_KERNEL_SLACK = 128


@dataclass(frozen=True)
class PallasDepositConfig:
    """Static geometry of one footprint level.

    Tiles are K x K output pixels, so the extended accumulator is 2K x 2K —
    powers of two, as Triton's register tiles require. A kernel program
    owns a band of at most 32 accumulator rows, so its F x (RB, S) f32
    accumulators stay in registers at every level; the chunk C keeps the
    (R, C) weight block of a whole tile at 2048 elements."""

    K: int  # column window = max footprint diameter + slack

    @property
    def TY(self) -> int:
        """Tile output rows."""
        return self.K

    @property
    def S(self) -> int:
        """Accumulator columns."""
        return 2 * self.K

    @property
    def M(self) -> int:
        """Margin (pixels) on each side of the tile's output region."""
        return self.K // 2

    @property
    def frame(self) -> int:
        """Accumulator pixel (row and column) of tile-local coordinate 0:
        the accumulator's centre, so a tile's own particles have local
        coordinates in [-K/2, K/2)."""
        return self.K

    @property
    def R(self) -> int:
        """Accumulator rows: output rows plus both margins."""
        return self.TY + self.K

    @property
    def RB(self) -> int:
        """Accumulator rows one kernel program owns (a band of the R rows)."""
        return min(self.R, 32)

    @property
    def C(self) -> int:
        """Particles per kernel chunk (the one-hot matmul's depth)."""
        return max(16, 2048 // self.R)

    @property
    def default_tx(self) -> int:
        """Tile output cols so the accumulator is exactly S columns wide."""
        return self.S - self.K

    @property
    def max_s_pix(self) -> float:
        """Largest support radius (pixels) this level hosts: the K-window must
        cover the footprint diameter (2s + 2 <= K) and the margin the spill."""
        return (self.K - 2) / 2


# K=64 matters for deep maps: 1024^2 over a full box puts typical SPH
# footprints at 10-30 px; without it they would go to the dense XLA path.
PALLAS_LEVELS: tuple[PallasDepositConfig, ...] = tuple(
    PallasDepositConfig(K=k) for k in (8, 16, 32, 64)
)


def _use_kernel(interpret: bool) -> bool:
    """The one place the deposit route is chosen.

    ``interpret=True`` (tests only) runs the kernel in the Pallas
    interpreter. Otherwise the platform decides: the compiled Triton kernel
    on a GPU, XLA's scatter-add on the CPU. Any other platform is an error,
    never a silent fallback."""
    if interpret:
        return True
    platform = jax.default_backend()
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(
        f"the 2D deposit runs on 'gpu' or 'cpu', not on {platform!r}"
    )


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _placed(w, place):
    """``w (R, C) @ place (C, S)`` for an exact 0/1 ``place``, to ~2^-24 of
    f32: the weights split into three bf16 limbs, smallest summed first."""
    hi = w.astype(jnp.bfloat16)
    r1 = w - hi.astype(jnp.float32)
    mid = r1.astype(jnp.bfloat16)
    lo = (r1 - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    out = pl.dot(lo, place)
    out = out + pl.dot(mid, place)
    return out + pl.dot(hi, place)


def _tile_kernel(
    unit_ref,  # (2,) int32: [first particle, end]
    u_ref, v_ref, h_ref,  # (N + C,) tile-local pixel coords, world h
    *refs,  # n_fields value refs (N + C,), then n_fields (RB, S) outputs:
    # this program's band of its unit's slot
    cfg: PallasDepositConfig,
    n_fields: int,
    kernel_name: str,
    support_factor: float,
    psx: float,
    psy: float,
    offset: float,
    projection: str,
    cheb: tuple[float, ...],
):
    val_refs, out_refs = refs[:n_fields], refs[n_fields:]
    K, R, S, C = cfg.K, cfg.RB, cfg.S, cfg.C
    kernel = get_kernel(kernel_name)
    start = unit_ref[0]
    end = unit_ref[1]
    lane = jnp.arange(C, dtype=jnp.int32)
    band = pl.program_id(1)  # this program's rows: [band * R, band * R + R)
    row_pos = (
        jnp.arange(R, dtype=jnp.int32)[:, None] + band * R - cfg.frame
    ).astype(jnp.float32) + offset
    cols = jnp.arange(S, dtype=jnp.int32)[None, :]

    def chunk(i, accs):
        p = start + i * C
        mask = p + lane < end
        load = lambda ref: plgpu.load(ref.at[pl.ds(p, C)], mask=mask, other=0.0)
        u, v, h = load(u_ref), load(v_ref), load(h_ref)
        # Per-particle factors hoisted out of the (R, C) block, which then
        # sees only divide-free polynomial work:
        # W(r, h) * val = shape_q(r/h) * [val * norm / h^3]. Masked lanes
        # carry h = 0 and so weight 0.
        inv_h = jnp.where(h > 0.0, 1.0 / h, 0.0)
        if projection == "integrated":
            # line-integrated kernel: Y(b, h) = y(b/(S h)) / h^2
            inv_n = inv_h * (1.0 / support_factor)
            val_scale = inv_h * inv_h
        else:
            inv_n = inv_h
            val_scale = (kernel.norm_3d * inv_h) * (inv_h * inv_h)
        vals = [load(r) * val_scale for r in val_refs]
        # accumulator column of the K-window's first column
        col0 = jnp.floor(u - offset + 0.5).astype(jnp.int32) + (cfg.frame - K // 2)
        dyn = (row_pos - v[None, :]) * (psy * inv_n)[None, :]
        dy2n = dyn * dyn  # (R, C)

        def column(k, accs):
            colk = col0 + k  # (C,)
            dxn = ((colk - cfg.frame).astype(jnp.float32) + offset - u) * (psx * inv_n)
            q2 = dy2n + (dxn * dxn)[None, :]  # (R, C)
            if projection == "integrated":
                # gather-free Clenshaw fit of the column kernel; q2 here is
                # (b / (S h))^2
                yv = clenshaw(2.0 * jnp.clip(q2, 0.0, 1.0) - 1.0, cheb)
                w = jnp.where(q2 < 1.0, yv, 0.0)
            else:
                # reference convention: 3D kernel at the projected radius
                # (_pixel_calculations.pyx:32-33); zero outside support
                w = kernel.shape_q(jnp.sqrt(q2))
            # columns outside [0, S) match no lane: their spill lies
            # outside the map (off-extent particles on non-periodic maps)
            place = (cols == colk[:, None]).astype(jnp.bfloat16)  # (C, S)
            return tuple(
                acc + _placed(w * val[None, :], place)
                for acc, val in zip(accs, vals)
            )

        return jax.lax.fori_loop(0, K, column, accs)

    zeros = tuple(jnp.zeros((R, S), jnp.float32) for _ in range(n_fields))
    accs = jax.lax.fori_loop(0, pl.cdiv(end - start, C), chunk, zeros)
    for ref, acc in zip(out_refs, accs):
        ref[...] = acc


def _tile_sum_kernel(span_ref, *refs, n_fields: int, rows: int):
    """One (tile, band): the sum of the tile's unit slots, in unit order."""
    part_refs, out_refs = refs[:n_fields], refs[n_fields:]
    band = pl.ds(pl.program_id(1) * rows, rows)

    def add(j, accs):
        return tuple(acc + ref[j, band, :] for acc, ref in zip(accs, part_refs))

    zeros = tuple(jnp.zeros(ref.shape, jnp.float32) for ref in out_refs)
    accs = jax.lax.fori_loop(span_ref[0], span_ref[1], add, zeros)
    for ref, acc in zip(out_refs, accs):
        ref[...] = acc


_WHOLE = pl.BlockSpec()  # the whole array: programs index it themselves


def _params(interpret: bool) -> dict:
    return dict(
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
    )


def _band_spec(cfg: PallasDepositConfig):
    """Block of program (i, b): band b of slot i of an (n, R, S) array."""
    return pl.BlockSpec((None, cfg.RB, cfg.S), lambda i, b: (i, b, 0))


@lru_cache(maxsize=256)
def _deposit_call(
    cfg, n_units, n_fields, kernel, support_factor, psx, psy, offset,
    projection, interpret,
):
    """The deposit ``pallas_call``, built once per static configuration:
    one program per (unit, band of RB accumulator rows), each writing its
    band of the unit's own (R, S) slot."""
    kern = partial(
        _tile_kernel, cfg=cfg, n_fields=n_fields, kernel_name=kernel,
        support_factor=support_factor, psx=psx, psy=psy, offset=offset,
        projection=projection,
        cheb=(
            integrated_kernel_chebyshev(kernel)
            if projection == "integrated" else ()
        ),
    )
    return pl.pallas_call(
        kern,
        grid=(n_units, cfg.R // cfg.RB),
        in_specs=[pl.BlockSpec((None, 2), lambda i, b: (i, 0))]
        + [_WHOLE] * (3 + n_fields),
        out_specs=[_band_spec(cfg)] * n_fields,
        out_shape=[jax.ShapeDtypeStruct((n_units, cfg.R, cfg.S), jnp.float32)]
        * n_fields,
        name=f"sph_deposit_k{cfg.K}",
        **_params(interpret),
    )


@lru_cache(maxsize=256)
def _tile_sum_call(cfg, n_tiles, n_fields, interpret):
    """The tile-sum ``pallas_call``: one program per (tile, band) adding
    the band of the tile's unit slots, ``spans`` (n_tiles, 2), in order."""
    return pl.pallas_call(
        partial(_tile_sum_kernel, n_fields=n_fields, rows=cfg.RB),
        grid=(n_tiles, cfg.R // cfg.RB),
        in_specs=[pl.BlockSpec((None, 2), lambda t, b: (t, 0))]
        + [_WHOLE] * n_fields,
        out_specs=[_band_spec(cfg)] * n_fields,
        out_shape=[jax.ShapeDtypeStruct((n_tiles, cfg.R, cfg.S), jnp.float32)]
        * n_fields,
        name=f"sph_tile_sum_k{cfg.K}",
        **_params(interpret),
    )


def _units(pstart, pcount, n_units: int):
    """Split every tile's particle range into units of <= ``_UNIT``.

    Returns ``units``, ``(n_units, 2)`` particle ranges ``[first, end]``
    in tile order, and ``spans``, ``(n_tiles, 2)`` rows ``[first unit, end
    unit]`` of each tile. ``n_units`` is the static bound
    ``N / _UNIT + n_tiles``; rows past the last live unit are empty and lie
    in no span."""
    n_tiles = pstart.shape[0]
    per_tile = (pcount + _UNIT - 1) // _UNIT
    cum = jnp.cumsum(per_tile)
    ids = jnp.arange(n_units, dtype=jnp.int32)
    tile = jnp.searchsorted(cum, ids, side="right").astype(jnp.int32)
    live = tile < n_tiles
    tc = jnp.minimum(tile, n_tiles - 1)
    first = pstart[tc] + (ids - (cum - per_tile)[tc]) * _UNIT
    end = jnp.minimum(first + _UNIT, pstart[tc] + pcount[tc])
    first = jnp.where(live, first, 0)
    end = jnp.where(live, end, 0)
    units = jnp.stack([first, end], axis=1)
    spans = jnp.stack([cum - per_tile, cum], axis=1).astype(jnp.int32)
    return units, spans


def _level_kernel(
    key, u, v, h, vals, key_base, geom, n_units, *,
    shape, extent, periodic, offset, kernel, projection, interpret,
):
    """One level through the Triton kernel. ``key`` is sorted; this level's
    tile t owns the particles whose key is ``key_base + t``. The particle
    arrays run ``_KERNEL_SLACK`` slots past ``key``."""
    cfg = geom.cfg
    ny, nx = shape
    x0, x1, y0, y1 = extent
    n_fields = vals.shape[0]
    tiles = key_base + jnp.arange(geom.n_tiles, dtype=jnp.int32)
    pstart = jnp.searchsorted(key, tiles).astype(jnp.int32)
    pcount = jnp.searchsorted(key, tiles, side="right").astype(jnp.int32) - pstart
    units, spans = _units(pstart, pcount, n_units)
    slots = _deposit_call(
        cfg, n_units, n_fields, kernel, get_kernel(kernel).support_factor,
        (x1 - x0) / nx, (y1 - y0) / ny, offset, projection, interpret,
    )(units, u, v, h, *[vals[f] for f in range(n_fields)])
    tiles = _tile_sum_call(cfg, geom.n_tiles, n_fields, interpret)(spans, *slots)
    return _overlap_add(jnp.stack(tiles, axis=1), geom, n_fields, ny, nx, periodic)


def _level_xla(
    u, v, h, vals, tile, geom, *,
    shape, extent, periodic, offset, kernel, projection,
):
    """One level through XLA's scatter-add: the K x K stencil pass of
    :mod:`.deposit`, in each particle's tile-local frame. ``vals`` is zero
    on lanes that do not belong to the level."""
    cfg, tx = geom.cfg, geom.tx
    ny, nx = shape
    x0, x1, y0, y1 = extent
    n = u.shape[0]
    origin = (
        (tile % geom.n_tiles_x) * tx + cfg.frame - cfg.M,
        (tile // geom.n_tiles_x) * cfg.TY + cfg.frame - cfg.M,
    )
    lut = (
        jnp.asarray(integrated_kernel_table(kernel), jnp.float32)
        if projection == "integrated" else None
    )
    img = _stencil_scan(
        jnp.zeros((ny * nx, vals.shape[0]), jnp.float32),
        u, v, h, vals.T, lut, origin,
        K=cfg.K, shape=shape, pixel_size=((x1 - x0) / nx, (y1 - y0) / ny),
        offset=offset, periodic=periodic, kernel_name=kernel,
        projection=projection,
        chunk=min(max(256, _XLA_CHUNK * 64 // cfg.K**2), n & -n),
    )
    return jnp.moveaxis(img.reshape(ny, nx, -1), -1, 0)


def _level(key, u, v, h, vals, key_base, geom, n_units, *, use_kernel,
           interpret, **static):
    """One level from key-sorted particles, on the chosen route: this
    level's tile t owns the particles whose key is ``key_base + t``, and
    ``n_units`` bounds their units. The particle arrays run
    ``_KERNEL_SLACK`` slots past ``key``; their ``h`` is positive wherever
    ``key`` is."""
    if use_kernel:
        return _level_kernel(
            key, u, v, h, vals, key_base, geom, n_units, interpret=interpret,
            **static,
        )
    n = key.shape[0]
    mine = (key >= key_base) & (key < key_base + geom.n_tiles)
    return _level_xla(
        u[:n], v[:n], h[:n], jnp.where(mine[None, :], vals[:, :n], 0.0),
        jnp.where(mine, key - key_base, 0), geom, **static,
    )


def _overlap_add(
    tiles: Array,  # (n_tiles, F, R, S)
    geom: "_LevelGeometry",
    n_fields: int,
    ny: int,
    nx: int,
    periodic: bool,
) -> Array:
    """Sum extended tiles into the (F, ny, nx) image with 9 band adds."""
    cfg, tx = geom.cfg, geom.tx
    n_tiles_y, n_tiles_x = geom.n_tiles_y, geom.n_tiles_x
    R, TY, M = cfg.R, cfg.TY, cfg.M
    t = tiles.reshape(n_tiles_y, n_tiles_x, n_fields, R, cfg.S)
    t = t[:, :, :, :, : tx + 2 * M]  # columns no particle reaches
    t = t.transpose(2, 0, 1, 3, 4)  # (F, nty, ntx, R, tx+2M)

    img = jnp.zeros((n_fields, n_tiles_y, TY, n_tiles_x, tx), dtype=tiles.dtype)

    def bands(margin: int, period: int):
        """Partition accumulator offsets [-margin, period + margin) into
        period-aligned bands: (slice start in acc, height, period shift,
        sub-offset within period). Handles margins spanning multiple periods
        (periodic tiles narrower than the margin)."""
        out = []
        o = -margin
        while o < period + margin:
            p = o // period  # floor division (negative-safe)
            end = min((p + 1) * period, period + margin)
            out.append((o + margin, end - o, p, o - p * period))
            o = end
        return out

    def shift(a, axis, p):
        if p == 0:
            return a
        if periodic:
            return jnp.roll(a, p, axis=axis)
        pad = [(0, 0)] * a.ndim
        idx = [slice(None)] * a.ndim
        if p > 0:
            pad[axis] = (p, 0)
            idx[axis] = slice(0, a.shape[axis])
        else:
            pad[axis] = (0, -p)
            idx[axis] = slice(-p, a.shape[axis] - p)
        return jnp.pad(a, pad)[tuple(idx)]

    for r0, rh, rps, roff in bands(M, TY):
        for c0, cw, cps, coff in bands(M, tx):
            band = t[:, :, :, r0 : r0 + rh, c0 : c0 + cw]
            band = shift(band, 1, rps)
            band = shift(band, 2, cps)
            band = band.transpose(0, 1, 3, 2, 4)  # (F, nty, rh, ntx, cw)
            img = img.at[:, :, roff : roff + rh, :, coff : coff + cw].add(band)

    img = img.reshape(n_fields, n_tiles_y * TY, n_tiles_x * tx)
    return img[:, :ny, :nx]


# ---------------------------------------------------------------------------
# Geometry and the device-resident layout
# ---------------------------------------------------------------------------


def _choose_tx(cfg: PallasDepositConfig, nx: int, periodic: bool) -> int:
    """Tile output width. Non-periodic: S - K (accumulator exactly S wide).
    Periodic overlap-add wraps whole tile periods, so tx must divide nx."""
    if not periodic:
        return cfg.default_tx
    tx = min(cfg.default_tx, nx)
    while tx > cfg.M and nx % tx != 0:
        tx -= 1
    if tx <= cfg.M or nx % tx:
        raise ValueError(
            f"no valid periodic tile width for nx={nx}, level K={cfg.K}"
        )
    return tx


@dataclass(frozen=True)
class _LevelGeometry:
    """Static per-level tiling geometry for one MapSpec."""

    cfg: PallasDepositConfig
    tx: int
    n_tiles_x: int
    n_tiles_y: int

    @property
    def n_tiles(self) -> int:
        return self.n_tiles_x * self.n_tiles_y


def _level_geometry(cfg: PallasDepositConfig, spec: MapSpec) -> _LevelGeometry:
    ny, nx = spec.shape
    tx = _choose_tx(cfg, nx, spec.periodic_wrap)
    if spec.periodic_wrap and ny % cfg.TY:
        raise ValueError("periodic tiled deposit requires TY | ny")
    return _LevelGeometry(
        cfg=cfg,
        tx=tx,
        n_tiles_x=(nx + tx - 1) // tx,
        n_tiles_y=(ny + cfg.TY - 1) // cfg.TY,
    )


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _level_bucket(c: int) -> int:
    """Static capacity for a level segment of ``c`` slots.

    Size classes bound the padding at 12.5 % (pow2 rounding wastes up to
    2x); above 8 x ``_ALIGN`` they are automatically multiples of
    ``_ALIGN``, below that pow2 keeps the alignment at negligible cost."""
    if c <= 8 * _ALIGN:
        return max(_ALIGN, _next_pow2(c))
    return _next_size_class(c)


def _next_size_class(n: int, bits: int = 3) -> int:
    """Smallest ``m * 2^e >= n`` with ``m`` carrying ``bits`` significant
    bits after the leading one (m in [2^bits, 2^(bits+1))).

    Static-capacity rounding: 3-bit classes bound the waste at 1/8 while
    keeping the compiled-program variety bounded (8 classes per octave,
    stable across the chunks of a snapshot). Monotone, and a fixed point on
    its own values (class(class(n)) == class(n))."""
    if n <= (1 << bits):
        return max(0, n)
    e = (n - 1).bit_length() - 1 - bits
    return -(-n >> e) << e


def _as_field_matrix(values) -> tuple[jnp.ndarray, bool]:
    values = jnp.asarray(values, jnp.float32)
    single = values.ndim == 1
    if single:
        values = values[None, :]
    if values.shape[0] > 5:
        raise ValueError("the tiled deposit supports at most 5 fields per pass")
    return values, single


def _pad_particles(x, y, h, values, spec: MapSpec, pad_h: float = 1.0):
    """Pad the particle count to its size class so compiled programs are
    reused across snapshots (data-dependent sizes would otherwise force a
    fresh sort compile per render). Padding particles park at the extent
    max (clipped into the last tile) with weight 0 and smoothing length
    ``pad_h``."""
    n = x.shape[0]
    n_bucket = _level_bucket(n)
    if n_bucket != n:
        pad = n_bucket - n
        x0, x1, y0, y1 = spec.extent
        x = jnp.pad(x, (0, pad), constant_values=float(x1))
        y = jnp.pad(y, (0, pad), constant_values=float(y1))
        h = jnp.pad(h, (0, pad), constant_values=pad_h)
        values = jnp.pad(values, ((0, 0), (0, pad)))
    return x, y, h, values


def _is_host_f64(x) -> bool:
    return isinstance(x, np.ndarray) and x.dtype == np.float64


def _pad_host_f64(x, y, spec: MapSpec) -> tuple[np.ndarray, np.ndarray]:
    """Size-class-pad f64 host coordinates (pads park at the extent max)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.shape[0]
    n_bucket = _level_bucket(n)
    if n_bucket != n:
        pad = n_bucket - n
        x = np.pad(x, (0, pad), constant_values=float(spec.extent[1]))
        y = np.pad(y, (0, pad), constant_values=float(spec.extent[3]))
    return x, y


def _pad_hv(h, values, n_bucket: int, pad_h: float = 1.0):
    """Pad the smoothing-length and value channels (device arrays)."""
    h = jnp.asarray(h, jnp.float32)
    n = h.shape[0]
    if n_bucket != n:
        h = jnp.pad(h, (0, n_bucket - n), constant_values=pad_h)
        values = jnp.pad(values, ((0, 0), (0, n_bucket - n)))
    return h, values


_LEVEL_STRIDE = 1 << 22  # composite sort key: level * STRIDE + tile_id


@dataclass(frozen=True)
class TiledParticles:
    """Device-resident multi-level tile-sorted particle layout.

    Built once per (particle set, extent) by :func:`tile_particles`; every
    field/map rendered from the same positions reuses the sorted layout — a
    new field is a device gather through ``perm``, not a re-sort
    (``with_values``). Per-level segments are bucketed to size classes so
    the compiled programs are shared across snapshots.
    """

    spec: MapSpec
    kernel: str
    geoms: tuple  # per populated level: (_LevelGeometry, lo, bucket, count)
    sorted_u: Array  # (N + slack,) tile-local pixel coords, (level,
    # tile)-sorted; the slack keeps every per-level read a dynamic_slice
    sorted_v: Array
    sorted_h: Array
    sorted_values: Array  # (F, N + slack)
    sorted_tile: Array  # (N + slack,) tile id within the particle's own level
    perm: Optional[Array]  # (N + slack,) original index of each sorted slot
    # (pads: 0); None when built with need_perm=False (drops one operand
    # from the fused sort — with_values is then unavailable)
    n_sorted: int  # real sorted length N (size-class-padded particle count)
    n_oversize: int  # trailing segment routed to the XLA fallback
    n_valid: int  # real (non-padding) particle count

    @property
    def n_fields(self) -> int:
        return self.sorted_values.shape[0]

    def with_values(self, values) -> "TiledParticles":
        """Same layout, new deposit payloads (device gather, no re-sort)."""
        if self.perm is None:
            raise ValueError(
                "layout was built with need_perm=False; rebuild with "
                "tile_particles(..., need_perm=True) to re-render new fields"
            )
        values, _ = _as_field_matrix(values)
        n = values.shape[1]
        if n != self.n_valid:
            raise ValueError(f"expected {self.n_valid} per-particle values, got {n}")
        pad = self.perm.shape[0] - n
        values = jnp.pad(values, ((0, 0), (0, pad)))
        return TiledParticles(
            spec=self.spec, kernel=self.kernel, geoms=self.geoms,
            sorted_u=self.sorted_u, sorted_v=self.sorted_v, sorted_h=self.sorted_h,
            sorted_values=values[:, self.perm],
            sorted_tile=self.sorted_tile, perm=self.perm,
            n_sorted=self.n_sorted, n_oversize=self.n_oversize,
            n_valid=self.n_valid,
        )


def _geom_tuples(geoms):
    """Per-level geometry as static tuples (disabled levels: None)."""
    return (
        tuple(g.n_tiles_x if g else 1 for g in geoms),
        tuple(g.cfg.TY if g else 1 for g in geoms),
        tuple(g.tx if g else 1 for g in geoms),
        tuple(g.n_tiles_y if g else 1 for g in geoms),
        # tile output origin - local origin, per level
        tuple(g.cfg.M - g.cfg.frame if g else 0 for g in geoms),
    )


def _level_geometries(spec: MapSpec, levels) -> list:
    """Geometry per level; a level that cannot tile this (small/periodic)
    map is None and its particles go to the oversize fallback."""
    geoms: list[Optional[_LevelGeometry]] = []
    for cfg in levels:
        try:
            geoms.append(_level_geometry(cfg, spec))
        except ValueError:
            geoms.append(None)
    # composite sort keys are level * _LEVEL_STRIDE + tile: a level whose
    # tile count reaches the stride would silently alias into the next
    # level's key range (possible from ~16k^2 maps up)
    for g in geoms:
        if g is not None and g.n_tiles >= _LEVEL_STRIDE:
            raise ValueError(
                f"{g.n_tiles} tiles at the K={g.cfg.K} level exceed the "
                f"composite-key stride ({_LEVEL_STRIDE}); render this map "
                "in sub-extents (the adaptive tile layout caps at "
                "2^22 tiles per level)"
            )
    return geoms


def tile_particles(
    x, y, h, values, spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    levels: tuple[PallasDepositConfig, ...] = PALLAS_LEVELS,
    need_perm: bool = True,
    donate: bool = False,
) -> TiledParticles:
    """Build the device-resident multi-level layout.

    Each particle is assigned a footprint level (by ``support_factor * h`` in
    pixels) and its tile id under that level's geometry, then grouped by one
    multi-operand ``lax.sort`` on the composite key so every level's segment
    is internally tile-sorted. The only host syncs are the per-level counts
    (a handful of ints) sizing the compiled programs.
    """
    kspec = get_kernel(kernel)
    values, _ = _as_field_matrix(values)
    n_valid = int(np.asarray(h).shape[0]) if isinstance(h, np.ndarray) else int(h.shape[0])
    # sub-pixel pad h: padding must land in the smallest level's last tile
    # (weight 0), NOT inflate the oversize fallback
    pad_h = 0.1 * min(spec.pixel_size)
    geoms = _level_geometries(spec, levels)
    bounds = tuple(
        (g.cfg.max_s_pix if g is not None else -1.0) for g in geoms
    )
    n_fields = values.shape[0]
    geom_tuples = _geom_tuples(geoms)
    extent = tuple(float(e) for e in spec.extent)

    if _is_host_f64(x):
        # quality path: level/tile/local assignment in f64 on the host
        xh, yh = _pad_host_f64(x, y, spec)
        h_host = np.asarray(h, np.float32)
        if xh.shape[0] != h_host.shape[0]:
            h_host = np.pad(
                h_host, (0, xh.shape[0] - h_host.shape[0]), constant_values=pad_h
            )
        h, values = _pad_hv(h, values, xh.shape[0], pad_h=pad_h)
        ny, nx = spec.shape
        x0, x1, y0, y1 = extent
        psx = (x1 - x0) / nx
        psy = (y1 - y0) / ny
        # fused single-pass native assignment (falls back to the multi-pass
        # NumPy formulation without a C toolchain; bit-identical otherwise)
        from .. import native as _native

        assigned = _native.assign_tiles_f64(
            xh, yh, h_host,
            x0=x0, y0=y0, psx=psx, psy=psy, nx=nx, ny=ny,
            periodic=spec.periodic_wrap, support_factor=kspec.support_factor,
            bounds=bounds, ntx=geom_tuples[0], nty=geom_tuples[3],
            tw=geom_tuples[2], th=geom_tuples[1], marg=geom_tuples[4],
            stride=_LEVEL_STRIDE,
        )
        if assigned is not None:
            key, u_loc, v_loc = assigned
        else:
            u = (xh - x0) / psx
            v = (yh - y0) / psy
            if spec.periodic_wrap:
                u = np.mod(u, nx)
                v = np.mod(v, ny)
            s_pix = kspec.support_factor * h_host.astype(np.float64) / min(psx, psy)
            level, tile, u_loc, v_loc = _multi_level_assign(
                u, v, s_pix, bounds, *geom_tuples, np
            )
            key = (level * _LEVEL_STRIDE + tile).astype(np.int32)
        sorted_key, su, sv, sh, s_values, perm, counts = _cached_tile_sort_local(
            len(bounds), n_fields, need_perm
        )(
            jnp.asarray(key), jnp.asarray(u_loc, jnp.float32),
            jnp.asarray(v_loc, jnp.float32), h, values,
        )
    else:
        x = jnp.asarray(x, jnp.float32)
        y = jnp.asarray(y, jnp.float32)
        h = jnp.asarray(h, jnp.float32)
        x, y, h, values = _pad_particles(x, y, h, values, spec, pad_h=pad_h)
        sorted_key, su, sv, sh, s_values, perm, counts = _cached_tile_sort(
            spec.shape, extent, spec.periodic_wrap,
            bounds, *geom_tuples,
            kspec.support_factor, n_fields, need_perm, donate,
        )(x, y, h, values)

    counts_host = np.asarray(counts)  # host sync: len(levels)+1 ints
    level_meta = []
    lo = 0
    for li, g in enumerate(geoms):
        c = int(counts_host[li])
        if g is not None and c > 0:
            level_meta.append((g, lo, _level_bucket(c), c))
        lo += c

    return TiledParticles(
        spec=spec, kernel=kernel, geoms=tuple(level_meta),
        sorted_u=su, sorted_v=sv, sorted_h=sh, sorted_values=s_values,
        sorted_tile=sorted_key, perm=perm,
        n_sorted=int(counts_host.sum()),
        n_oversize=int(counts_host[len(geoms)]),
        n_valid=n_valid,
    )


def _multi_level_assign(u, v, s_pix, bounds, n_tiles_x_t, ty_t, tx_t, n_tiles_y_t, m_t, xp):
    """(level, tile id, tile-LOCAL coords) per particle, each under its own
    level's geometry. Oversize/disabled-level particles keep GLOBAL pixel
    coordinates (tile 0) so the dense fallback can recover world positions.
    Works in numpy (host f64 quality path) or jnp (device f32 path)."""
    n_levels = len(bounds)
    level = xp.full(u.shape, n_levels, xp.int32)
    for li in range(n_levels - 1, -1, -1):
        if bounds[li] >= 0:
            level = xp.where(s_pix <= bounds[li], xp.int32(li), level)
    tile = xp.zeros(u.shape, xp.int32)
    u_loc = u
    v_loc = v
    for li in range(n_levels):
        if bounds[li] < 0:
            continue
        tx_i = xp.clip((u / tx_t[li]).astype(xp.int32), 0, n_tiles_x_t[li] - 1)
        ty_i = xp.clip((v / ty_t[li]).astype(xp.int32), 0, n_tiles_y_t[li] - 1)
        sel = level == li
        tile = xp.where(sel, ty_i * n_tiles_x_t[li] + tx_i, tile)
        u_loc = xp.where(sel, u - (tx_i * tx_t[li] - m_t[li]), u_loc)
        v_loc = xp.where(sel, v - (ty_i * ty_t[li] - m_t[li]), v_loc)
    return level, tile, u_loc, v_loc


def _assign_keys(x, y, h, *, shape, extent, periodic, bounds, geom_tuples,
                 support_factor):
    """Device-side composite key + tile-local coordinates (f32 inputs)."""
    ny, nx = shape
    x0, x1, y0, y1 = extent
    psx = (x1 - x0) / nx
    psy = (y1 - y0) / ny
    u = (x - x0) / psx
    v = (y - y0) / psy
    if periodic:
        u = jnp.mod(u, nx)
        v = jnp.mod(v, ny)
    s_pix = support_factor * h / min(psx, psy)
    level, tile, u_loc, v_loc = _multi_level_assign(
        u, v, s_pix, bounds, *geom_tuples, jnp
    )
    return level * _LEVEL_STRIDE + tile, u_loc, v_loc


def _tile_sort_tail(key, u_loc, v_loc, h, values, n_levels, n_fields,
                    need_perm: bool = True):
    """Composite-key sort + per-level counts + N/2 slack padding."""
    # Payloads ride the sort as extra operands; the original-index operand
    # is optional (re-rendering new fields through with_values needs it).
    operands = [key, u_loc, v_loc, h]
    if need_perm:
        operands.append(jnp.arange(key.shape[0], dtype=jnp.int32))
    # grouping needs key order only, not stability
    sorted_ops = jax.lax.sort(
        operands + [values[f] for f in range(n_fields)], num_keys=1,
        is_stable=False,
    )
    sorted_key, su, sv, sh = sorted_ops[:4]
    perm = sorted_ops[4] if need_perm else None
    s_vals = sorted_ops[4 + int(need_perm):]
    s_values = jnp.stack(s_vals, axis=0)
    lv = jnp.arange(n_levels + 1, dtype=jnp.int32) * _LEVEL_STRIDE
    starts = jnp.searchsorted(sorted_key, lv).astype(jnp.int32)
    ends = jnp.searchsorted(
        sorted_key, lv + (_LEVEL_STRIDE - 1), side="right"
    ).astype(jnp.int32)
    counts = ends - starts
    s_tile = sorted_key - (sorted_key // _LEVEL_STRIDE) * _LEVEL_STRIDE
    # N/2 slack so every level segment (offset lo, bucket) — and the
    # kernel's _KERNEL_SLACK past it — is a lax.dynamic_slice, never a
    # gather. lo + bucket <= N + max(N/2, _ALIGN) always:
    # bucket <= max(_ALIGN, next_pow2(c)) and lo <= N - c; for
    # next_pow2(c) <= _ALIGN the end is <= N + _ALIGN, otherwise the
    # overhang bucket - c < c <= N/2 for c <= N/2, and for c > N/2 the
    # bucket is the (size-classed) N with lo + N <= 2N - c < 1.5N.
    n = key.shape[0]
    slack = max(n // 2, _ALIGN) + _KERNEL_SLACK
    pad1 = lambda a: jnp.pad(a, (0, slack))
    return (
        pad1(s_tile), pad1(su), pad1(sv), pad1(sh),
        jnp.pad(s_values, ((0, 0), (0, slack))),
        pad1(perm) if need_perm else None, counts,
    )


@lru_cache(maxsize=256)
def _cached_tile_sort(
    shape, extent, periodic, bounds, n_tiles_x_t, ty_t, tx_t, n_tiles_y_t,
    m_t, support_factor, n_fields, need_perm=True, donate=False,
):
    """``donate=True`` lets XLA reuse the caller's input buffers as sort
    scratch — at 1e8-particle scale the layout and the sort's double
    buffers are several GB. Callers' arrays are invalidated."""
    n_levels = len(bounds)
    geom_tuples = (n_tiles_x_t, ty_t, tx_t, n_tiles_y_t, m_t)

    def run(x, y, h, values):
        key, u_loc, v_loc = _assign_keys(
            x, y, h, shape=shape, extent=extent, periodic=periodic,
            bounds=bounds, geom_tuples=geom_tuples,
            support_factor=support_factor,
        )
        return _tile_sort_tail(
            key, u_loc, v_loc, h, values, n_levels, n_fields, need_perm
        )

    return jax.jit(run, donate_argnums=(0, 1, 2, 3) if donate else ())


@lru_cache(maxsize=64)
def _cached_tile_sort_local(n_levels, n_fields, need_perm=True):
    """Sort tail for host-precomputed (key, local coords) — the f64 quality
    path computes the level/tile/local assignment on the host."""

    @jax.jit
    def run(key, u_loc, v_loc, h, values):
        return _tile_sort_tail(
            key, u_loc, v_loc, h, values, n_levels, n_fields, need_perm
        )

    return run


def _layout_level_body(
    geom, shape, extent, periodic, offset, kernel, bucket, projection,
    use_kernel, interpret, su, sv, sh, s_values, s_tile, lo, count,
):
    """Traced body: render one level from the sorted layout (its bucketed
    segment, read with contiguous dynamic slices) on the chosen route."""
    n_tiles = geom.n_tiles
    width = bucket + _KERNEL_SLACK
    live = jnp.arange(width, dtype=jnp.int32) < count
    u = jax.lax.dynamic_slice(su, (lo,), (width,))
    v = jax.lax.dynamic_slice(sv, (lo,), (width,))
    h = jnp.where(live, jax.lax.dynamic_slice(sh, (lo,), (width,)), 1.0)
    vals = jnp.where(
        live[None, :],
        jax.lax.dynamic_slice(s_values, (0, lo), (s_values.shape[0], width)),
        0.0,
    )
    # pad slots sort to a synthetic tile past the last so ranges stay sorted
    tile = jnp.where(
        live[:bucket], jax.lax.dynamic_slice(s_tile, (lo,), (bucket,)), n_tiles,
    ).astype(jnp.int32)
    return _level(
        tile, u, v, h, vals, 0, geom, bucket // _UNIT + n_tiles,
        use_kernel=use_kernel, interpret=interpret, shape=shape,
        extent=extent, periodic=periodic, offset=offset, kernel=kernel,
        projection=projection,
    )


@lru_cache(maxsize=256)
def _cached_layout_all_levels(
    metas_static, shape, extent, periodic, offset, n_fields,
    kernel, projection, use_kernel, interpret,
):
    """ONE jitted program rendering every populated level and summing the
    maps, so the adaptive stack is one dispatch."""

    @jax.jit
    def run(su, sv, sh, s_values, s_tile, los, counts):
        ny, nx = shape
        total = jnp.zeros((n_fields, ny, nx), jnp.float32)
        for i, (geom, bucket) in enumerate(metas_static):
            total = total + _layout_level_body(
                geom, shape, extent, periodic, offset, kernel, bucket,
                projection, use_kernel, interpret,
                su, sv, sh, s_values, s_tile, los[i], counts[i],
            )
        return total

    return run


def deposit_tiled(
    tp: TiledParticles,
    *,
    projection: str = "kernel3d",
    interpret: bool = False,
) -> Array:
    """Render the full adaptive-h map stack from a :class:`TiledParticles`
    layout. All levels run device-resident; only oversize-footprint
    stragglers (footprint > the largest K-window) go to the XLA dense path.
    ``interpret`` runs the kernel in the Pallas interpreter (tests).
    Returns (F, ny, nx).
    """
    return _deposit_tiled(tp, projection, _use_kernel(interpret), interpret)


def _layout_program(tp, projection, use_kernel, interpret):
    """(jitted program, its arguments) rendering every populated level."""
    metas_static = tuple((meta[0], meta[2]) for meta in tp.geoms)
    los = jnp.asarray([int(meta[1]) for meta in tp.geoms], jnp.int32)
    counts = jnp.asarray([int(meta[3]) for meta in tp.geoms], jnp.int32)
    fn = _cached_layout_all_levels(
        metas_static, tp.spec.shape,
        tuple(float(e) for e in tp.spec.extent), tp.spec.periodic_wrap,
        tp.spec.sample_offset, tp.n_fields, tp.kernel, projection,
        use_kernel, interpret,
    )
    return fn, (tp.sorted_u, tp.sorted_v, tp.sorted_h, tp.sorted_values,
                tp.sorted_tile, los, counts)


def _deposit_tiled(tp, projection, use_kernel, interpret):
    ny, nx = tp.spec.shape
    if tp.geoms:
        fn, args = _layout_program(tp, projection, use_kernel, interpret)
        total = fn(*args)
    else:
        total = jnp.zeros((tp.n_fields, ny, nx), jnp.float32)

    if tp.n_oversize:
        from .deposit import deposit_2d  # late import: sibling module

        # oversize stragglers live at the end of the (real) sorted layout;
        # recover world coordinates from pixel space for the dense path
        x0, x1, y0, y1 = tp.spec.extent
        psx = (x1 - x0) / nx
        psy = (y1 - y0) / ny
        sl = slice(tp.n_sorted - tp.n_oversize, tp.n_sorted)
        xo = np.asarray(tp.sorted_u[sl]) * psx + x0
        yo = np.asarray(tp.sorted_v[sl]) * psy + y0
        ho = np.asarray(tp.sorted_h[sl])
        vo = np.asarray(tp.sorted_values[:, sl])
        img = deposit_2d(
            xo, yo, ho, vo.T, tp.spec, kernel=tp.kernel, projection=projection
        )
        total = total + jnp.moveaxis(
            img if img.ndim == 3 else img[..., None], -1, 0
        )
    return total


def deposit_2d_auto(
    x, y, h, values, spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    projection: str = "kernel3d",
    interpret: bool = False,
):
    """Adaptive-h deposit: device-resident level/tile partition (one fused
    sort), one fused pass per populated footprint level, oversize
    stragglers routed to the XLA dense path.

    ``projection``: 'kernel3d' reproduces the reference convention (3D kernel
    at the projected radius); 'integrated' uses the analytically
    line-integrated kernel (physically-correct column densities).
    f64 NumPy coordinates take the quality path (tile-local coordinates
    computed in f64 on the host); f32/device arrays are converted on the
    device (~1e-4 (px/h)-class conversion noise at 1024^2).
    Returns (ny, nx) for single-field input, else (F, ny, nx).
    """
    values, single = _as_field_matrix(values)
    tp = tile_particles(x, y, h, values, spec, kernel=kernel)
    total = deposit_tiled(tp, projection=projection, interpret=interpret)
    return total[0] if single else total


def deposit_2d_pallas(
    x, y, h, values, spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    level: Optional[PallasDepositConfig] = None,
    projection: str = "kernel3d",
    interpret: bool = False,
) -> Array:
    """Single-level tiled deposit (default: the K=8 level).

    Particles whose footprint does not fit ``level``'s K-window go to the
    XLA dense path. Returns (ny, nx) or (F, ny, nx).
    """
    values, single = _as_field_matrix(values)
    tp = tile_particles(
        x, y, h, values, spec, kernel=kernel,
        levels=(level or PALLAS_LEVELS[0],),
    )
    img = deposit_tiled(tp, projection=projection, interpret=interpret)
    return img[0] if single else img


# ---------------------------------------------------------------------------
# Traced multi-level deposit (no host sync): the per-shard body of
# parallel.deposit_2d_sharded
# ---------------------------------------------------------------------------


def deposit_levels_traced(
    x, y, h, values, spec: MapSpec,
    *,
    max_level: PallasDepositConfig,
    kernel: str,
    interpret: bool,
):
    """Adaptive-h deposit of f32 particles with no host sync — safe under
    ``jit`` and ``shard_map``. Levels up to ``max_level`` are used;
    footprints beyond its K-window are truncated to it. Every level reads
    the whole sorted array, so each level's program is sized for all N
    particles. Returns (F, ny, nx)."""
    levels = tuple(c for c in PALLAS_LEVELS if c.K <= max_level.K)
    geoms = _level_geometries(spec, levels)
    if any(g is None for g in geoms):
        raise ValueError(
            f"map {spec.shape} (periodic={spec.periodic_wrap}) cannot host "
            f"every level up to K={max_level.K}"
        )
    bounds = tuple(g.cfg.max_s_pix for g in geoms[:-1]) + (float("inf"),)
    extent = tuple(float(e) for e in spec.extent)
    support_factor = get_kernel(kernel).support_factor
    key, u, v = _assign_keys(
        x, y, h, shape=spec.shape, extent=extent,
        periodic=spec.periodic_wrap, bounds=bounds,
        geom_tuples=_geom_tuples(geoms), support_factor=support_factor,
    )
    n_fields = values.shape[0]
    key, u, v, h, *vals = jax.lax.sort(
        [key, u, v, h] + [values[f] for f in range(n_fields)],
        num_keys=1, is_stable=False,
    )
    n = h.shape[0]
    u, v, h = (jnp.pad(a, (0, _KERNEL_SLACK)) for a in (u, v, h))
    vals = jnp.pad(jnp.stack(vals), ((0, 0), (0, _KERNEL_SLACK)))
    use_kernel = _use_kernel(interpret)
    total = 0.0
    for li, geom in enumerate(geoms):
        total = total + _level(
            key, u, v, h, vals, li * _LEVEL_STRIDE, geom,
            -(-n // _UNIT) + geom.n_tiles, use_kernel=use_kernel,
            interpret=interpret, shape=spec.shape, extent=extent,
            periodic=spec.periodic_wrap, offset=spec.sample_offset,
            kernel=kernel, projection="kernel3d",
        )
    return total
