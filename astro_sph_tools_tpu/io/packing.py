"""Compact host->device particle payloads for streaming ingest.

The e2e snapshot->map pipeline is transfer-bound on hosts with slow
host-to-device links: at 1e8 particles the f32 payload is ~2.7-3.1 GB,
while the device compute is a small part of the wall. The deposit
consumes tile-local f32 (u, v) pixel coordinates, f32 smoothing lengths,
and f32 field values — full-width f32 on the wire is wasted precision:

- positions quantise to fixed-point ``uint16`` per axis (box/65536
  resolution: 1.6e-2 px at a 1024^2 map of the full box — orders below the
  smoothing scale of any SPH particle, and quantisation to the cell centre
  is unbiased);
- smoothing lengths ride IEEE ``float16`` (0.05% relative, well inside the
  ~1% accuracy SPH h is iterated to);
- field values ride ``float16`` with a caller-chosen power-of-two scale to
  bring magnitudes in range (Msun masses overflow f16; Msun/1e10 do not).
  Power-of-two scales make the scale/unscale round trip exact in binary
  floating point.

10 bytes/particle for (x, y, h, 2 fields) instead of 20. Unpacking is a cheap fused
device pass (`unpack_particles_device`); the host-side pack is one
multiply+cast numpy pass per channel.

This is *ingest* compression: the deposit itself stays bit-exact relative
to its (quantised) inputs, so compiled-fidelity guarantees are unchanged;
the quantisation error relative to f32 ingest is measured and reported by
``benchmarks/e2e_1e8.py --pack`` (map-level relative error ~1e-4..1e-3,
far below any physical uncertainty). There is no reference analogue — the
reference ships f64 numpy arrays between MPI ranks
(`tools/_ArrayReorder.py:299-373`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "PackedParticles",
    "pack_particles_host",
    "unpack_particles_device",
]


@dataclass
class PackedParticles:
    """Quantised particle block (host numpy or device jnp leaves).

    ``x_q``/``y_q``: uint16 fixed point over [x0, x0+box) / [y0, y0+box).
    ``h_q``: float16 smoothing lengths. ``fields_q``: (F, N) float16,
    value = fields_q * field_scales[f] after unpack.
    """

    x_q: np.ndarray
    y_q: np.ndarray
    h_q: np.ndarray
    fields_q: np.ndarray
    x0: float
    y0: float
    box: float
    field_scales: tuple
    #: scalar applied to h at unpack (fold a raw->user unit conversion into
    #: the device pass: pack h in on-disk internal units, unpack in Mpc)
    h_scale: float = 1.0
    #: scalar applied to decoded positions at unpack (same folding for x/y
    #: when ``box``/``x0``/``y0`` were given in raw internal units)
    pos_scale: float = 1.0
    #: Morton-delta position stream (deltas, bases, exc_idx, exc_corr, n);
    #: replaces x_q/y_q (None) when the storage order is curve-coherent —
    #: ~2 B/particle instead of 4 (`morton_delta_encode`)
    pos_delta: Optional[tuple] = None
    #: per-segment u8-log field metadata (lo (F, n_seg) f32, step (F,
    #: n_seg) f32) when ``fields_q`` is uint8 — 1 B/particle/field
    field_log_meta: Optional[tuple] = None

    @property
    def n_particles(self) -> int:
        return self.pos_delta[4] if self.pos_delta else self.x_q.shape[0]

    @property
    def nbytes(self) -> int:
        if self.pos_delta is not None:
            d, b, ei, ec, _ = self.pos_delta
            pos = d.nbytes + b.nbytes + ei.nbytes + ec.nbytes
        else:
            pos = self.x_q.nbytes + self.y_q.nbytes
        meta = (
            sum(a.nbytes for a in self.field_log_meta)
            if self.field_log_meta is not None else 0
        )
        return pos + self.h_q.nbytes + self.fields_q.nbytes + meta


def pack_particles_host(
    x: np.ndarray,
    y: np.ndarray,
    h: np.ndarray,
    fields: Sequence[np.ndarray],
    *,
    box: float,
    x0: float = 0.0,
    y0: float = 0.0,
    field_scales: Optional[Sequence[float]] = None,
    field_unpack_scales: Optional[Sequence[float]] = None,
    h_scale: float = 1.0,
    pos_scale: float = 1.0,
    pos_encoding: str = "u16",
    field_dtype: str = "f16",
) -> PackedParticles:
    """Quantise one particle block on the host (one fused pass per channel).

    ``field_scales[f]`` should be a power of two bringing ``fields[f] /
    scale`` into f16 range (|v| < 6e4, |v| > 6e-5 for full precision);
    defaults to 1.0 per field.

    Unit conversion can ride the unpack instead of costing host passes:
    pass *raw on-disk* arrays with ``box``/``x0``/``y0`` in the same raw
    units, set ``h_scale`` / ``field_unpack_scales`` to the raw->user
    scalar conversions (times ``field_scales``), and the single-core host
    does exactly one multiply+cast per channel — the f64 unit algebra
    happens on device (``unpack_particles_device``) where it is free.
    """
    n = x.shape[0]
    inv = np.float64(65536.0) / box
    # u = floor((x - x0) / box * 65536), clipped into the box. The upper
    # clip must be exactly representable in float32 (position arrays may be
    # f32, and a non-representable bound like 65535.999 rounds UP to
    # 65536.0f, which .astype(np.uint16) would wrap to 0 — teleporting
    # far-edge particles across the box). 65535.0 is exact in f32 and
    # floors to the same last cell.
    x_q = np.clip((x - x0) * inv, 0, 65535.0).astype(np.uint16)
    y_q = np.clip((y - y0) * inv, 0, 65535.0).astype(np.uint16)
    pos_delta = None
    if pos_encoding not in ("u16", "delta", "auto"):
        raise ValueError(f"unknown pos_encoding {pos_encoding!r}")
    if pos_encoding in ("delta", "auto"):
        pd = morton_delta_encode(x_q, y_q)
        # auto: keep the delta stream only when the storage order is
        # curve-coherent enough for it to actually shrink the wire
        if pos_encoding == "delta" or pd[2].size <= 0.1 * n:
            pos_delta = pd
            x_q = y_q = None
    h_q = np.asarray(h, dtype=np.float16)
    if field_scales is None:
        field_scales = (1.0,) * len(fields)
    if len(field_scales) != len(fields):
        raise ValueError("field_scales must match fields")
    if field_unpack_scales is None:
        field_unpack_scales = field_scales
    if len(field_unpack_scales) != len(fields):
        raise ValueError("field_unpack_scales must match fields")
    field_log_meta = None
    if field_dtype == "u8":
        # per-segment log quantisation: 1 B/particle/field, relative step
        # = (local log2 range)/255 per 4096-record segment — snapshot-order
        # locality keeps the local range to a few octaves (<~1 % error).
        # Positive fields only (SPH masses/temperatures/columns).
        n_seg = -(-n // _DELTA_CHUNK)
        pad = n_seg * _DELTA_CHUNK - n
        fields_q = np.empty((len(fields), n_seg * _DELTA_CHUNK), np.uint8)
        lo_m = np.empty((len(fields), n_seg), np.float32)
        st_m = np.empty((len(fields), n_seg), np.float32)
        for fi, f in enumerate(fields):
            f = np.asarray(f, np.float64)
            if f.min() <= 0:
                raise ValueError(
                    "field_dtype='u8' log packing needs positive fields"
                )
            lg = np.pad(np.log2(f), (0, pad), mode="edge").reshape(
                n_seg, _DELTA_CHUNK
            )
            lo = lg.min(axis=1)
            step = np.maximum((lg.max(axis=1) - lo) / 255.0, 1e-12)
            q = np.rint((lg - lo[:, None]) / step[:, None])
            fields_q[fi] = np.clip(q, 0, 255).reshape(-1).astype(np.uint8)
            lo_m[fi] = lo
            st_m[fi] = step
        field_log_meta = (lo_m, st_m)
    elif field_dtype == "f16":
        fields_q = np.empty((len(fields), n), dtype=np.float16)
        for fi, (f, s) in enumerate(zip(fields, field_scales)):
            np.multiply(f, 1.0 / s, out=fields_q[fi], casting="unsafe")
    else:
        raise ValueError(f"unknown field_dtype {field_dtype!r}")
    return PackedParticles(
        x_q=x_q, y_q=y_q, h_q=h_q, fields_q=fields_q,
        x0=float(x0), y0=float(y0), box=float(box),
        field_scales=tuple(float(s) for s in field_unpack_scales),
        h_scale=float(h_scale),
        pos_scale=float(pos_scale),
        pos_delta=pos_delta,
        field_log_meta=field_log_meta,
    )


def unpack_particles_device(packed: PackedParticles):
    """Fused device pass: quantised block -> (x, y, h, fields) in f32.

    Fixed-point cells decode at their centre ((q + 0.5) * box / 65536):
    unbiased for any in-cell position distribution. Works under ``jit``;
    call with the quantised leaves already on device (e.g. via
    ``jax.device_put`` from a prefetch thread) so only ~10 bytes/particle
    cross the host->device link.
    """
    import jax.numpy as jnp

    cw = packed.box / 65536.0
    ps = packed.pos_scale
    if packed.pos_delta is not None:
        x_q, y_q = morton_delta_decode_device(*packed.pos_delta)
    else:
        x_q, y_q = packed.x_q, packed.y_q
    x = ((x_q.astype(jnp.float32) + 0.5) * cw + packed.x0) * ps
    y = ((y_q.astype(jnp.float32) + 0.5) * cw + packed.y0) * ps
    h = packed.h_q.astype(jnp.float32) * packed.h_scale
    n = h.shape[0]
    scales = jnp.asarray(packed.field_scales, jnp.float32)[:, None]
    if packed.field_log_meta is not None:
        lo_m, st_m = packed.field_log_meta
        F, n_seg = lo_m.shape
        q = packed.fields_q.astype(jnp.float32).reshape(F, n_seg, _DELTA_CHUNK)
        lg = jnp.asarray(lo_m, jnp.float32)[:, :, None] + q * jnp.asarray(
            st_m, jnp.float32
        )[:, :, None]
        fields = jnp.exp2(lg).reshape(F, n_seg * _DELTA_CHUNK)[:, :n] * scales
    else:
        fields = packed.fields_q.astype(jnp.float32) * scales
    return x, y, h, fields


# ---------------------------------------------------------------------------
# Morton-delta position wire (< 7 B/particle)
# ---------------------------------------------------------------------------

_DELTA_CHUNK = 4096  # records per delta segment (absolute base per segment)


def _interleave16(x_q: np.ndarray, y_q: np.ndarray) -> np.ndarray:
    """(u16, u16) -> u32 Morton code, vectorised bit spreading."""
    def spread(v):
        v = v.astype(np.uint32)
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    return spread(x_q) | (spread(y_q) << np.uint32(1))


def morton_delta_encode(x_q: np.ndarray, y_q: np.ndarray):
    """Delta-encode quantised positions along the snapshot's storage order.

    Space-filling-curve-ordered snapshots (EAGLE Peano-Hilbert, our Morton
    fixtures) put consecutive particles close in Morton space, so the u32
    Morton code's first differences almost always fit int16: the wire
    carries 2 B/particle of deltas + one u32 base per 4096-record segment
    + a sparse exception list for the rare jumps. Returns
    ``(deltas_i16, bases_u32, exc_idx_i64, exc_corr_u32, n)`` — exact for
    ANY input order (a shuffled snapshot just fills the exception list;
    callers should fall back to plain u16 pairs when
    ``exc_idx.size / n > ~0.1``).
    """
    n = int(x_q.shape[0])
    from .. import native as _native

    enc = _native.morton_delta_encode_u16(x_q, y_q, _DELTA_CHUNK)
    if enc is not None:
        return enc  # single C pass; bit-identical to the NumPy path below
    m = _interleave16(x_q, y_q)
    n_seg = -(-n // _DELTA_CHUNK)
    pad = n_seg * _DELTA_CHUNK - n
    mp = np.pad(m, (0, pad), mode="edge").reshape(n_seg, _DELTA_CHUNK)
    d = np.zeros_like(mp, dtype=np.int64)
    d[:, 1:] = mp[:, 1:].astype(np.int64) - mp[:, :-1].astype(np.int64)
    bases = mp[:, 0].copy()
    flat = d.reshape(-1)
    over = (flat > 32767) | (flat < -32768)
    exc_idx = np.flatnonzero(over)
    flat = np.where(over, 0, flat)
    deltas = flat.astype(np.int16)
    # exception CORRECTIONS: the decoder adds, from each exception on (a
    # segmented running sum), the gap between the true code and the
    # stored-delta cumsum — relative to the previous exception in the same
    # segment so multiple exceptions per segment compose exactly
    if exc_idx.size:
        m0 = bases[:, None].astype(np.int64) + np.cumsum(
            flat.reshape(n_seg, _DELTA_CHUNK), axis=1, dtype=np.int64
        )
        gap = mp.reshape(-1)[exc_idx].astype(np.int64) - m0.reshape(-1)[exc_idx]
        seg = exc_idx // _DELTA_CHUNK
        corr = np.diff(gap, prepend=np.int64(0))
        first_of_seg = np.diff(seg, prepend=np.int64(-1)) != 0
        corr = np.where(first_of_seg, gap, corr)
        exc_corr = (corr & np.int64(0xFFFFFFFF)).astype(np.uint32)
    else:
        exc_corr = np.zeros(0, np.uint32)
    return deltas, bases, exc_idx, exc_corr, n


def morton_delta_decode_device(deltas, bases, exc_idx, exc_corr, n: int):
    """Device-side decode: segmented cumsum + sparse corrections +
    bit de-interleave. Returns (x_q, y_q) as int32 arrays of length n
    (identical to the encoder's inputs)."""
    import jax.numpy as jnp

    n_seg = bases.shape[0]
    d = jnp.asarray(deltas, jnp.int32).reshape(n_seg, _DELTA_CHUNK)
    m = jnp.cumsum(d, axis=1) + jnp.asarray(bases, jnp.uint32).astype(
        jnp.int32
    )[:, None]
    m = m.reshape(-1)
    if exc_idx.shape[0]:
        # sparse precomputed corrections (see the encoder) applied from
        # each exception onward via a second segmented cumsum; int32
        # arithmetic is mod-2^32, matching the uint32 code space
        corr = jnp.zeros(n_seg * _DELTA_CHUNK, jnp.int32).at[
            jnp.asarray(exc_idx, jnp.int32)
        ].add(jnp.asarray(exc_corr, jnp.uint32).astype(jnp.int32))
        m = m + jnp.cumsum(
            corr.reshape(n_seg, _DELTA_CHUNK), axis=1
        ).reshape(-1)
    m = m.astype(jnp.uint32)[:n]

    def unspread(v):
        v = v & jnp.uint32(0x55555555)
        v = (v | (v >> 1)) & jnp.uint32(0x33333333)
        v = (v | (v >> 2)) & jnp.uint32(0x0F0F0F0F)
        v = (v | (v >> 4)) & jnp.uint32(0x00FF00FF)
        v = (v | (v >> 8)) & jnp.uint32(0x0000FFFF)
        return v

    x_q = unspread(m).astype(jnp.int32)
    y_q = unspread(m >> jnp.uint32(1)).astype(jnp.int32)
    return x_q, y_q
