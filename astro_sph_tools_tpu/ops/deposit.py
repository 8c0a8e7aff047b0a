"""SPH particle -> pixel/voxel deposition (the framework's hot path).

This inverts the reference's per-pixel *gather* design
(`/root/reference/src/astro_sph_tools/tools/projections/_projector.py:13-73` +
`_pixel_calculations.pyx:9-36`, complexity O(N_pix * N_particles)) into a
particle-*scatter* design: each particle touches only the pixels inside its
kernel support, evaluated on a static K x K stencil and accumulated with one
fused scatter-add per particle chunk. Complexity O(N_particles * footprint).

Numerics preserved from the reference:
- map value = sum_i value_i * W(r_i, h_i) where r_i is the distance from the
  pixel sample point to the particle **projected** onto the image plane and W
  is the 3D-normalised kernel (`_pixel_calculations.pyx:32-34`) — selectable
  as ``projection="kernel3d"`` (default, reference parity). The physically
  line-integrated column kernel is available as ``projection="integrated"``.
- candidate mask ``r^2 < (support_factor * h)^2`` (`_pixel_calculations.pyx:31`).
- pixel sample points at ``min + index * pixel_size`` in reference-parity
  mode (``pixel_origin="corner"``, `_pixel_calculations.pyx:11-14`); the
  default ``"center"`` samples at ``min + (index + 1/2) * pixel_size``.

Device mapping: stencil evaluation is branch-free elementwise work over
(chunk, K, K) blocks; the scatter-add is a single XLA scatter per chunk with
mode='drop' for out-of-image updates. Adaptive smoothing lengths (EAGLE h
spans ~4 dex) are handled by *support-level binning*: particles are
partitioned by footprint into stencil levels K in {2,4,8,...}, one compiled
pass per level, so a huge-h particle never inflates the stencil of millions of
small-h ones (SURVEY.md §7.3).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.splines import (
    KernelSpec,
    get_kernel,
    integrated_kernel_lookup,
    integrated_kernel_table,
)

Array = jax.Array

# Stencil side lengths available to the level binner. A particle whose kernel
# support spans s pixels (radius, in pixel units) fits level K if 2*s + 2 <= K.
STENCIL_LEVELS: tuple[int, ...] = (2, 4, 8, 16, 32, 64)
# Particles whose footprint exceeds the largest stencil go through the dense
# (whole-image) path; they are vanishingly rare in real snapshots.
MAX_STENCIL = STENCIL_LEVELS[-1]

_DEF_CHUNK = 32 * 1024


@dataclass(frozen=True)
class MapSpec:
    """Static description of the output image grid.

    extent = (x_min, x_max, y_min, y_max) in world units; shape = (ny, nx).
    ``pixel_origin="center"`` samples pixel centres; ``"corner"`` reproduces
    the reference's ``min + index * pixel_size`` convention.
    """

    shape: tuple[int, int]
    extent: tuple[float, float, float, float]
    pixel_origin: str = "center"
    periodic_wrap: bool = False

    @property
    def pixel_size(self) -> tuple[float, float]:
        ny, nx = self.shape
        x0, x1, y0, y1 = self.extent
        return ((y1 - y0) / ny, (x1 - x0) / nx)

    @property
    def sample_offset(self) -> float:
        if self.pixel_origin == "center":
            return 0.5
        if self.pixel_origin == "corner":
            return 0.0
        raise ValueError(f"pixel_origin must be 'center' or 'corner', got {self.pixel_origin!r}")


def _eval_weights(kernel: KernelSpec, projection: str, lut: Optional[Array], r: Array, h: Array) -> Array:
    if projection == "kernel3d":
        return kernel.w(r, h)
    if projection == "integrated":
        return integrated_kernel_lookup(lut, r, h, kernel.support_factor)
    raise ValueError(f"projection must be 'kernel3d' or 'integrated', got {projection!r}")


def _stencil_scan(
    image_flat: Array,  # (ny*nx, F) accumulator
    u: Array,  # (M,) pixel-space x (padded)
    v: Array,  # (M,) pixel-space y (padded)
    h: Array,  # (M,) smoothing length (padded with 1.0)
    values: Array,  # (M, F) deposit payloads (padded with 0)
    lut: Optional[Array],
    origin: Optional[tuple[Array, Array]],
    *,
    K: int,
    shape: tuple[int, int],
    pixel_size: tuple[float, float],  # (psx, psy) world units per pixel
    offset: float,
    periodic: bool,
    kernel_name: str,
    projection: str,
    chunk: int,
) -> Array:
    """Scatter-add a K x K stencil per particle into the flat image.

    ``u, v`` are pixel coordinates measured from ``origin`` — per-particle
    integer pixel offsets ``(ox, oy)``, or None for the map's own origin.
    A tile-local frame keeps sub-pixel positions exact in f32 where global
    pixel coordinates at 1024^2 would carry ~6e-5 px of rounding.
    """
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    ny, nx = shape
    psx, psy = pixel_size
    dtype = image_flat.dtype

    n = u.shape[0]
    n_chunks = n // chunk
    rs = lambda a: a.reshape(n_chunks, chunk, *a.shape[1:])
    if origin is None:
        origin = (jnp.zeros((n,), jnp.int32),) * 2
    ks = jnp.arange(K, dtype=jnp.int32)

    def body(img, inputs):
        cu, cv, cox, coy, ch, cvals = inputs
        # centered K-window around the nearest sample point
        jx0 = jnp.floor(cu - offset + 0.5).astype(jnp.int32) - (K // 2)
        jy0 = jnp.floor(cv - offset + 0.5).astype(jnp.int32) - (K // 2)
        jx = jx0[:, None] + ks[None, :]  # (C, K)
        jy = jy0[:, None] + ks[None, :]
        dxp = ((jx.astype(dtype) + offset) - cu[:, None]) * psx  # world-units
        dyp = ((jy.astype(dtype) + offset) - cv[:, None]) * psy
        r2 = dyp[:, :, None] ** 2 + dxp[:, None, :] ** 2  # (C, Ky, Kx)
        support = S * ch
        inside = r2 < (support * support)[:, None, None]
        r = jnp.sqrt(r2)
        w = _eval_weights(kernel, projection, lut, r, ch[:, None, None])
        w = jnp.where(inside, w, 0.0).astype(dtype)

        gx = jx + cox[:, None]
        gy = jy + coy[:, None]
        if periodic:
            flat = jnp.mod(gy, ny)[:, :, None] * nx + jnp.mod(gx, nx)[:, None, :]
        else:
            in_x = (gx >= 0) & (gx < nx)
            in_y = (gy >= 0) & (gy < ny)
            valid = in_y[:, :, None] & in_x[:, None, :]
            w = jnp.where(valid, w, 0.0)
            # out-of-range flat index -> dropped by scatter mode='drop'
            flat = jnp.where(
                valid,
                jnp.clip(gy, 0, ny - 1)[:, :, None] * nx + jnp.clip(gx, 0, nx - 1)[:, None, :],
                -1,
            )

        updates = w[..., None] * cvals[:, None, None, :]  # (C, Ky, Kx, F)
        img = img.at[flat.reshape(-1)].add(
            updates.reshape(-1, updates.shape[-1]), mode="drop"
        )
        return img, None

    image_flat, _ = jax.lax.scan(
        body, image_flat,
        (rs(u), rs(v), rs(origin[0]), rs(origin[1]), rs(h), rs(values)),
    )
    return image_flat


@partial(
    jax.jit,
    static_argnames=(
        "K", "shape", "extent", "offset", "periodic", "kernel_name", "projection", "chunk",
    ),
)
def _stencil_level_pass(
    image_flat: Array,  # (ny*nx, F) accumulator
    x: Array,  # (M,) world x (padded)
    y: Array,  # (M,) world y (padded)
    h: Array,  # (M,) smoothing length (padded with 1.0)
    values: Array,  # (M, F) deposit payloads (padded with 0)
    lut: Optional[Array],
    *,
    K: int,
    shape: tuple[int, int],
    extent: tuple[float, float, float, float],
    offset: float,
    periodic: bool,
    kernel_name: str,
    projection: str,
    chunk: int,
) -> Array:
    """Deposit M particles with a K x K stencil into the flat image."""
    ny, nx = shape
    x0, x1, y0, y1 = extent
    psx = (x1 - x0) / nx
    psy = (y1 - y0) / ny
    return _stencil_scan(
        image_flat, (x - x0) / psx, (y - y0) / psy, h, values, lut, None,
        K=K, shape=shape, pixel_size=(psx, psy), offset=offset,
        periodic=periodic, kernel_name=kernel_name, projection=projection,
        chunk=chunk,
    )


@partial(
    jax.jit,
    static_argnames=("shape", "extent", "offset", "periodic", "kernel_name", "projection", "tile"),
)
def _dense_pass(
    image_flat: Array,
    x: Array,
    y: Array,
    h: Array,
    values: Array,  # (M, F)
    lut: Optional[Array],
    *,
    shape: tuple[int, int],
    extent: tuple[float, float, float, float],
    offset: float,
    periodic: bool,
    kernel_name: str,
    projection: str,
    tile: int = 8,
) -> Array:
    """Whole-image deposit for oversize-footprint particles (rare).

    Processes ``tile`` particles at a time against the full pixel grid —
    O(M * ny * nx) but M is tiny. With ``periodic`` the minimum-image
    convention is applied per axis.
    """
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    ny, nx = shape
    x0, x1, y0, y1 = extent
    psx = (x1 - x0) / nx
    psy = (y1 - y0) / ny
    dtype = image_flat.dtype
    Lx = x1 - x0
    Ly = y1 - y0

    xs = (x0 + (jnp.arange(nx, dtype=dtype) + offset) * psx).reshape(1, 1, nx)
    ys = (y0 + (jnp.arange(ny, dtype=dtype) + offset) * psy).reshape(1, ny, 1)

    m = x.shape[0]
    n_chunks = m // tile

    def body(img, inputs):
        cx, cy, ch, cvals = inputs
        dxp = xs - cx.reshape(tile, 1, 1)
        dyp = ys - cy.reshape(tile, 1, 1)
        if periodic:
            dxp = dxp - jnp.round(dxp / Lx) * Lx
            dyp = dyp - jnp.round(dyp / Ly) * Ly
        r2 = dxp * dxp + dyp * dyp
        support = S * ch
        inside = r2 < (support * support).reshape(tile, 1, 1)
        w = _eval_weights(kernel, projection, lut, jnp.sqrt(r2), ch.reshape(tile, 1, 1))
        w = jnp.where(inside, w, 0.0).astype(dtype)
        # HIGHEST: a GPU f32 einsum may otherwise run in TF32 (~3 decimal
        # digits), far outside the 1e-5 map budget
        contrib = jnp.einsum(
            "pyx,pf->yxf", w, cvals.astype(dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        return img + contrib.reshape(ny * nx, -1), None

    image_flat, _ = jax.lax.scan(
        body,
        image_flat,
        (
            x.reshape(n_chunks, tile),
            y.reshape(n_chunks, tile),
            h.reshape(n_chunks, tile),
            values.reshape(n_chunks, tile, -1),
        ),
    )
    return image_flat


def _pad_to_multiple(arrays: Sequence[np.ndarray], multiple: int, h_index: int = 2):
    """Pad leading axes to a chunk multiple; the smoothing-length array
    (``h_index``) is padded with 1.0 to avoid division by zero."""
    n = arrays[0].shape[0]
    padded_n = max(multiple, ((n + multiple - 1) // multiple) * multiple)
    out = []
    for i, a in enumerate(arrays):
        pad = padded_n - n
        if pad == 0:
            out.append(a)
        else:
            pad_width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            out.append(np.pad(a, pad_width, constant_values=1.0 if i == h_index else 0.0))
    return out


def bin_particles_by_footprint(
    h: np.ndarray, pixel_size: tuple[float, float], support_factor: float
) -> tuple[list[np.ndarray], np.ndarray]:
    """Partition particle indices by stencil level.

    Returns (per-level index arrays aligned with STENCIL_LEVELS, oversize
    index array). Host-side (NumPy): the level histogram determines array
    shapes, which must be static for XLA.
    """
    s_pix = support_factor * h / min(pixel_size)
    needed = 2.0 * s_pix + 2.0
    levels = np.searchsorted(np.asarray(STENCIL_LEVELS), needed, side="left")
    per_level = [np.nonzero(levels == i)[0] for i in range(len(STENCIL_LEVELS))]
    oversize = np.nonzero(levels >= len(STENCIL_LEVELS))[0]
    return per_level, oversize


def deposit_2d(
    x,
    y,
    h,
    values,
    spec: MapSpec,
    *,
    kernel: str = "cubic_spline",
    projection: str = "kernel3d",
    dtype=jnp.float32,
    chunk: int = _DEF_CHUNK,
    image: Optional[Array] = None,
) -> Array:
    """Deposit particles onto a 2D map.

    Parameters
    ----------
    x, y : (N,) world-space in-plane coordinates (pre-projected: pick the two
        axes with ``CoordinateAxes.projection_plane``).
    h : (N,) smoothing lengths (same units).
    values : (N,) or (N, F) deposit payloads. The resulting map is
        ``sum_i values_i * W(r_i, h_i)`` per pixel.
    spec : the output grid description.
    kernel, projection : kernel family and 2D evaluation mode (see module doc).
    image : optional (ny, nx) or (ny, nx, F) accumulator to add into.

    Returns the (ny, nx) map, or (ny, nx, F) for multi-field input.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    h_np = np.asarray(h)
    values = np.asarray(values)
    single_field = values.ndim == 1
    if single_field:
        values = values[:, None]
    n_fields = values.shape[1]

    kspec = get_kernel(kernel)
    lut = (
        jnp.asarray(integrated_kernel_table(kernel), dtype=dtype)
        if projection == "integrated"
        else None
    )

    ny, nx = spec.shape
    if image is None:
        image_flat = jnp.zeros((ny * nx, n_fields), dtype=dtype)
    else:
        image_flat = jnp.asarray(image, dtype=dtype).reshape(ny * nx, -1)

    per_level, oversize = bin_particles_by_footprint(h_np, spec.pixel_size, kspec.support_factor)

    static = dict(
        shape=spec.shape,
        extent=tuple(float(v) for v in spec.extent),
        offset=spec.sample_offset,
        periodic=spec.periodic_wrap,
        kernel_name=kernel,
        projection=projection,
    )

    for K, idx in zip(STENCIL_LEVELS, per_level):
        if idx.size == 0:
            continue
        level_chunk = max(256, min(chunk, chunk * 64 // (K * K)))
        xs, ys, hs, vs = _pad_to_multiple(
            [x[idx], y[idx], h_np[idx], values[idx]], level_chunk
        )
        image_flat = _stencil_level_pass(
            image_flat,
            jnp.asarray(xs, dtype=dtype),
            jnp.asarray(ys, dtype=dtype),
            jnp.asarray(hs, dtype=dtype),
            jnp.asarray(vs, dtype=dtype),
            lut,
            K=int(K),
            chunk=level_chunk,
            **static,
        )

    if oversize.size:
        tile = 8
        xs, ys, hs, vs = _pad_to_multiple(
            [x[oversize], y[oversize], h_np[oversize], values[oversize]], tile
        )
        image_flat = _dense_pass(
            image_flat,
            jnp.asarray(xs, dtype=dtype),
            jnp.asarray(ys, dtype=dtype),
            jnp.asarray(hs, dtype=dtype),
            jnp.asarray(vs, dtype=dtype),
            lut,
            tile=tile,
            **static,
        )

    image = image_flat.reshape(ny, nx, n_fields)
    return image[..., 0] if single_field else image


def deposit_2d_fixed_h(
    x: Array,
    y: Array,
    h: Array,
    values: Array,
    spec: MapSpec,
    *,
    K: int,
    kernel: str = "cubic_spline",
    projection: str = "kernel3d",
    dtype=jnp.float32,
    chunk: int = _DEF_CHUNK,
) -> Array:
    """Fully-jittable single-level deposit (no host binning).

    Requires every particle's footprint to fit the static K x K stencil
    (``2 * support_factor * h / pixel_size + 2 <= K``); contributions outside
    the stencil are silently truncated. Use for bounded-h workloads and as the
    jittable flagship entry point. N must be a multiple of ``chunk``.
    """
    values = values if values.ndim == 2 else values[:, None]
    single_field = values.ndim == 2 and values.shape[1] == 1
    ny, nx = spec.shape
    lut = (
        jnp.asarray(integrated_kernel_table(kernel), dtype=dtype)
        if projection == "integrated"
        else None
    )
    image_flat = jnp.zeros((ny * nx, values.shape[1]), dtype=dtype)
    image_flat = _stencil_level_pass(
        image_flat,
        x.astype(dtype),
        y.astype(dtype),
        h.astype(dtype),
        values.astype(dtype),
        lut,
        K=K,
        shape=spec.shape,
        extent=tuple(float(v) for v in spec.extent),
        offset=spec.sample_offset,
        periodic=spec.periodic_wrap,
        kernel_name=kernel,
        projection=projection,
        chunk=chunk,
    )
    image = image_flat.reshape(ny, nx, -1)
    return image[..., 0] if single_field else image


def deposit_weighted_mean(
    x, y, h, quantity, weight, spec: MapSpec, floor: float = 0.0, **kwargs
) -> tuple[Array, Array]:
    """Weight-averaged map: returns (sum(w*q)/sum(w), sum(w)) per pixel.

    The two accumulators ride one deposit pass (multi-field payload), per
    SURVEY.md §7.2 step 6 (mass-weighted temperature maps).
    """
    quantity = np.asarray(quantity)
    weight = np.asarray(weight)
    fields = np.stack([weight * quantity, weight], axis=1)
    maps = deposit_2d(x, y, h, fields, spec, **kwargs)
    wq, w = maps[..., 0], maps[..., 1]
    mean = jnp.where(w > floor, wq / jnp.maximum(w, 1e-37), 0.0)
    return mean, w
