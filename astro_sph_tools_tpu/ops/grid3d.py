"""3D voxel gridding: SPH deposit generalized to (nz, ny, nx) cubes.

BASELINE config 3: "512^3 density/velocity cubes with per-particle smoothing
lengths and periodic wrapping". Same scatter-stencil architecture as
``deposit.py`` but with a K^3 voxel stencil and the full 3D kernel evaluated
at the true 3D radius. Grid value = sum_i value_i * W(|r_i|, h_i) — the
natural SPH density estimator when value=mass (gives mass density directly).

Periodic wrapping follows the reference's box convention
(`/root/reference/src/astro_sph_tools/tools/_periodic_box_manipulations.py`):
minimum-image distances, half-open [0, L) box.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from dataclasses import dataclass

from ..kernels.splines import get_kernel

Array = jax.Array

STENCIL_LEVELS_3D: tuple[int, ...] = (2, 4, 8, 16, 32)
_DEF_CHUNK_3D = 4096


@dataclass(frozen=True)
class GridSpec:
    """Static description of the output voxel grid.

    extent = (x0, x1, y0, y1, z0, z1); shape = (nz, ny, nx).
    """

    shape: tuple[int, int, int]
    extent: tuple[float, float, float, float, float, float]
    voxel_origin: str = "center"
    periodic_wrap: bool = False

    @property
    def voxel_size(self) -> tuple[float, float, float]:
        nz, ny, nx = self.shape
        x0, x1, y0, y1, z0, z1 = self.extent
        return ((z1 - z0) / nz, (y1 - y0) / ny, (x1 - x0) / nx)

    @property
    def sample_offset(self) -> float:
        if self.voxel_origin == "center":
            return 0.5
        if self.voxel_origin == "corner":
            return 0.0
        raise ValueError(f"voxel_origin must be 'center' or 'corner', got {self.voxel_origin!r}")


def voxel_frame(pos, spec: GridSpec):
    """Each particle's nearest voxel sample and its offset from it.

    Returns ``(c, d)``: ``c`` (N, 3) int32 voxel indices (x, y, z columns,
    unwrapped) and ``d`` (N, 3) f32 offsets from those samples in voxels,
    |d| <= 1/2. A NumPy ``pos`` is converted in f64 on the host, so ``d``
    carries ~2^-25 voxel of rounding at any grid size (a sub-voxel h then
    holds the 1e-5 budget); device arrays are converted in f32, with
    ~2^-24 n voxel of rounding on an n-voxel axis.
    """
    x0, _, y0, _, z0, _ = spec.extent
    vz, vy, vx = spec.voxel_size
    xp = np if isinstance(pos, np.ndarray) else jnp
    if xp is np:
        pos = pos.astype(np.float64)
    u = (pos - xp.asarray([x0, y0, z0])) / xp.asarray([vx, vy, vz])
    u = u - spec.sample_offset
    c = xp.floor(u + 0.5)
    return c.astype(xp.int32), (u - c).astype(xp.float32)


@partial(
    jax.jit,
    static_argnames=(
        "K", "shape", "voxel_size", "periodic", "kernel_name", "chunk",
        "grid_nz",
    ),
)
def _stencil_level_pass_3d(
    grid_flat: Array,  # (grid_nz*ny*nx, F)
    c: Array,  # (M, 3) int32 nearest voxel sample (voxel_frame)
    d: Array,  # (M, 3) offset from it, in voxels
    h: Array,
    values: Array,  # (M, F)
    plane0=0,  # z plane of `shape` held by the grid's first plane
    *,
    K: int,
    shape: tuple[int, int, int],
    voxel_size: tuple[float, float, float],  # (z, y, x), as GridSpec
    periodic: bool | tuple[bool, bool, bool],
    kernel_name: str,
    chunk: int,
    grid_nz: Optional[int] = None,
) -> Array:
    """K^3 stencil scatter-add of M particles, each given in its own voxel
    frame (:func:`voxel_frame`), so the f32 distances carry no rounding of
    a global coordinate. The grid may hold only ``grid_nz`` of the cube's
    z planes, from ``plane0`` on (a slab); a slab then holds exactly the
    cube's values."""
    # periodic may be per-axis (x, y, z): the slab-sharded deposit wraps x/y
    # locally while z is handled by the ppermute halo ring.
    if isinstance(periodic, bool):
        periodic = (periodic,) * 3
    per_x, per_y, per_z = periodic
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    nz, ny, nx = shape
    psz, psy, psx = voxel_size
    dtype = grid_flat.dtype

    n = h.shape[0]
    n_chunks = n // chunk
    reshape = lambda a: a.reshape(n_chunks, chunk, *a.shape[1:])
    ks = jnp.arange(K, dtype=jnp.int32) - K // 2
    size = jnp.asarray([psx, psy, psz], dtype)

    def body(grid, inputs):
        cc, cd, ch, cvals = inputs
        j = cc[:, :, None] + ks  # (C, 3, K) voxel indices, x/y/z
        dp = (ks.astype(dtype) - cd[:, :, None]) * size[:, None]
        jx, jy, jz = j[:, 0], j[:, 1], j[:, 2]
        dxp, dyp, dzp = dp[:, 0], dp[:, 1], dp[:, 2]
        # (C, Kz, Ky, Kx)
        r2 = (
            dzp[:, :, None, None] ** 2
            + dyp[:, None, :, None] ** 2
            + dxp[:, None, None, :] ** 2
        )
        support = S * ch
        inside = r2 < (support * support)[:, None, None, None]
        weights = kernel.w(jnp.sqrt(r2), ch[:, None, None, None])
        weights = jnp.where(inside, weights, 0.0).astype(dtype)

        def axis_index(j, n_ax, per):
            if per:
                return jnp.mod(j, n_ax), jnp.ones(j.shape, bool)
            return jnp.clip(j, 0, n_ax - 1), (j >= 0) & (j < n_ax)

        fx, in_x = axis_index(jx, nx, per_x)
        fy, in_y = axis_index(jy, ny, per_y)
        fz, in_z = axis_index(jz - plane0, grid_nz or nz, per_z)
        valid = in_z[:, :, None, None] & in_y[:, None, :, None] & in_x[:, None, None, :]
        weights = jnp.where(valid, weights, 0.0)
        flat = (
            fz[:, :, None, None] * (ny * nx)
            + fy[:, None, :, None] * nx
            + fx[:, None, None, :]
        )

        updates = weights[..., None] * cvals[:, None, None, None, :]
        grid = grid.at[flat.reshape(-1)].add(
            updates.reshape(-1, updates.shape[-1]), mode="drop"
        )
        return grid, None

    grid_flat, _ = jax.lax.scan(
        body, grid_flat, (reshape(c), reshape(d), reshape(h), reshape(values))
    )
    return grid_flat


@partial(jax.jit, static_argnames=("shape", "extent", "offset", "periodic", "kernel_name", "tile"))
def _dense_pass_3d(
    grid_flat: Array,
    x: Array,
    y: Array,
    z: Array,
    h: Array,
    values: Array,
    *,
    shape: tuple[int, int, int],
    extent: tuple[float, ...],
    offset: float,
    periodic: bool,
    kernel_name: str,
    tile: int = 4,
) -> Array:
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    nz, ny, nx = shape
    x0, x1, y0, y1, z0, z1 = extent
    dtype = grid_flat.dtype
    Lx, Ly, Lz = x1 - x0, y1 - y0, z1 - z0

    xs = (x0 + (jnp.arange(nx, dtype=dtype) + offset) * (Lx / nx)).reshape(1, 1, 1, nx)
    ys = (y0 + (jnp.arange(ny, dtype=dtype) + offset) * (Ly / ny)).reshape(1, 1, ny, 1)
    zs = (z0 + (jnp.arange(nz, dtype=dtype) + offset) * (Lz / nz)).reshape(1, nz, 1, 1)

    m = x.shape[0]
    n_chunks = m // tile

    def body(grid, inputs):
        cx, cy, cz, ch, cvals = inputs
        dxp = xs - cx.reshape(tile, 1, 1, 1)
        dyp = ys - cy.reshape(tile, 1, 1, 1)
        dzp = zs - cz.reshape(tile, 1, 1, 1)
        if periodic:
            dxp = dxp - jnp.round(dxp / Lx) * Lx
            dyp = dyp - jnp.round(dyp / Ly) * Ly
            dzp = dzp - jnp.round(dzp / Lz) * Lz
        r2 = dxp * dxp + dyp * dyp + dzp * dzp
        support = S * ch
        inside = r2 < (support * support).reshape(tile, 1, 1, 1)
        w = kernel.w(jnp.sqrt(r2), ch.reshape(tile, 1, 1, 1))
        w = jnp.where(inside, w, 0.0).astype(dtype)
        # HIGHEST: a GPU f32 einsum may otherwise run in TF32
        contrib = jnp.einsum(
            "pzyx,pf->zyxf", w, cvals.astype(dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        return grid + contrib.reshape(nz * ny * nx, -1), None

    grid_flat, _ = jax.lax.scan(
        body,
        grid_flat,
        (
            x.reshape(n_chunks, tile),
            y.reshape(n_chunks, tile),
            z.reshape(n_chunks, tile),
            h.reshape(n_chunks, tile),
            values.reshape(n_chunks, tile, -1),
        ),
    )
    return grid_flat


def _pad_to_multiple_3d(arrays: Sequence[np.ndarray], h_index: int, multiple: int):
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


def deposit_3d(
    pos,
    h,
    values,
    spec: GridSpec,
    *,
    kernel: str = "cubic_spline",
    dtype=jnp.float32,
    chunk: int = _DEF_CHUNK_3D,
    grid: Optional[Array] = None,
) -> Array:
    """Deposit particles onto a 3D voxel grid.

    pos : (N, 3) world coordinates (x, y, z columns).
    values : (N,) or (N, F) payloads; grid value is sum_i value_i * W(r_i, h_i).
    Returns (nz, ny, nx) or (nz, ny, nx, F).
    """
    pos = np.asarray(pos)
    h_np = np.asarray(h)
    values = np.asarray(values)
    single_field = values.ndim == 1
    if single_field:
        values = values[:, None]

    kspec = get_kernel(kernel)
    nz, ny, nx = spec.shape
    if grid is None:
        grid_flat = jnp.zeros((nz * ny * nx, values.shape[1]), dtype=dtype)
    else:
        grid_flat = jnp.asarray(grid, dtype=dtype).reshape(nz * ny * nx, -1)

    # level binning on the smallest voxel edge
    s_vox = kspec.support_factor * h_np / min(spec.voxel_size)
    needed = 2.0 * s_vox + 2.0
    levels = np.searchsorted(np.asarray(STENCIL_LEVELS_3D), needed, side="left")

    frame_c, frame_d = voxel_frame(pos, spec)
    for li, K in enumerate(STENCIL_LEVELS_3D):
        idx = np.nonzero(levels == li)[0]
        if idx.size == 0:
            continue
        level_chunk = max(64, min(chunk, chunk * 512 // (K * K * K)))
        cs, ds, hs, vs = _pad_to_multiple_3d(
            [frame_c[idx], frame_d[idx], h_np[idx], values[idx]],
            h_index=2,
            multiple=level_chunk,
        )
        grid_flat = _stencil_level_pass_3d(
            grid_flat,
            jnp.asarray(cs),
            jnp.asarray(ds, dtype=dtype),
            jnp.asarray(hs, dtype=dtype),
            jnp.asarray(vs, dtype=dtype),
            K=int(K),
            chunk=level_chunk,
            shape=spec.shape,
            voxel_size=spec.voxel_size,
            periodic=spec.periodic_wrap,
            kernel_name=kernel,
        )

    oversize = np.nonzero(levels >= len(STENCIL_LEVELS_3D))[0]
    if oversize.size:
        tile = 4
        xs, ys, zs, hs, vs = _pad_to_multiple_3d(
            [pos[oversize, 0], pos[oversize, 1], pos[oversize, 2], h_np[oversize], values[oversize]],
            h_index=3,
            multiple=tile,
        )
        grid_flat = _dense_pass_3d(
            grid_flat,
            jnp.asarray(xs, dtype=dtype),
            jnp.asarray(ys, dtype=dtype),
            jnp.asarray(zs, dtype=dtype),
            jnp.asarray(hs, dtype=dtype),
            jnp.asarray(vs, dtype=dtype),
            tile=tile,
            shape=spec.shape,
            extent=tuple(float(v) for v in spec.extent),
            offset=spec.sample_offset,
            periodic=spec.periodic_wrap,
            kernel_name=kernel,
        )

    out = grid_flat.reshape(nz, ny, nx, -1)
    return out[..., 0] if single_field else out


def deposit_3d_auto(pos, h, values, spec: GridSpec, *, kernel: str = "cubic_spline"):
    """Field-first form of :func:`deposit_3d`: ``values`` (N,) or (F, N);
    returns (nz, ny, nx) or (F, nz, ny, nx)."""
    values = np.asarray(values)
    if values.ndim == 1:
        return deposit_3d(pos, h, values, spec, kernel=kernel)
    return jnp.moveaxis(deposit_3d(pos, h, values.T, spec, kernel=kernel), -1, 0)
