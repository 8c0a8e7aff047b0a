"""Multi-device deposit: particle sharding, psum-reduced maps, slab halo exchange.

The mesh-parallel replacement for the reference's MPI data parallelism
(SURVEY.md §2.8): instead of ``pyread_eagle.split_selection`` + mpi4py
collectives, particles are sharded over a ``jax.sharding.Mesh`` axis and the
render step runs under ``shard_map`` with XLA collectives (NCCL between GPUs):

- **2D maps** (``deposit_2d_sharded``): each device deposits its particle
  shard onto a device-local image; one ``psum`` over the mesh axis reduces
  the overlap. The image (at most a few MB) is replicated, so there is no
  spatial decomposition to manage.
- **3D voxel cubes** (``deposit_3d_sharded``): a 512^3 f32 cube is ~0.5 GB —
  the grid itself must be sharded. Each device owns a z-slab plus a 2h-wide
  halo ring; after the local deposit the halo rings travel to the
  neighbouring slabs via ``lax.ppermute`` (the rebuild's analogue of the
  reference's periodic region splitting, `_SnapshotEAGLE.py:270-296`) and
  are accumulated.

Everything here is a pure ``jit``-able function over a mesh — the
``dryrun_multichip`` entry compiles it on an N-virtual-device CPU mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.deposit import MapSpec, _stencil_level_pass
from ..ops.deposit_pallas import (
    _ALIGN,
    PALLAS_LEVELS,
    deposit_levels_traced,
)
from ..ops.grid3d import GridSpec, _stencil_level_pass_3d, voxel_frame

Array = jax.Array


def _pallas_level_for_K(K: int):
    """Smallest tiled-deposit level whose column window hosts a K footprint."""
    for cfg in PALLAS_LEVELS:
        if cfg.K >= K:
            return cfg
    raise ValueError(f"no tiled level hosts K={K} (max {PALLAS_LEVELS[-1].K})")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """A 1-D device mesh over the particle (data-parallel) axis."""
    devices = np.asarray(jax.devices()[: n_devices or len(jax.devices())])
    return Mesh(devices, (axis_name,))


def _local_deposit_2d(
    x, y, h, values, *, K, spec_static, kernel_name, projection, chunk, n_fields, axis_name
):
    shape = spec_static["shape"]
    image_flat = jnp.zeros((shape[0] * shape[1], n_fields), jnp.float32)
    # under shard_map the scan carry must share the inputs' varying type
    image_flat = jax.lax.pcast(image_flat, (axis_name,), to="varying")
    return _stencil_level_pass(
        image_flat, x, y, h, values, None,
        K=K, chunk=chunk, kernel_name=kernel_name, projection=projection,
        **spec_static,
    )


def deposit_2d_sharded(
    x: Array,
    y: Array,
    h: Array,
    values: Array,  # (N,) or (N, F)
    spec: MapSpec,
    mesh: Mesh,
    *,
    K: int = 8,
    kernel: str = "cubic_spline",
    chunk: int = 8192,
    axis_name: str = "data",
    engine: str = "pallas",
    interpret: bool = False,
) -> Array:
    """Particle-sharded 2D deposit; returns the (ny, nx[, F]) reduced map.

    ``engine="pallas"`` (default) runs the adaptive tiled deposit on each
    shard — one sort into footprint levels up to the one hosting ``K``,
    then each level through the Triton kernel on a GPU or XLA's
    scatter-add on the CPU (see ``ops.deposit_pallas``); footprints wider
    than ``K`` are truncated to it. ``engine="xla"`` is the single-level
    K-stencil scatter pass, kept as the portable oracle. ``interpret`` runs
    the kernel in the Pallas interpreter (tests). Inputs must be padded to
    a multiple of ``mesh.size * chunk`` (pad with ``values = 0``,
    ``h = 1``). Jittable.
    """
    single = values.ndim == 1
    if single:
        values = values[:, None]
    n_fields = values.shape[1]
    spec_static = dict(
        shape=spec.shape,
        extent=tuple(float(v) for v in spec.extent),
        offset=spec.sample_offset,
        periodic=spec.periodic_wrap,
    )

    if engine == "pallas":
        max_level = _pallas_level_for_K(K)
        extent = spec_static["extent"]

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
            out_specs=P(),
            # pallas_call's out_shape carries no varying-mesh-axes annotation
            check_vma=False,
        )
        def step(xs, ys, hs, vs):
            # pad the shard to the layout granularity; padding parks at the
            # extent max with weight 0
            n = xs.shape[0]
            n_pad = -(-n // _ALIGN) * _ALIGN
            if n_pad != n:
                xs = jnp.pad(xs, (0, n_pad - n), constant_values=extent[1])
                ys = jnp.pad(ys, (0, n_pad - n), constant_values=extent[3])
                hs = jnp.pad(hs, (0, n_pad - n), constant_values=1.0)
                vs = jnp.pad(vs, ((0, n_pad - n), (0, 0)))
            img = deposit_levels_traced(
                xs, ys, hs, vs.T, spec, max_level=max_level, kernel=kernel,
                interpret=interpret,
            )  # (F, ny, nx)
            return jax.lax.psum(img, axis_name)

        image = jnp.moveaxis(step(x, y, h, values), 0, -1)
        return image[..., 0] if single else image

    if engine != "xla":
        raise ValueError(f"Unknown engine {engine!r} (pallas | xla)")

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=P(),
    )
    def step(xs, ys, hs, vs):
        local = _local_deposit_2d(
            xs, ys, hs, vs,
            K=K, spec_static=spec_static, kernel_name=kernel,
            projection="kernel3d", chunk=chunk, n_fields=n_fields,
            axis_name=axis_name,
        )
        return jax.lax.psum(local, axis_name)

    image_flat = step(x, y, h, values)
    ny, nx = spec.shape
    image = image_flat.reshape(ny, nx, n_fields)
    return image[..., 0] if single else image


def deposit_3d_sharded(
    pos: Array,  # (N, 3), already wrapped into the box
    h: Array,
    values: Array,  # (N,)
    spec: GridSpec,
    mesh: Mesh,
    *,
    K: int = 4,
    kernel: str = "cubic_spline",
    chunk: int = 2048,
    axis_name: str = "data",
) -> Array:
    """Slab-sharded 3D voxel deposit with ppermute halo exchange.

    The (nz, ny, nx) cube is decomposed into ``mesh.size`` z-slabs. Each
    device receives the particles whose *slab index* matches its mesh
    position (caller pre-sorts; see :func:`partition_particles_by_slab`),
    deposits into its slab extended by ``halo = K/2`` voxel planes on each
    side with the K-stencil scatter pass, then exchanges the halo planes
    with its ring neighbours via ``lax.ppermute`` and accumulates. Periodic
    in z when ``spec.periodic_wrap`` (the ring wraps naturally).

    A NumPy ``pos`` is put into voxel frames in f64 on the host, as
    :func:`~astro_sph_tools_tpu.ops.grid3d.deposit_3d` does, so the result
    matches the single-device cube to f32 summation order; device arrays
    (e.g. under ``jit``) are converted in f32 (see ``voxel_frame``).
    """
    nz, ny, nx = spec.shape
    n_dev = mesh.shape[axis_name]
    if nz % n_dev:
        raise ValueError(f"nz={nz} must divide over {n_dev} devices")
    slab = nz // n_dev
    halo = K // 2
    ext_shape = (slab + 2 * halo, ny, nx)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=P(axis_name),
        check_vma=False,
    )
    def step(c, d, hs, vs):
        idx = jax.lax.axis_index(axis_name)
        # the extended slab holds the cube's planes [idx*slab - halo, ...)
        # x/y wrap locally (each shard holds the full x/y extent); z spill is
        # carried by the extended-slab margins + ppermute ring below
        grid_flat = jnp.zeros((ext_shape[0] * ny * nx, 1), jnp.float32)
        grid_flat = jax.lax.pcast(grid_flat, (axis_name,), to="varying")
        grid_flat = _stencil_level_pass_3d(
            grid_flat, c, d, hs, vs[:, None], idx * slab - halo,
            K=K, shape=spec.shape, voxel_size=spec.voxel_size,
            periodic=(spec.periodic_wrap, spec.periodic_wrap, False),
            kernel_name=kernel, chunk=chunk, grid_nz=ext_shape[0],
        )
        ext = grid_flat.reshape(ext_shape[0], ny, nx)

        # halo exchange: my top halo planes belong to the next slab, bottom
        # to the previous; ring ppermute
        up = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        down = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        top = ext[slab + halo :]  # planes beyond my slab -> next device
        bottom = ext[:halo]  # planes before my slab -> previous device
        from_below = jax.lax.ppermute(top, axis_name, up)
        from_above = jax.lax.ppermute(bottom, axis_name, down)

        body = ext[halo : halo + slab]
        if spec.periodic_wrap:
            body = body.at[:halo].add(from_below)
            body = body.at[slab - halo :].add(from_above)
        else:
            # the ring wraps; edge devices must drop the wrapped halos
            # (they carry out-of-box contributions)
            keep_below = (idx != 0).astype(body.dtype)
            keep_above = (idx != n_dev - 1).astype(body.dtype)
            body = body.at[:halo].add(from_below * keep_below)
            body = body.at[slab - halo :].add(from_above * keep_above)
        return body

    c, d = voxel_frame(pos, spec)
    return step(c, d, jnp.asarray(h, jnp.float32), jnp.asarray(values, jnp.float32))


def partition_particles_by_slab(
    pos: np.ndarray, h: np.ndarray, values: np.ndarray, spec: GridSpec, n_dev: int,
    chunk: int = 2048,
):
    """Host-side: order particles by z-slab and pad each slab to the common
    per-device length (multiple of ``chunk``) so slab i occupies shard i.

    Returns (pos, h, values) ready for :func:`deposit_3d_sharded`.
    """
    nz = spec.shape[0]
    z0, z1 = spec.extent[4], spec.extent[5]
    slab_height = (z1 - z0) / n_dev
    slab_idx = np.clip(((pos[:, 2] - z0) / slab_height).astype(np.int64), 0, n_dev - 1)
    order = np.argsort(slab_idx, kind="stable")
    pos, h, values, slab_idx = pos[order], h[order], values[order], slab_idx[order]
    counts = np.bincount(slab_idx, minlength=n_dev)
    per_dev = int(np.ceil(counts.max() / chunk) * chunk)
    # positions keep their precision: deposit_3d_sharded converts them
    out_pos = np.zeros((n_dev * per_dev, 3), np.result_type(pos, np.float32))
    out_h = np.ones(n_dev * per_dev, np.float32)
    out_v = np.zeros(n_dev * per_dev, np.float32)
    start = 0
    for d in range(n_dev):
        n = counts[d]
        out_pos[d * per_dev : d * per_dev + n] = pos[start : start + n]
        out_h[d * per_dev : d * per_dev + n] = h[start : start + n]
        out_v[d * per_dev : d * per_dev + n] = values[start : start + n]
        start += n
    return out_pos, out_h, out_v


def pad_for_mesh(arrays, n_dev: int, chunk: int, pad_values=None):
    """Pad 1-D/2-D arrays to a multiple of ``n_dev * chunk`` along axis 0."""
    n = arrays[0].shape[0]
    unit = n_dev * chunk
    n_pad = max(unit, ((n + unit - 1) // unit) * unit)
    out = []
    for i, a in enumerate(arrays):
        fill = 0.0 if pad_values is None else pad_values[i]
        pad_width = [(0, n_pad - n)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(np.asarray(a), pad_width, constant_values=fill))
    return out
