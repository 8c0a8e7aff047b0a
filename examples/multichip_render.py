"""Multi-device rendering tour: the mesh-sharded engines.

Shows the scaling story on any machine — run with a virtual 8-device CPU
mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_render.py

On a multi-GPU host the same code runs over the physical mesh: each device
holds a particle shard, the adaptive deposit runs per shard, and the map
stack reduces with one ``psum`` (the ``ArrayReorder_MPI`` / mpi4py layer of
the reference maps to ``shard_map`` + collectives; cf. the reference's
`tools/_ArrayReorder.py:262-656`).

Covered:
1. adaptive tiled deposit over the mesh
2. slab-sharded 3D voxel cube with ppermute halo exchange
3. distributed ID-matched reorder (the ArrayReorder_MPI replacement)
4. sharded sightline columns
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    n_dev = len(jax.devices())
    print(f"devices: {n_dev} ({jax.default_backend()})")

    from astro_sph_tools_tpu.ops.deposit import MapSpec
    from astro_sph_tools_tpu.ops.grid3d import GridSpec
    from astro_sph_tools_tpu.parallel import (
        deposit_2d_sharded,
        deposit_3d_sharded,
        distributed_reorder,
        make_mesh,
        pad_for_mesh,
    )
    from astro_sph_tools_tpu.parallel.sharded import partition_particles_by_slab
    from astro_sph_tools_tpu.parallel.sightlines import column_integrate_sharded

    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(11)
    box = 20.0

    # --- 1. the adaptive deposit over the mesh: snapshot-ordered
    # particles, adaptive h, one psum of the map stack ---
    n = 200_000
    spec = MapSpec(shape=(256, 256), extent=(0, box, 0, box), periodic_wrap=True)
    px = box / 256
    # crude Morton-ish coherence: sort by coarse cell so shards are local
    x = rng.uniform(0, box, n).astype(np.float32)
    y = rng.uniform(0, box, n).astype(np.float32)
    order = np.argsort((x // (16 * px)).astype(np.int64) * 1024 + (y // (16 * px)))
    x, y = x[order], y[order]
    h = np.exp(rng.normal(np.log(0.6 * px), 0.7, n)).clip(0.05 * px, 10 * px)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    t = rng.uniform(1e4, 1e6, n).astype(np.float32)
    fields = np.stack([m, m * t])

    xp, yp, hp, fp = pad_for_mesh(
        [x, y, h.astype(np.float32), fields.T], n_dev, 2048,
        pad_values=[box, box, 1.0, 0.0],
    )
    stack = jax.jit(
        lambda *a: deposit_2d_sharded(*a, spec, mesh, K=32)
    )(xp, yp, hp, fp)
    sigma, sig_t = np.moveaxis(np.asarray(stack), -1, 0)
    mean_t = np.where(sigma > 0, sig_t / np.maximum(sigma, 1e-30), 0.0)
    print(
        f"1. sharded adaptive deposit: stack {stack.shape}, "
        f"total mass-weight {sigma.sum() * px * px:.3e}, "
        f"mean-T map range [{mean_t[mean_t > 0].min():.3g}, {mean_t.max():.3g}] K"
    )

    # --- 2. 3D cube: slab-sharded along z, ppermute halo ring ---
    nz = 8 * n_dev
    gspec = GridSpec(
        shape=(nz, 64, 64), extent=(0, box, 0, box, 0, box), periodic_wrap=True
    )
    pos = rng.uniform(0, box, (50_000, 3)).astype(np.float32)
    h3 = rng.uniform(0.2, 0.8, 50_000).astype(np.float32)
    m3 = rng.uniform(0.5, 2.0, 50_000).astype(np.float32)
    pp, hp3, mp3 = partition_particles_by_slab(pos, h3, m3, gspec, n_dev, chunk=512)
    cube = deposit_3d_sharded(
        jnp.asarray(pp), jnp.asarray(hp3), jnp.asarray(mp3), gspec, mesh,
        K=4, chunk=512,
    )
    vox = (box / nz) * (box / 64) ** 2
    print(
        f"2. slab-sharded 3D cube {cube.shape}: "
        f"mass {float(cube.sum()) * vox:.4g} vs true {m3.sum():.4g}"
    )

    # --- 3. distributed ID-matched reorder over the mesh ---
    n_ids = n_dev * 4096
    src_ids = rng.permutation(n_ids).astype(np.int32)
    tgt_ids = rng.permutation(n_ids).astype(np.int32)
    data = rng.normal(size=n_ids).astype(np.float32)
    out, matched, overflow = distributed_reorder(
        jnp.asarray(src_ids), jnp.asarray(data), jnp.asarray(tgt_ids), mesh
    )
    ok = np.array_equal(
        np.asarray(out), data[np.argsort(src_ids)][np.argsort(np.argsort(tgt_ids))]
    )
    print(f"3. distributed reorder: matched={bool(matched.all())}, exact={ok}")

    # --- 4. sightline columns, data-parallel over particle shards ---
    n_rays = 64
    rx = rng.uniform(0, box, n_rays)
    ry = rng.uniform(0, box, n_rays)
    edges = np.linspace(0, n, n_dev + 1).astype(int)
    shards = [
        (x[a:b], y[a:b], h[a:b].astype(np.float32), m[a:b])
        for a, b in zip(edges[:-1], edges[1:])
    ]
    cols = np.asarray(
        column_integrate_sharded(
            shards, rx, ry, periodic_box=box, devices=list(mesh.devices.flat)
        )
    )
    print(f"4. sharded sightlines: {n_rays} columns, median {np.median(cols):.3g}")


if __name__ == "__main__":
    main()
