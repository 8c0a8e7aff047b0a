"""Multi-device sharded deposit on the 8-virtual-CPU mesh (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from astro_sph_tools_tpu.ops.deposit import MapSpec
from astro_sph_tools_tpu.ops.grid3d import GridSpec, deposit_3d
from astro_sph_tools_tpu.parallel.sharded import (
    deposit_2d_sharded,
    deposit_3d_sharded,
    make_mesh,
    pad_for_mesh,
    partition_particles_by_slab,
)
from oracles import project_oracle


def rel_err(got, expected):
    return np.abs(got - expected).max() / np.abs(expected).max()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


class TestSharded2D:
    @pytest.mark.parametrize("engine", ["pallas", "xla"])
    def test_matches_oracle(self, mesh, rng, engine):
        n = 5000
        box = 10.0
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        h = np.full(n, 0.22)
        m = rng.uniform(0.5, 2.0, n)
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
        chunk = 256
        xp, yp, hp, mp = pad_for_mesh([x, y, h, m], 8, chunk, pad_values=[0, 0, 1.0, 0])
        img = deposit_2d_sharded(
            jnp.asarray(xp, jnp.float32), jnp.asarray(yp, jnp.float32),
            jnp.asarray(hp, jnp.float32), jnp.asarray(mp, jnp.float32),
            spec, mesh, K=8, chunk=chunk, engine=engine,
        )
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent)
        assert rel_err(np.asarray(img), expected) < 1e-5

    @pytest.mark.parametrize("engine", ["pallas", "xla"])
    def test_jit_and_multifield(self, mesh, rng, engine):
        n = 2048
        box = 10.0
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        h = np.full(n, 0.2)
        m = rng.uniform(0.5, 2.0, n)
        t = rng.uniform(1e4, 1e6, n)
        fields = np.stack([m, m * t], axis=1)
        spec = MapSpec(shape=(32, 32), extent=(0.0, box, 0.0, box))
        chunk = 256
        xp, yp, hp, fp = pad_for_mesh([x, y, h, fields], 8, chunk, pad_values=[0, 0, 1.0, 0])

        @jax.jit
        def render(x_, y_, h_, f_):
            return deposit_2d_sharded(
                x_, y_, h_, f_, spec, mesh, K=8, chunk=chunk,
                engine=engine,
            )

        img = render(
            jnp.asarray(xp, jnp.float32), jnp.asarray(yp, jnp.float32),
            jnp.asarray(hp, jnp.float32), jnp.asarray(fp, jnp.float32),
        )
        assert img.shape == (32, 32, 2)
        exp0 = project_oracle(x, y, h, m, spec.shape, spec.extent)
        assert rel_err(np.asarray(img[..., 0]), exp0) < 1e-5

    @pytest.mark.parametrize("interpret", [False, True])
    def test_pallas_periodic_sharded(self, mesh, rng, interpret):
        n = 3000
        box = 8.0
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        x[:200] = rng.uniform(0, 0.05, 200)  # edge hugging
        h = np.full(n, 0.2)
        m = np.ones(n)
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box), periodic_wrap=True)
        xp, yp, hp, mp = pad_for_mesh([x, y, h, m], 8, 256, pad_values=[0, 0, 1.0, 0])
        img = deposit_2d_sharded(
            jnp.asarray(xp, jnp.float32), jnp.asarray(yp, jnp.float32),
            jnp.asarray(hp, jnp.float32), jnp.asarray(mp, jnp.float32),
            spec, mesh, K=8, engine="pallas", interpret=interpret,
        )
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent, periodic=True)
        assert rel_err(np.asarray(img), expected) < 1e-5


class TestShardedAdaptive:
    def test_mixed_footprints_match_oracle(self, mesh, rng):
        """Footprints spanning the K=8..32 levels in one sharded pass."""
        n, box = 4000, 8.0
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box), periodic_wrap=True)
        px = box / 64
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        h = 10.0 ** rng.uniform(-0.5, 0.8, n) * px
        m = rng.uniform(0.5, 2.0, n)
        xp, yp, hp, mp = pad_for_mesh([x, y, h, m], 8, 256, pad_values=[0, 0, 1.0, 0])
        img = deposit_2d_sharded(
            jnp.asarray(xp, jnp.float32), jnp.asarray(yp, jnp.float32),
            jnp.asarray(hp, jnp.float32), jnp.asarray(mp, jnp.float32),
            spec, mesh, K=32,
        )
        expected = project_oracle(x, y, h, m, spec.shape, spec.extent, periodic=True)
        assert rel_err(np.asarray(img), expected) < 1e-5


class TestSharded3D:
    # the slab-sharded deposit's one engine: XLA's K-stencil scatter pass
    @pytest.mark.parametrize("engine", ["xla"])
    def test_matches_single_device(self, mesh, rng, engine):
        n = 3000
        box = 8.0
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        # K=4 stencil: support 2h must stay within (K-2)/2 = 1 voxel (0.25)
        h = np.full(n, 0.11, np.float32)
        m = rng.uniform(0.5, 2.0, n).astype(np.float32)
        spec = GridSpec(shape=(32, 24, 24), extent=(0.0, box, 0.0, box, 0.0, box))
        chunk = 256
        pp, hp, mp = partition_particles_by_slab(pos, h, m, spec, 8, chunk=chunk)
        grid = deposit_3d_sharded(pp, hp, mp, spec, mesh, K=4, chunk=chunk)
        expected = np.asarray(deposit_3d(pos, h, m, spec, chunk=512))
        assert grid.shape == spec.shape
        assert rel_err(np.asarray(grid), expected) < 1e-5

    # the slab-sharded deposit's one engine: XLA's K-stencil scatter pass
    @pytest.mark.parametrize("engine", ["xla"])
    def test_periodic_slabs(self, mesh, rng, engine):
        n = 1500
        box = 8.0
        # edge-hugging particles in EVERY axis: x/y wrap inside the shard,
        # z wraps via the ppermute ring (ADVICE r1 #1 regression)
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        pos[:100, 2] = rng.uniform(0, 0.05, 100)
        pos[100:200, 0] = rng.uniform(0, 0.02, 100)
        pos[200:300, 1] = rng.uniform(box - 0.02, box, 100).astype(np.float32)
        h = np.full(n, 0.11, np.float32)
        m = np.ones(n, np.float32)
        spec = GridSpec(
            shape=(32, 16, 16), extent=(0.0, box, 0.0, box, 0.0, box), periodic_wrap=True
        )
        chunk = 256
        pp, hp, mp = partition_particles_by_slab(pos, h, m, spec, 8, chunk=chunk)
        grid = deposit_3d_sharded(pp, hp, mp, spec, mesh, K=4, chunk=chunk)
        expected = np.asarray(deposit_3d(pos, h, m, spec, chunk=512))
        assert rel_err(np.asarray(grid), expected) < 1e-5


class TestShardedHaloMaps:
    """Config-5 shape: catalogue centres -> cutouts -> sharded tiled render."""

    def test_matches_oracle(self, mesh, rng):
        from astro_sph_tools_tpu.ops.periodic import shift_centre
        from astro_sph_tools_tpu.render import render_halo_maps_sharded

        box = 16.0
        n = 4000
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        h = np.full(n, 0.15, np.float32)
        m = rng.uniform(0.5, 2.0, n).astype(np.float32)
        centres = rng.uniform(0, box, (3, 3)).astype(np.float32)
        radii = np.array([1.2, 0.8, 1.5], np.float32)
        stacks = render_halo_maps_sharded(
            pos, h, m, centres, radii, [0, 2], mesh, box=box, resolution=64,
        )
        for k, hi in enumerate([0, 2]):
            rc = np.asarray(shift_centre(pos, centres[hi], box))
            hw = 2.0 * radii[hi]
            lo, hiw = box / 2 - hw, box / 2 + hw
            exp = project_oracle(rc[:, 0], rc[:, 1], h, m, (64, 64), (lo, hiw, lo, hiw))
            assert rel_err(stacks[k]["surface_density"], exp) < 1e-5
