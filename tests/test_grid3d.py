"""3D voxel gridding vs dense NumPy oracle (BASELINE config 3, scaled down)."""

import numpy as np
import pytest

from astro_sph_tools_tpu.ops.grid3d import GridSpec, deposit_3d
from oracles import grid3d_oracle


def rel_err(got, expected):
    return np.abs(got - expected).max() / np.abs(expected).max()


class TestDeposit3D:
    def test_matches_oracle(self, rng):
        n = 400
        pos = rng.uniform(0, 10.0, (n, 3))
        h = rng.uniform(0.4, 1.2, n)
        m = rng.uniform(0.5, 2.0, n)
        spec = GridSpec(shape=(16, 16, 16), extent=(0.0, 10.0, 0.0, 10.0, 0.0, 10.0))
        got = np.asarray(deposit_3d(pos, h, m, spec, chunk=512))
        expected = grid3d_oracle(pos, h, m, spec.shape, spec.extent)
        assert rel_err(got, expected) < 1e-5

    def test_periodic(self, rng):
        n = 200
        pos = rng.uniform(0, 10.0, (n, 3))
        pos[:30, 0] = rng.uniform(0, 0.3, 30)  # edge-hugging
        h = np.full(n, 0.8)
        m = np.ones(n)
        spec = GridSpec(
            shape=(12, 12, 12), extent=(0.0, 10.0, 0.0, 10.0, 0.0, 10.0), periodic_wrap=True
        )
        got = np.asarray(deposit_3d(pos, h, m, spec, chunk=512))
        expected = grid3d_oracle(pos, h, m, spec.shape, spec.extent, periodic=True)
        assert rel_err(got, expected) < 1e-5

    def test_mass_conservation(self, rng):
        """Volume integral of the density grid approximates total mass for
        well-resolved kernels away from edges."""
        n = 300
        pos = rng.uniform(3.0, 7.0, (n, 3))
        h = rng.uniform(0.5, 0.8, n)
        m = rng.uniform(0.5, 2.0, n)
        spec = GridSpec(shape=(48, 48, 48), extent=(0.0, 10.0, 0.0, 10.0, 0.0, 10.0))
        got = np.asarray(deposit_3d(pos, h, m, spec, chunk=512))
        voxel_volume = np.prod(spec.voxel_size)
        assert abs(got.sum() * voxel_volume / m.sum() - 1.0) < 2e-2

    def test_oversize_and_rect(self, rng):
        n = 40
        pos = rng.uniform(0, 10.0, (n, 3))
        h = np.full(n, 0.5)
        h[:3] = 6.0  # oversize footprint
        m = np.ones(n)
        spec = GridSpec(shape=(8, 12, 16), extent=(0.0, 10.0, 0.0, 10.0, 0.0, 10.0))
        got = np.asarray(deposit_3d(pos, h, m, spec, chunk=512))
        expected = grid3d_oracle(pos, h, m, spec.shape, spec.extent)
        assert rel_err(got, expected) < 1e-5

    def test_multifield_velocity_cube(self, rng):
        """Density + momentum cubes in one pass (config 3 'density/velocity')."""
        n = 200
        pos = rng.uniform(0, 10.0, (n, 3))
        h = rng.uniform(0.5, 1.0, n)
        m = rng.uniform(0.5, 2.0, n)
        vx = rng.normal(0, 100.0, n)
        fields = np.stack([m, m * vx], axis=1)
        spec = GridSpec(shape=(12, 12, 12), extent=(0.0, 10.0, 0.0, 10.0, 0.0, 10.0))
        got = np.asarray(deposit_3d(pos, h, fields, spec, chunk=512))
        exp_m = grid3d_oracle(pos, h, m, spec.shape, spec.extent)
        exp_mv = grid3d_oracle(pos, h, m * vx, spec.shape, spec.extent)
        assert rel_err(got[..., 0], exp_m) < 1e-5
        assert np.abs(got[..., 1] - exp_mv).max() / np.abs(exp_mv).max() < 1e-5


@pytest.mark.parametrize("periodic", [False, True])
def test_fast_oracle_matches_gather_oracle(periodic):
    """The particle-scatter f64 oracle (used at sizes the per-voxel gather
    cannot reach) agrees with the gather oracle."""
    from oracles import grid3d_oracle_fast

    rng = np.random.default_rng(5)
    box, n = 4.0, 300
    spec = GridSpec(shape=(12, 10, 8), extent=(0.0, box, 0.0, box, 0.0, box), periodic_wrap=periodic)
    pos = rng.uniform(-0.2, box + 0.2, (n, 3))
    if periodic:
        pos = pos % box
    h = rng.uniform(0.1, 0.9, n)
    m = rng.uniform(0.5, 2.0, n)
    exp = grid3d_oracle(pos, h, m, spec.shape, spec.extent, periodic=periodic)
    got = grid3d_oracle_fast(pos, h, m, spec.shape, spec.extent, periodic=periodic)
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-12 * np.abs(exp).max())


def test_deposit_3d_auto_is_field_first(rng):
    """The field-first entry point returns deposit_3d's fields, moved to
    the front."""
    from astro_sph_tools_tpu.ops.grid3d import deposit_3d_auto

    box, n = 4.0, 400
    spec = GridSpec(shape=(8, 8, 8), extent=(0.0, box, 0.0, box, 0.0, box))
    pos = rng.uniform(0, box, (n, 3))
    h = rng.uniform(0.2, 0.6, n)
    vals = rng.uniform(0.5, 2.0, (2, n))
    both = np.asarray(deposit_3d_auto(pos, h, vals, spec))
    assert both.shape == (2, 8, 8, 8)
    ref = np.asarray(deposit_3d(pos, h, vals.T, spec))
    np.testing.assert_array_equal(both, np.moveaxis(ref, -1, 0))
    single = np.asarray(deposit_3d_auto(pos, h, vals[0], spec))
    np.testing.assert_allclose(single, both[0], rtol=1e-6, atol=1e-6 * np.abs(single).max())


@pytest.mark.parametrize("plane0", [-2, 5, 12])
def test_slab_pass_matches_cube_planes(rng, plane0):
    """A slab filled in the cube's own frame (``plane0``, ``grid_nz``) holds
    exactly the cube's planes: the slab-sharded deposit relies on this to
    do the single-device arithmetic."""
    import jax.numpy as jnp

    from astro_sph_tools_tpu.ops.grid3d import _stencil_level_pass_3d, voxel_frame

    box, n, nz, grid_nz = 25.0, 2048, 16, 8
    spec = GridSpec(shape=(nz, nz, nz), extent=(0.0, box) * 3)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    h = rng.uniform(0.2, 0.7, n).astype(np.float32) * box / nz
    m = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    static = dict(
        K=4, shape=spec.shape, voxel_size=spec.voxel_size,
        periodic=(True, True, False), kernel_name="cubic_spline", chunk=256,
    )
    args = tuple(jnp.asarray(a) for a in (*voxel_frame(pos, spec), h, m))
    cube = np.asarray(
        _stencil_level_pass_3d(jnp.zeros((nz**3, 1), jnp.float32), *args, **static)
    ).reshape(nz, nz, nz)
    slab = np.asarray(
        _stencil_level_pass_3d(
            jnp.zeros((grid_nz * nz * nz, 1), jnp.float32), *args, plane0,
            grid_nz=grid_nz, **static,
        )
    ).reshape(grid_nz, nz, nz)
    lo, hi = max(plane0, 0), min(plane0 + grid_nz, nz)
    # planes past the cube's ends hold the spill a halo ring carries on
    np.testing.assert_array_equal(slab[lo - plane0 : hi - plane0], cube[lo:hi])


@pytest.mark.parametrize("periodic", [False, True])
def test_subvoxel_smoothing_lengths_hold_budget(rng, periodic):
    """h down to 0.2 voxel on a 128^3 grid: the f32 rounding of a global
    voxel coordinate (~2^-24 * 128 voxel) would cost ~3e-5 of the f64
    oracle; per-particle voxel frames keep the cube inside 1e-5."""
    from oracles import grid3d_oracle_fast

    box, n, g = 25.0, 6000, 128
    spec = GridSpec(shape=(g,) * 3, extent=(0.0, box) * 3, periodic_wrap=periodic)
    vox = box / g
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    h = np.exp(rng.uniform(np.log(0.2), np.log(1.0), n)) * vox
    m = rng.uniform(0.5, 2.0, n) * 10.0 ** rng.uniform(0, 2, n)
    got = np.asarray(deposit_3d(pos, h, m, spec))
    exp = grid3d_oracle_fast(pos.astype(np.float64), h, m, spec.shape, spec.extent,
                             periodic=periodic)
    assert rel_err(got, exp) < 1e-5


def test_voxel_frame_host_and_device_agree(rng):
    """Host (f64) and device (f32) frames name the same nearest sample away
    from ties, and the offsets stay within half a voxel."""
    import jax.numpy as jnp

    from astro_sph_tools_tpu.ops.grid3d import voxel_frame

    spec = GridSpec(shape=(8, 16, 32), extent=(1.0, 5.0, -2.0, 2.0, 0.0, 4.0),
                    voxel_origin="corner")
    pos = np.stack([rng.uniform(1, 5, 500), rng.uniform(-2, 2, 500),
                    rng.uniform(0, 4, 500)], axis=1)
    c, d = voxel_frame(pos, spec)
    assert c.dtype == np.int32 and d.dtype == np.float32
    assert np.abs(d).max() <= 0.5
    u = (pos - [1.0, -2.0, 0.0]) / [4 / 32, 4 / 16, 4 / 8]
    np.testing.assert_allclose(c + d, u, atol=1e-6)
    cd, dd = (np.asarray(a) for a in voxel_frame(jnp.asarray(pos, jnp.float32), spec))
    away = np.abs(d) < 0.49
    np.testing.assert_array_equal(cd[away], c[away])
    np.testing.assert_allclose(dd, d, atol=1e-5)
