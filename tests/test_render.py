"""High-level render API over synthetic snapshots."""

import numpy as np
import pytest

from astro_sph_tools_tpu.data_structures import CoordinateAxes, ParticleType
from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_snapshot
from astro_sph_tools_tpu.render import render_map_stack


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    spec = SyntheticSnapshotSpec(n_gas=2048, n_dm=256, n_star=64, n_bh=2, clustered=True)
    root = tmp_path_factory.mktemp("render_sim")
    path, truth = write_snapshot(str(root), spec)
    return SnapshotEAGLE(path), truth, spec


class TestRenderMapStack:
    def test_density_temperature_stack(self, snap):
        snapshot, truth, spec = snap
        stack = render_map_stack(
            snapshot, fields=("density", "temperature"), resolution=64, engine="xla"
        )
        assert set(stack.keys()) == {
            "surface_density", "mass_weighted_temperature", "mean_temperature",
        }
        sd = stack["surface_density"]
        assert sd.shape == (64, 64)
        assert sd.sum() > 0
        mt = stack["mean_temperature"]
        covered = sd > sd.max() * 1e-3
        assert (mt[covered] > 0).all()
        # mean temperature bounded by the particle range
        assert mt.max() <= truth.temperature.max() * 1.001
        assert "deposit" in stack.timings and "io" in stack.timings

    def test_axis_selection(self, snap):
        snapshot, truth, _ = snap
        stack_z = render_map_stack(snapshot, resolution=32, engine="xla")
        stack_x = render_map_stack(
            snapshot, resolution=32, engine="xla", axis=CoordinateAxes.X
        )
        assert not np.allclose(stack_z["surface_density"], stack_x["surface_density"])

    def test_mass_conservation_against_particles(self, snap):
        """Integrated-projection surface density conserves total mass."""
        snapshot, truth, spec = snap
        stack = render_map_stack(
            snapshot, fields=("density",), resolution=128, engine="xla",
            projection="integrated",
        )
        sd = stack["surface_density"]
        pixel_area = stack.spec.pixel_size[0] * stack.spec.pixel_size[1]
        total = sd.sum() * pixel_area
        expected = truth.masses[ParticleType.gas].sum()
        assert total / expected == pytest.approx(1.0, rel=2e-2)

    def test_pallas_engine_interpret(self, snap):
        snapshot, truth, _ = snap
        stack = render_map_stack(snapshot, fields=("density",), resolution=32, engine="pallas")
        assert stack["surface_density"].shape == (32, 32)
        assert np.isfinite(stack["surface_density"]).all()

    def test_region_extent(self, snap):
        snapshot, *_ = snap
        stack = render_map_stack(
            snapshot, resolution=32, engine="xla", extent=(2.0, 8.0, 2.0, 8.0), periodic=False
        )
        assert stack.spec.extent == (2.0, 8.0, 2.0, 8.0)

    def test_unknown_field(self, snap):
        snapshot, *_ = snap
        with pytest.raises(ValueError):
            render_map_stack(snapshot, fields=("entropy",), resolution=16, engine="xla")


class TestRenderHaloMaps:
    def test_halo_cutouts(self, tmp_path):
        from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE
        from astro_sph_tools_tpu.io.subfind import CatalogueSUBFIND
        from astro_sph_tools_tpu.io.synthetic import (
            SyntheticSnapshotSpec, write_catalogue, write_snapshot,
        )
        from astro_sph_tools_tpu.render import render_halo_maps

        spec = SyntheticSnapshotSpec(
            n_gas=4096, n_dm=256, n_star=64, n_bh=2, clustered=True, n_groups=5
        )
        path, truth = write_snapshot(str(tmp_path), spec)
        memb, prop = write_catalogue(str(tmp_path), spec, truth)
        snapshot = SnapshotEAGLE(path)
        cat = CatalogueSUBFIND(memb, prop, snapshot)

        stacks = render_halo_maps(
            snapshot, cat, [0, 2], fields=("density", "temperature"),
            resolution=32, engine="xla",
        )
        assert len(stacks) == 2
        for stack in stacks:
            sd = stack["surface_density"]
            assert sd.shape == (32, 32)
            assert np.isfinite(sd).all()
            assert "mean_temperature" in stack.keys()
        # cutout extents centred on the box middle after recentring
        lo, hi, *_ = stacks[0].spec.extent
        assert lo < 5.0 < hi

    def test_halo_centre_is_densest_region(self, tmp_path):
        """The halo's own particles concentrate near the cutout centre."""
        from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE
        from astro_sph_tools_tpu.io.subfind import CatalogueSUBFIND
        from astro_sph_tools_tpu.io.synthetic import (
            SyntheticSnapshotSpec, write_catalogue, write_snapshot,
        )
        from astro_sph_tools_tpu.render import render_halo_maps

        spec = SyntheticSnapshotSpec(
            n_gas=8192, n_dm=64, n_star=16, n_bh=2, clustered=True, n_groups=3, seed=5
        )
        path, truth = write_snapshot(str(tmp_path), spec)
        memb, prop = write_catalogue(str(tmp_path), spec, truth)
        snapshot = SnapshotEAGLE(path)
        cat = CatalogueSUBFIND(memb, prop, snapshot)
        (stack,) = render_halo_maps(
            snapshot, cat, [1], radius_multiple=4.0, resolution=48, engine="xla"
        )
        sd = stack["surface_density"]
        n = sd.shape[0]
        inner = sd[n // 4 : -n // 4, n // 4 : -n // 4].mean()
        outer = (sd.sum() - sd[n // 4 : -n // 4, n // 4 : -n // 4].sum()) / (
            sd.size - (n // 2) ** 2
        )
        assert inner > outer  # centrally concentrated
