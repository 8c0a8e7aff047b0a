"""Even shard rebalancing (mpi_redistribute_array_evenly parity) on the
8-virtual-device mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from astro_sph_tools_tpu.ops.deposit import MapSpec
from astro_sph_tools_tpu.parallel.rebalance import rebalance_evenly
from astro_sph_tools_tpu.parallel.sharded import deposit_2d_sharded, make_mesh

from oracles import project_oracle


def _make_unbalanced(rng, mesh, counts, shard_len, pads):
    """Global arrays with per-shard valid prefixes of the given counts."""
    n_dev = len(counts)
    box = 10.0
    total = sum(counts)
    # cluster-heavy: shard i's particles live near a cluster centre
    x = rng.uniform(0, box, total)
    y = rng.uniform(0, box, total)
    h = np.full(total, 0.22)
    m = rng.uniform(0.5, 2.0, total)
    truth = (x.copy(), y.copy(), h.copy(), m.copy())
    blocks = []
    for arr, pad in zip((x, y, h, m), pads):
        g = np.full((n_dev * shard_len,), pad, np.float32)
        off = 0
        for i, c in enumerate(counts):
            g[i * shard_len : i * shard_len + c] = arr[off : off + c]
            off += c
        blocks.append(
            jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("data")))
        )
    return blocks, truth


class TestRebalanceEvenly:
    def test_order_preserved_and_even(self, rng):
        mesh = make_mesh(8)
        counts = [4000, 10, 0, 700, 1, 120, 2500, 60]  # halo-cutout skew
        shard_len = 4096
        blocks, truth = _make_unbalanced(
            rng, mesh, counts, shard_len, pads=(0, 0, 1.0, 0)
        )
        out, new_counts = rebalance_evenly(
            blocks, np.asarray(counts), mesh, pad_values=(0, 0, 1.0, 0)
        )
        total = sum(counts)
        assert new_counts.sum() == total
        expected = np.full(8, total // 8)
        expected[: total % 8] += 1
        np.testing.assert_array_equal(new_counts, expected)
        # the input spread was 4000 vs 0; the even partition is within 1
        assert int(new_counts.max() - new_counts.min()) <= 1
        # order preserved: concatenating valid prefixes reproduces the
        # original global sequence exactly, for every payload
        for k, (got, want) in enumerate(zip(out, truth)):
            got = np.asarray(got)
            rebuilt = np.concatenate([
                got[i * shard_len : i * shard_len + int(new_counts[i])]
                for i in range(8)
            ])
            np.testing.assert_array_equal(rebuilt, want.astype(np.float32),
                                          err_msg=f"payload {k}")
        # pad slots carry the requested fill (h -> 1.0)
        h_out = np.asarray(out[2])
        for i in range(8):
            tail = h_out[i * shard_len + int(new_counts[i]) : (i + 1) * shard_len]
            assert (tail == 1.0).all()

    @pytest.mark.slow
    def test_render_identical_after_rebalance(self, rng):
        """The sharded render gives the same map before and after — and the
        imbalanced case leaves most shards idle while one does everything."""
        mesh = make_mesh(8)
        counts = [4096, 0, 0, 0, 0, 0, 0, 904]  # one shard owns ~everything
        shard_len = 4096
        blocks, truth = _make_unbalanced(
            rng, mesh, counts, shard_len, pads=(0, 0, 1.0, 0)
        )
        box = 10.0
        spec = MapSpec(shape=(64, 64), extent=(0.0, box, 0.0, box))
        img_before = np.asarray(deposit_2d_sharded(
            *blocks, spec, mesh, K=8
        ))
        out, new_counts = rebalance_evenly(
            blocks, np.asarray(counts), mesh, pad_values=(0, 0, 1.0, 0)
        )
        assert int(new_counts.max()) == 625
        img_after = np.asarray(deposit_2d_sharded(
            *out, spec, mesh, K=8
        ))
        x, y, h, m = truth
        exp = project_oracle(x, y, h, m, spec.shape, spec.extent)
        for img in (img_before, img_after):
            assert np.abs(img - exp).max() / exp.max() < 1e-5
        np.testing.assert_allclose(img_before, img_after, rtol=2e-6,
                                   atol=exp.max() * 1e-6)

    def test_capacity_guard(self, rng):
        mesh = make_mesh(8)
        counts = [100] * 8
        blocks, _ = _make_unbalanced(rng, mesh, counts, 128, pads=(0, 0, 1, 0))
        with pytest.raises(ValueError, match="counts must be"):
            rebalance_evenly(blocks, np.asarray(counts[:4]), mesh)
        big = [128 * 8 + 1] + [0] * 7  # even share 129 > shard capacity 128
        blocks, _ = _make_unbalanced(rng, mesh, [128] * 8, 128,
                                     pads=(0, 0, 1, 0))
        with pytest.raises(ValueError, match="exceeds the shard capacity"):
            rebalance_evenly(blocks, np.asarray(big), mesh)
