"""Determinism utilities + bitwise reproducibility of the deposit engines."""

import numpy as np
import jax.numpy as jnp
import pytest

from astro_sph_tools_tpu.ops.deposit import MapSpec, deposit_2d_fixed_h
from astro_sph_tools_tpu.ops.deposit_pallas import deposit_2d_pallas
from astro_sph_tools_tpu.utils.determinism import (
    assert_deterministic,
    hash_array,
    hash_pytree,
)


class TestHashing:
    def test_stable_and_sensitive(self, rng):
        a = rng.normal(size=(32, 32)).astype(np.float32)
        assert hash_array(a) == hash_array(a.copy())
        b = a.copy()
        b[3, 7] += 1e-7
        assert hash_array(a) != hash_array(b)

    def test_dtype_and_shape_matter(self):
        a = np.zeros(16, np.float32)
        assert hash_array(a) != hash_array(a.astype(np.float64))
        assert hash_array(a) != hash_array(a.reshape(4, 4))

    def test_pytree(self, rng):
        tree = {"a": rng.normal(size=4), "b": [rng.normal(size=3)]}
        assert hash_pytree(tree) == hash_pytree(tree)


class TestDepositDeterminism:
    def test_stencil_engine_bitwise_reproducible(self, rng):
        n = 2048
        x = jnp.asarray(rng.uniform(0, 10, n), jnp.float32)
        y = jnp.asarray(rng.uniform(0, 10, n), jnp.float32)
        h = jnp.asarray(rng.uniform(0.1, 0.2, n), jnp.float32)
        m = jnp.asarray(rng.uniform(0.5, 2, n), jnp.float32)
        spec = MapSpec(shape=(32, 32), extent=(0.0, 10.0, 0.0, 10.0))
        assert_deterministic(
            lambda: deposit_2d_fixed_h(x, y, h, m, spec, K=8, chunk=512), n_runs=3
        )

    def test_pallas_engine_bitwise_reproducible(self, rng):
        n = 1024
        box = 10.0
        px = box / 32
        x = rng.uniform(0, box, n)
        y = rng.uniform(0, box, n)
        h = rng.uniform(0.5, 1.3, n) * px
        m = rng.uniform(0.5, 2, n)
        spec = MapSpec(shape=(32, 32), extent=(0.0, box, 0.0, box))
        assert_deterministic(
            lambda: deposit_2d_pallas(x, y, h, m, spec), n_runs=2
        )

    def test_detects_nondeterminism(self, rng):
        state = {"i": 0}

        def flaky():
            state["i"] += 1
            return np.full(4, state["i"], np.float32)

        with pytest.raises(AssertionError):
            assert_deterministic(flaky, n_runs=2)
