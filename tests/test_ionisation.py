"""Interpolation core + ionisation tables vs scipy oracles."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.interpolate import CubicSpline, RegularGridInterpolator

from astro_sph_tools_tpu.data_structures.ionisation import IonisationTableBase
from astro_sph_tools_tpu.io.ionisation import (
    IonisationTable_HM01,
    SupportedIons,
    write_synthetic_hm01_table,
)
from astro_sph_tools_tpu.ops.interp import cubic_spline_1d, regular_grid_interpolate


class TestRegularGridInterpolate:
    def test_matches_scipy_3d(self, rng):
        axes = [np.sort(rng.uniform(0, 10, 12)), np.linspace(-5, 5, 9), np.linspace(0, 1, 7)]
        table = rng.normal(size=(12, 9, 7))
        oracle = RegularGridInterpolator(axes, table, bounds_error=False, fill_value=-np.inf)
        pts = np.column_stack(
            [rng.uniform(axes[i].min(), axes[i].max(), 200) for i in range(3)]
        )
        got = np.asarray(
            regular_grid_interpolate([jnp.asarray(a) for a in axes], jnp.asarray(table), jnp.asarray(pts))
        )
        np.testing.assert_allclose(got, oracle(pts), rtol=1e-5, atol=1e-6)

    def test_out_of_bounds_fill(self):
        axes = [jnp.linspace(0, 1, 5)]
        table = jnp.arange(5.0)
        got = np.asarray(regular_grid_interpolate(axes, table, jnp.asarray([[2.0], [0.5], [-1.0]])))
        assert got[0] == -np.inf and got[2] == -np.inf
        assert got[1] == pytest.approx(2.0)

    def test_exact_on_grid_points(self, rng):
        axes = [np.linspace(0, 1, 6), np.linspace(2, 3, 4)]
        table = rng.normal(size=(6, 4))
        pts = np.array([[axes[0][2], axes[1][1]], [axes[0][5], axes[1][3]]])
        got = np.asarray(
            regular_grid_interpolate([jnp.asarray(a) for a in axes], jnp.asarray(table), jnp.asarray(pts))
        )
        np.testing.assert_allclose(got, [table[2, 1], table[5, 3]], rtol=1e-6)


class TestCubicSpline1D:
    def test_matches_scipy_interior(self):
        x = np.linspace(0, 8, 30)
        y = np.sin(x) + 0.1 * x
        xq = np.linspace(0.5, 7.5, 100)
        got = np.asarray(cubic_spline_1d(x, y, xq))
        expected = CubicSpline(x, y)(xq)
        np.testing.assert_allclose(got, expected, atol=2e-3)

    def test_passes_through_knots(self):
        x = np.linspace(0, 5, 12)
        y = np.cos(x)
        got = np.asarray(cubic_spline_1d(x, y, x))
        np.testing.assert_allclose(got, y, atol=1e-6)


class TestIonisationTableBase:
    def test_dimension_mismatch_raises(self):
        with pytest.raises(IndexError):
            IonisationTableBase(np.zeros((3, 3)), np.arange(3))

    def test_evaluate_at_redshift_inserts_column(self, rng):
        table = rng.normal(size=(5, 6, 4))
        axes = (np.linspace(-8, 0, 5), np.linspace(2, 8, 6), np.linspace(0, 3, 4))
        t = IonisationTableBase(table, *axes, redshift_input_index=2)
        gas = np.column_stack([rng.uniform(-7, -1, 50), rng.uniform(3, 7, 50)])
        via_insert = t.evaluate_at_redshift(gas, 1.5)
        direct = t(np.column_stack([gas, np.full(50, 1.5)]))
        np.testing.assert_allclose(via_insert, direct, rtol=1e-5)

    def test_accessors(self):
        table = np.zeros((3, 4))
        axes = (np.arange(3.0), np.arange(4.0))
        t = IonisationTableBase(table, *axes)
        assert t.number_of_input_dimensions == 2
        np.testing.assert_array_equal(t.get_table_dimension(1), axes[1])
        assert t.ionisation_fraction_table.shape == (3, 4)


class TestSupportedIons:
    def test_count_is_38(self):
        assert len(SupportedIons) == 38

    def test_metadata(self):
        assert SupportedIons.O_VI.element_symbol == "O"
        assert SupportedIons.O_VI.ionisation_stage == 6
        assert SupportedIons.O_VI.display_name == "O VI"
        assert SupportedIons.Fe_XVII.ionisation_stage == 17
        assert SupportedIons.Ne_X.value == "ne10"

    def test_ions_of_element(self):
        carbon = SupportedIons.ions_of_element("C")
        assert len(carbon) == 6
        assert SupportedIons.C_IV in carbon


class TestHM01:
    def test_load_and_interpolate(self, tmp_path, rng):
        write_synthetic_hm01_table(str(tmp_path), SupportedIons.O_VI)
        t = IonisationTable_HM01(SupportedIons.O_VI, str(tmp_path))
        assert t.cloudy_version == "synthetic-cloudy-1.0"
        assert t.model_name == "HM01-synthetic"
        gas = np.column_stack([rng.uniform(-7, -1, 30), rng.uniform(3, 7, 30)])
        frac = t.evaluate_at_redshift(gas, 2.0)
        # analytic field: -((T-4.5)^2)/2 + 0.2 D - 0.1 z, trilinear approx
        expected = -((gas[:, 1] - 4.5) ** 2) / 2 + 0.2 * gas[:, 0] - 0.1 * 2.0
        np.testing.assert_allclose(frac, expected, atol=0.06)

    def test_gammahi_interpolation(self, tmp_path):
        write_synthetic_hm01_table(str(tmp_path), SupportedIons.H_I)
        t = IonisationTable_HM01(SupportedIons.H_I, str(tmp_path))
        g = t.interpolate_gammahi(1.0)
        expected = 1e-12 * 2.0**1.5
        assert g.to_value("s**-1") == pytest.approx(expected, rel=1e-2)
        arr = t.interpolate_gammahi(np.array([0.0, 2.0]))
        assert arr.shape == (2,)

    def test_missing_table_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            IonisationTable_HM01(SupportedIons.C_IV, str(tmp_path))


def test_mxu_interp_matches_gather():
    """The gather-free one-hot matmul 2-D lookup equals the corner-gather
    formulation (round-5 perf path: gathers were 84% of the ion render)."""
    import jax.numpy as jnp

    from astro_sph_tools_tpu.ops.interp import regular_grid_interpolate

    rng = np.random.default_rng(9)
    ax0 = np.sort(rng.uniform(-8, 0, 41))
    ax1 = np.sort(rng.uniform(2, 8, 81))
    table = rng.normal(0, 1, (41, 81))
    pts = np.column_stack([
        rng.uniform(-9, 1, 9000), rng.uniform(1, 9, 9000)  # incl. OOB
    ])
    a = np.asarray(regular_grid_interpolate(
        (jnp.asarray(ax0), jnp.asarray(ax1)), jnp.asarray(table),
        jnp.asarray(pts), method="gather",
    ))
    b = np.asarray(regular_grid_interpolate(
        (jnp.asarray(ax0), jnp.asarray(ax1)), jnp.asarray(table),
        jnp.asarray(pts), method="mxu",
    ))
    inb = np.isfinite(a)
    assert (np.isfinite(b) == inb).all()
    np.testing.assert_allclose(a[inb], b[inb], rtol=2e-5, atol=1e-6)
