"""Science-workflow composition (VERDICT r2 item 9): ionisation table ->
per-particle ion fractions -> ion-weighted column-density map and sightline
columns, end-to-end on the synthetic EAGLE fixture.

This is the downstream use the reference's pieces exist for: HM01 tables
(`io/ionisation_tables/_HM01.py:74-95`) applied to snapshot gas states
(n_H from elemental number densities, `_SnapshotEAGLE.py:553-585`), the
result deposited with the projection engine (`tools/projections`).
"""

import numpy as np
import pytest
from scipy.interpolate import RegularGridInterpolator

from astro_sph_tools_tpu.data_structures import ParticleType
from astro_sph_tools_tpu.io.eagle import SnapshotEAGLE
from astro_sph_tools_tpu.io.ionisation import (
    IonisationTable_HM01,
    SupportedIons,
    write_synthetic_hm01_table,
)
from astro_sph_tools_tpu.io.synthetic import SyntheticSnapshotSpec, write_snapshot
from astro_sph_tools_tpu.ops.deposit import MapSpec
from astro_sph_tools_tpu.ops.deposit_pallas import deposit_2d_auto
from astro_sph_tools_tpu.ops.sightlines import column_integrate

from oracles import project_oracle

# compile-heavy (interpret-mode Pallas / shard_map meshes): slow lane
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    root = tmp_path_factory.mktemp("science")
    spec = SyntheticSnapshotSpec(
        n_gas=3000, n_dm=64, n_star=16, n_bh=2, clustered=True, n_groups=4
    )
    snap_path, truth = write_snapshot(str(root), spec)
    table_path = write_synthetic_hm01_table(str(root), SupportedIons.O_VI)
    snap = SnapshotEAGLE(snap_path)
    table = IonisationTable_HM01(SupportedIons.O_VI, str(root))
    return snap, table, spec, truth


def _ion_weighted_masses(snap, table):
    """Per-particle O VI ion-weighted mass: m * f_ion(log n_H, log T; z)."""
    n_h = snap.get_number_densities(ParticleType.gas, "H").to_value("cm**-3")
    temp = snap.get_temperatures(ParticleType.gas).to_value("K")
    mass = snap.get_masses(ParticleType.gas).to_value("Msun")
    gas_state = np.stack([np.log10(n_h), np.log10(temp)], axis=1)
    log_frac = table.evaluate_at_redshift(gas_state, snap.redshift)
    # out-of-table gas states get fill_value=-inf (reference semantics,
    # `_IonisationTable.py:44-52`) -> ion fraction 0
    frac = 10.0 ** log_frac
    assert np.isfinite(frac).all() and (frac >= 0).all() and (frac > 0).any()
    return mass * frac, frac


class TestIonWeightedWorkflow:
    def test_fractions_match_scipy_oracle(self, workflow):
        snap, table, *_ = workflow
        _, frac = _ion_weighted_masses(snap, table)
        # independent oracle: scipy interpolation over the raw table file
        interp = RegularGridInterpolator(
            (
                table.get_table_dimension(0),
                table.get_table_dimension(1),
                table.get_table_dimension(2),
            ),
            table.ionisation_fraction_table,
            bounds_error=False,
            fill_value=-np.inf,
        )
        n_h = snap.get_number_densities(ParticleType.gas, "H").to_value("cm**-3")
        temp = snap.get_temperatures(ParticleType.gas).to_value("K")
        pts = np.stack(
            [
                np.log10(n_h),
                np.log10(temp),
                np.full(n_h.shape, snap.redshift),
            ],
            axis=1,
        )
        exp = 10.0 ** interp(pts)
        np.testing.assert_allclose(frac, exp, rtol=1e-5, atol=1e-30)

    def test_ion_column_density_map(self, workflow):
        snap, table, spec, _ = workflow
        ion_mass, _ = _ion_weighted_masses(snap, table)
        box = float(snap.box_size.value[0])
        pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
        hs = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
        mspec = MapSpec(shape=(128, 128), extent=(0, box, 0, box), periodic_wrap=True)
        img = np.asarray(
            deposit_2d_auto(
                pos[:, 0], pos[:, 1], hs, ion_mass.astype(np.float32),
                mspec,
            )
        )
        exp = project_oracle(
            pos[:, 0], pos[:, 1], hs, ion_mass, mspec.shape, mspec.extent,
            periodic=True,
        )
        assert np.abs(img - exp).max() / np.abs(exp).max() < 2e-5
        assert (img >= 0).all() and img.sum() > 0

    def test_ion_sightline_columns(self, workflow):
        snap, table, spec, _ = workflow
        ion_mass, _ = _ion_weighted_masses(snap, table)
        box = float(snap.box_size.value[0])
        pos = snap.get_positions(ParticleType.gas).to_value("Mpc")
        hs = snap.get_smoothing_lengths(ParticleType.gas).to_value("Mpc")
        rng = np.random.default_rng(5)
        rx = rng.uniform(0, box, 32)
        ry = rng.uniform(0, box, 32)
        cols = np.asarray(
            column_integrate(
                pos[:, 0], pos[:, 1], hs, ion_mass.astype(np.float32),
                rx, ry, periodic_box=box,
            )
        )
        assert cols.shape == (32,)
        assert np.isfinite(cols).all() and (cols >= 0).all()
        # dense oracle: line-integrated kernel sum per ray
        from astro_sph_tools_tpu.kernels.splines import (
            get_kernel,
            integrated_kernel_lookup,
            integrated_kernel_table,
        )
        import jax.numpy as jnp

        kspec = get_kernel("cubic_spline")
        tab = integrated_kernel_table("cubic_spline")
        x, y = pos[:, 0], pos[:, 1]
        exp = np.empty(32)
        for i in range(32):
            dx = np.abs(x - rx[i]); dx = np.minimum(dx, box - dx)
            dy = np.abs(y - ry[i]); dy = np.minimum(dy, box - dy)
            b = np.sqrt(dx * dx + dy * dy)
            yv = np.asarray(
                integrated_kernel_lookup(
                    tab, jnp.asarray(b), jnp.asarray(hs), kspec.support_factor
                )
            )
            exp[i] = float((ion_mass * yv).sum())
        np.testing.assert_allclose(cols, exp, rtol=5e-5, atol=abs(exp).max() * 1e-6)
