"""Ionisation-table interpolation base.

Parity target: ``IIonisationTable`` / ``IonisationTableBase``
(`/root/reference/src/astro_sph_tools/data_structures/_IonisationTable.py:18-69`):
N-D regular-grid interpolation of log-space ion-fraction tables with
``bounds_error=False`` and ``fill_value=-inf``; ``evaluate_at_redshift``
injects a fixed redshift column into the gas-state matrix at the configured
axis position.

Re-architected on the pure-JAX interpolator (``ops.interp``) so lookups run
on device and fuse into render pipelines; NumPy in/out remains supported.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import jax.numpy as jnp
import numpy as np

from ..ops.interp import regular_grid_interpolate


class IIonisationTable(ABC):
    """Types that provide ionisation state."""

    @abstractmethod
    def __call__(self, gas_state) -> np.ndarray: ...


class IonisationTableBase(IIonisationTable):
    def __init__(self, table, *table_positions, redshift_input_index: int = -1) -> None:
        self._n_input_dimensions = len(table_positions)
        self._redshift_index = (
            redshift_input_index
            if redshift_input_index >= 0
            else self._n_input_dimensions - redshift_input_index
        )
        if self._n_input_dimensions == 0:
            raise IndexError(
                "No input dimensions were specified for table interpolation construction."
            )
        if np.ndim(table) != self._n_input_dimensions:
            raise IndexError(
                f"Interpolation table has {np.ndim(table)} dimensions but "
                f"{self._n_input_dimensions} arrays were used to specify the table positions."
            )
        self._table = np.asarray(table)
        self._positions = tuple(np.asarray(p) for p in table_positions)
        self._table_j = jnp.asarray(self._table)
        self._positions_j = tuple(jnp.asarray(p) for p in self._positions)

    def __call__(self, gas_state) -> np.ndarray:
        """Interpolate at (N, D) gas-state rows; -inf outside the grid."""
        result = regular_grid_interpolate(
            self._positions_j, self._table_j, jnp.asarray(gas_state), fill_value=-jnp.inf
        )
        return np.asarray(result)

    def evaluate_at_redshift(self, gas_state, redshift: float) -> np.ndarray:
        """Insert a constant-redshift column at the configured axis position
        (`_IonisationTable.py:54-58`).

        For 3-D tables the constant-z plane is collapsed out first
        (:meth:`table_at_redshift`) and the lookup runs through the
        gather-free 2-D one-hot matmul path — identical values, no
        general gather."""
        gas_state = np.asarray(gas_state)
        if self._n_input_dimensions == 3 and gas_state.shape[1] == 2:
            axes2, table2 = self.table_at_redshift(redshift)
            return np.asarray(
                regular_grid_interpolate(
                    axes2, table2, jnp.asarray(gas_state),
                    fill_value=-jnp.inf,
                )
            )
        formatted = np.empty((gas_state.shape[0], gas_state.shape[1] + 1), dtype=float)
        mask = np.arange(self._n_input_dimensions) != self._redshift_index
        formatted[:, mask] = gas_state
        formatted[:, self._redshift_index] = redshift
        return self(formatted)

    def table_at_redshift(self, redshift: float):
        """Collapse the redshift axis at a constant z: returns the two
        remaining axes and the linearly blended 2-D table (device arrays,
        ready for :func:`..ops.interp.regular_grid_interpolate`). Out-of-
        range z clamps to the table's edge planes (matching the clipped
        bracketing of the full-D lookup; the final in-bounds masking of a
        z outside the grid is the caller's concern — snapshot redshifts
        sit inside every published table's z range)."""
        zi = self._redshift_index
        ax = self._positions[zi]
        i = int(np.clip(np.searchsorted(ax, redshift, side="right") - 1,
                        0, ax.shape[0] - 2))
        w = float(np.clip((redshift - ax[i]) / (ax[i + 1] - ax[i]), 0.0, 1.0))
        lo = np.take(self._table, i, axis=zi)
        hi = np.take(self._table, i + 1, axis=zi)
        table2 = (1.0 - w) * lo + w * hi
        axes2 = tuple(
            jnp.asarray(p)
            for d, p in enumerate(self._positions) if d != zi
        )
        return axes2, jnp.asarray(table2)

    @property
    def number_of_input_dimensions(self) -> int:
        return self._n_input_dimensions

    @property
    def ionisation_fraction_table(self) -> np.ndarray:
        return self._table.copy()

    def get_table_dimension(self, dimension: int) -> np.ndarray:
        return self._positions[dimension].copy()
