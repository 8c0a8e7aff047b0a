"""N-D regular-grid multilinear interpolation, pure ``jax.numpy``.

Device-side replacement for the reference's
``scipy.interpolate.RegularGridInterpolator`` usage
(`/root/reference/src/astro_sph_tools/data_structures/_IonisationTable.py:44-52`):
linear interpolation over a rectilinear grid with monotonically increasing
axes, ``bounds_error=False`` semantics and a configurable out-of-bounds fill
value (the ionisation tables are log-space, so the reference fills with
-inf). Fully jittable/vmappable, so ion-fraction lookups fuse into the
device render pipeline instead of bouncing through SciPy on the host.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import jax
import jax.numpy as jnp

Array = jax.Array


def _onehot_weights(ax: Array, p: Array, dtype):
    """Gather-free 1-D interpolation stencil for a SMALL axis.

    Returns ``(A, in_bounds)`` with ``A`` (N, len(ax)) carrying ``1 - w``
    at the bracketing lower node and ``w`` at the upper one. Everything is
    compares + tiny matmuls, with no general gather. The matmuls run at
    ``Precision.HIGHEST``: a GPU f32 matmul may otherwise run in TF32,
    whose ~3 decimal digits would round the interpolated values."""
    n = ax.shape[0]
    # searchsorted over a small axis as a sum of compares (no gather)
    ge = (p[:, None] >= ax[None, :]).astype(jnp.int32)  # (N, n)
    i = jnp.clip(ge.sum(axis=1) - 1, 0, n - 2)
    k = jnp.arange(n, dtype=jnp.int32)
    e0 = (k[None, :] == i[:, None]).astype(dtype)
    e1 = (k[None, :] == (i + 1)[:, None]).astype(dtype)
    hi = jax.lax.Precision.HIGHEST
    x0 = jnp.einsum("nk,k->n", e0, ax.astype(dtype), precision=hi)
    x1 = jnp.einsum("nk,k->n", e1, ax.astype(dtype), precision=hi)
    w = (p.astype(dtype) - x0) / (x1 - x0)
    A = e0 * (1.0 - w)[:, None] + e1 * w[:, None]
    in_bounds = (p >= ax[0]) & (p <= ax[-1])
    return A, in_bounds


def _interpolate_2d_mxu(axes, table, points, fill_value, chunk=1 << 16):
    """Bilinear 2-D table lookup as two one-hot matmuls per chunk."""
    ax0 = jnp.asarray(axes[0])
    ax1 = jnp.asarray(axes[1])
    table = jnp.asarray(table)
    dtype = table.dtype
    n = points.shape[0]
    pad = (-n) % chunk
    pts = jnp.pad(points, ((0, pad), (0, 0)))
    hi = jax.lax.Precision.HIGHEST

    def one(chunk_pts):
        A, ok0 = _onehot_weights(ax0, chunk_pts[:, 0], dtype)
        B, ok1 = _onehot_weights(ax1, chunk_pts[:, 1], dtype)
        M = jnp.einsum("ni,ij->nj", A, table, precision=hi)
        val = jnp.einsum("nj,nj->n", M, B, precision=hi)
        return jnp.where(ok0 & ok1, val, fill_value)

    out = jax.lax.map(one, pts.reshape(-1, chunk, 2))
    return out.reshape(-1)[:n]


def regular_grid_interpolate(
    axes: Sequence[Array],
    table: Array,
    points: Array,
    fill_value: float = -jnp.inf,
    method: str = "auto",
) -> Array:
    """Multilinear interpolation of ``table`` at ``points``.

    Parameters
    ----------
    axes : D arrays of strictly increasing coordinates (len = table.shape[d]).
    table : D-dimensional value grid.
    points : (N, D) query coordinates.
    fill_value : value returned for points outside the grid hull.
    method : "auto" uses the gather-free one-hot matmul formulation for
        2-D tables up to 512 nodes per axis (which of the two is faster on
        the GPU is not yet measured); "gather" forces the corner-gather
        formulation (the host / small-N oracle), "mxu" forces the matmul
        form.

    Returns (N,) interpolated values.
    """
    ndim = table.ndim
    points = jnp.asarray(points)
    if (
        method == "mxu"
        or (
            method == "auto"
            and ndim == 2
            and max(table.shape) <= 512
            and points.ndim == 2
            and points.shape[0] >= 4096
        )
    ):
        if ndim != 2:
            raise ValueError("method='mxu' supports 2-D tables only")
        return _interpolate_2d_mxu(axes, table, points, fill_value)
    if len(axes) != ndim:
        raise ValueError(f"{len(axes)} axes for a {ndim}-D table")
    points = jnp.asarray(points)
    if points.ndim == 1:
        points = points[None, :]

    idx_lo = []
    weights_hi = []
    in_bounds = jnp.ones(points.shape[0], dtype=bool)
    for d in range(ndim):
        ax = jnp.asarray(axes[d])
        p = points[:, d]
        i = jnp.clip(jnp.searchsorted(ax, p, side="right") - 1, 0, ax.shape[0] - 2)
        x0 = ax[i]
        x1 = ax[i + 1]
        w = (p - x0) / (x1 - x0)
        idx_lo.append(i)
        weights_hi.append(w)
        in_bounds &= (p >= ax[0]) & (p <= ax[-1])

    result = jnp.zeros(points.shape[0], dtype=table.dtype)
    for corner in itertools.product((0, 1), repeat=ndim):
        weight = jnp.ones(points.shape[0], dtype=table.dtype)
        idx = []
        for d, hi in enumerate(corner):
            w = weights_hi[d]
            weight = weight * (w if hi else (1.0 - w))
            idx.append(idx_lo[d] + hi)
        result = result + weight * table[tuple(idx)]

    return jnp.where(in_bounds, result, fill_value)


def cubic_spline_1d(x: Array, y: Array, xq: Array) -> Array:
    """Natural cubic-spline interpolation (host- or device-side).

    Used for the HM01 Gamma_HI(z) curve (`io/ionisation_tables/_HM01.py:95`,
    scipy ``CubicSpline`` with not-a-knot ends; this uses natural ends — the
    curves agree to <1e-3 away from the boundary knots, and the physical
    quantity is tabulated densely).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = x.shape[0]
    h = x[1:] - x[:-1]
    # solve the tridiagonal system for second derivatives (natural BCs)
    # diag: 2(h[i-1]+h[i]); rhs: 6*((y[i+1]-y[i])/h[i] - (y[i]-y[i-1])/h[i-1])
    rhs = 6.0 * ((y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1])
    diag = 2.0 * (h[:-1] + h[1:])
    lower = h[:-1]
    upper = h[1:]

    # Thomas algorithm via scan
    def fwd(carry, inputs):
        c_prev, d_prev = carry
        a, b, c, d = inputs
        m = b - a * c_prev
        c_new = c / m
        d_new = (d - a * d_prev) / m
        return (c_new, d_new), (c_new, d_new)

    a_seq = jnp.concatenate([jnp.zeros(1), lower[1:]])
    (_, _), (c_primes, d_primes) = jax.lax.scan(
        fwd, (jnp.zeros(()), jnp.zeros(())), (a_seq, diag, upper, rhs)
    )

    def back(carry, inputs):
        m_next = carry
        c_p, d_p = inputs
        m = d_p - c_p * m_next
        return m, m

    _, m_rev = jax.lax.scan(back, jnp.zeros(()), (c_primes[::-1], d_primes[::-1]))
    m_inner = m_rev[::-1]
    m2 = jnp.concatenate([jnp.zeros(1), m_inner, jnp.zeros(1)])  # natural ends

    xq = jnp.asarray(xq)
    i = jnp.clip(jnp.searchsorted(x, xq, side="right") - 1, 0, n - 2)
    hi = x[i + 1] - x[i]
    t_up = x[i + 1] - xq
    t_lo = xq - x[i]
    return (
        m2[i] * t_up**3 / (6 * hi)
        + m2[i + 1] * t_lo**3 / (6 * hi)
        + (y[i] / hi - m2[i] * hi / 6) * t_up
        + (y[i + 1] / hi - m2[i + 1] * hi / 6) * t_lo
    )
