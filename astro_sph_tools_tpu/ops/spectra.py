"""Velocity-space absorption spectra (SpecWizard-style, config 4).

Synthesises per-sightline optical-depth spectra from SPH particles: each
particle contributes its kernel column weight at the ray's impact parameter,
smeared in velocity space by a Gaussian thermal/Doppler profile centred on
its effective velocity (Hubble flow along the LOS + peculiar velocity):

    tau(v) = sum_i  N_i(b_impact) * exp(-(v - v_i)^2 / b_i^2) / (sqrt(pi) b_i)

with ``N_i = value_i * Y(b_impact_i, h_i)`` (the line-integrated kernel LUT),
``v_i = H(z)/(1+z) * z_pos_i + v_pec,i`` (proper Hubble flow across the
co-moving box at the snapshot epoch) and ``b_i = sqrt(2 k_B T_i / m_ion)``
the Doppler parameter. This is the velocity-space generalisation of
``los_profiles`` — the reference ships LOS *file readers* only; the
SpecWizard-style synthesis is the capability BASELINE config 4 names.

Physical line normalisation (oscillator strength, cross-section) is the
caller's scalar: pass ``values = mass_fraction * sigma0 ...`` as desired;
the engine returns the kernel-weighted, Doppler-broadened velocity density.

Execution mirrors ``sightlines``: dense (rays x chunk) blocks under
``lax.scan``, macro-batched over particles and rays to bound per-program
work.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..kernels.splines import (
    get_kernel,
    integrated_kernel_lookup,
    integrated_kernel_table,
)

Array = jax.Array

_DEF_CHUNK = 1024
_RAY_MACRO = 256
_MACRO_BATCH = 1 << 19


def doppler_parameter_kms(temperature_K, atomic_weight: float):
    """b = sqrt(2 k_B T / m) in km/s for an ion of the given atomic weight.

    Namespace-aware: jax-array temperatures stay on device (numpy would
    silently convert them via __array__, forcing a device-to-host sync)."""
    xp = jnp if isinstance(temperature_K, jax.Array) else np
    t = xp.asarray(temperature_K)
    m = atomic_weight * C.ATOMIC_MASS_UNIT_CGS
    return xp.sqrt(2.0 * C.BOLTZMANN_CONSTANT_CGS * t / m) / 1.0e5


def voigt_damping_kms(gamma: float, rest_wavelength_angstrom: float) -> float:
    """``voigt_k`` scalar for the engines: a_i = voigt_k / b_i(km/s).

    The Voigt damping parameter is ``a = Gamma * lambda0 / (4 pi b)`` with
    ``b`` in cm/s; dividing by 1e5 re-expresses it per km/s so the engines
    can form ``a`` from the per-particle Doppler parameter they already
    carry. For H I Lya: Gamma = 6.265e8 1/s, lambda0 = 1215.67 A."""
    lam_cm = rest_wavelength_angstrom * 1.0e-8
    return float(gamma) * lam_cm / (4.0 * math.pi) / 1.0e5


# Chebyshev fit of corr(x) = 2 - 4 x F(x) (F = Dawson's function) on
# x in [0, 7], mapped u = x/3.5 - 1; max abs error 4.1e-8 vs scipy.dawsn
_VOIGT_CHEB = (
    2.4881856318770293e-01, -6.0099312693192697e-01, 6.4361396302280671e-01,
    -5.1737510766123362e-01, 2.7006888736076384e-01, -2.6368566685981337e-02,
    -1.1440794112897615e-01, 1.3403557615997266e-01, -8.1168647269143177e-02,
    1.9254729968325685e-02, 1.5083805306240839e-02, -1.9727259945187089e-02,
    1.0291579640219038e-02, -1.1424355634791525e-03, -2.4686477108562285e-03,
    2.0475510075201524e-03, -6.2666180702336701e-04, -1.7901753143482690e-04,
    2.7790611865101666e-04, -1.1578103569858545e-04, -4.5046318466839111e-06,
    3.0438481530514348e-05, -1.4871741069277782e-05, 6.4132269964071750e-07,
    2.9411844272740243e-06, -1.5233384164772555e-06, 9.4266957856181097e-08,
    2.6613322244869490e-07, -1.3128921523181491e-07, 9.9593625077359186e-09,
    2.2027981792878860e-08,
)


def voigt_hjerting(a, x):
    """Voigt-Hjerting function ``H(a, x)`` for small damping parameters.

    Second-order expansion in ``a`` with *exact* coefficient functions:

        H(a, x) = exp(-x^2) (1 + a^2 (1 - 2x^2)) - (a / sqrt(pi)) corr(x)
                  + O(a^3),
        corr(x) = 2 - 4 x F(x)          (F = Dawson's function)

    ``corr`` is evaluated from a degree-30 Chebyshev fit on [0, 7]
    (4e-8 max abs error) and the asymptotic series in 1/x^2 beyond
    (1.8e-7 max rel), so the truncation error is the O(a^3) term —
    relative accuracy better than 1e-6 for every astrophysical line
    (H I Lya at b = 2 km/s has a = 3e-3; metal lines are smaller). This
    beats the widely used Tepper-Garcia (2006) closed form, whose
    approximate corr carries a ~1-2 % systematic error in the damping
    wings. Normalisation matches the Gaussian: integral of H over
    x = sqrt(pi), so engines can swap profiles without renormalising.
    """
    xp = jnp if isinstance(x, jax.Array) or isinstance(a, jax.Array) else np
    x = xp.abs(xp.asarray(x))
    a = xp.asarray(a)
    x2 = x * x
    # Clenshaw on u in [-1, 1] (numerically stable at this degree in f32)
    u = xp.clip(x, 0.0, 7.0) * (1.0 / 3.5) - 1.0
    u2 = 2.0 * u
    b1 = xp.zeros_like(u)
    b2 = xp.zeros_like(u)
    for c in _VOIGT_CHEB[:0:-1]:
        b1, b2 = u2 * b1 - b2 + c, b1
    corr_cheb = u * b1 - b2 + _VOIGT_CHEB[0]
    t = 1.0 / xp.maximum(x2, 49.0)
    corr_asym = -t * (
        1.0 + t * (1.5 + t * (3.75 + t * (13.125 + t * (59.0625 + t * 324.84375))))
    )
    corr = xp.where(x <= 7.0, corr_cheb, corr_asym)
    h0 = xp.exp(-x2)
    return h0 * (1.0 + a * a * (1.0 - 2.0 * x2)) - a * (
        1.0 / math.sqrt(math.pi)
    ) * corr


def _resolve_profile(profile: str, gamma, rest_wavelength_angstrom) -> float:
    """Validate the profile choice and return the engine's ``voigt_k``."""
    if profile not in ("gaussian", "voigt"):
        raise ValueError(f"unknown line profile {profile!r}")
    if profile == "voigt":
        if gamma is None or gamma <= 0:
            raise ValueError(
                "profile='voigt' needs the line's damping rate: pass "
                "gamma (1/s; H I Lya: 6.265e8)"
            )
        return voigt_damping_kms(gamma, rest_wavelength_angstrom)
    return 0.0


def _profile_sum(dv, inv_b, profile, voigt_k, vbox):
    """Line profile phi(dv) with unit velocity integral, summed over
    periodic velocity images when ``vbox`` is given.

    ``profile="gaussian"``: pure thermal/Doppler core.
    ``profile="voigt"``: adds the Lorentzian damping wings via
    :func:`voigt_hjerting` with per-particle a = voigt_k * inv_b —
    ``voigt_k`` is the line's :func:`voigt_damping_kms` scalar. The same
    7 periodic images cover the wings: beyond +-3 boxes the 1/x^2 wing
    contributes < (b/3 v_box)^2 * a of the line centre — negligible for
    any box wide enough for periodic spectra to make sense."""
    def one(d):
        z = d * inv_b
        if profile == "voigt":
            return voigt_hjerting(voigt_k * inv_b, z)
        return jnp.exp(-(z * z))

    if vbox is None:
        phi = one(dv)
    else:
        dv = dv - jnp.round(dv / vbox) * vbox
        phi = jnp.zeros_like(dv)
        for k in (-3, -2, -1, 0, 1, 2, 3):
            phi = phi + one(dv + k * vbox)
    return phi * ((1.0 / math.sqrt(math.pi)) * inv_b)


@partial(
    jax.jit,
    static_argnames=(
        "kernel_name", "chunk", "n_bins", "periodic_box", "periodic_velocity",
        "profile", "voigt_k",
    ),
)
def _spectra_impl(
    px, py, h, col_values, v_eff, b_dopp, ray_x, ray_y, v_centres, lut,
    *, kernel_name, chunk, n_bins, periodic_box, periodic_velocity,
    profile="gaussian", voigt_k=0.0,
):
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    n_chunks = px.shape[0] // chunk
    reshape = lambda a: a.reshape(n_chunks, chunk, *a.shape[1:])
    R = ray_x.shape[0]
    tau0 = jnp.zeros((R, n_bins), jnp.float32)

    def body(tau, inputs):
        cx, cy, ch, cN, cv, cb = inputs
        dx = ray_x[:, None] - cx[None, :]
        dy = ray_y[:, None] - cy[None, :]
        if periodic_box is not None:
            box = periodic_box
            dx = dx - jnp.round(dx / box) * box
            dy = dy - jnp.round(dy / box) * box
        b2 = dx * dx + dy * dy  # (R, C)
        w_col = integrated_kernel_lookup(lut, jnp.sqrt(b2), ch[None, :], S)
        w_col = jnp.where(b2 < (S * ch[None, :]) ** 2, w_col * cN[None, :], 0.0)  # (R, C)

        dv = v_centres[:, None] - cv[None, :]  # (B, C)
        # hot gas can have Doppler widths comparable to (or wider than) the
        # box's velocity extent; a single minimum image loses the profile
        # tails, so _profile_sum folds over periodic velocity images
        phi = _profile_sum(
            dv, 1.0 / cb[None, :], profile, voigt_k, periodic_velocity
        )  # (B, C), normalised: integral over v = 1

        # (R, B) += (R, C) @ (C, B). HIGHEST: a GPU f32 dot may otherwise
        # run in TF32 (~3 decimal digits); this engine is the numerics oracle.
        tau = tau + jnp.einsum(
            "rc,bc->rb", w_col, phi, precision=jax.lax.Precision.HIGHEST
        )
        return tau, None

    tau, _ = jax.lax.scan(
        body, tau0,
        (reshape(px), reshape(py), reshape(h), reshape(col_values), reshape(v_eff), reshape(b_dopp)),
    )
    return tau


def absorption_spectra(
    pos,
    h,
    values,
    velocities_los,
    temperatures,
    ray_x,
    ray_y,
    *,
    cosmology=None,
    box_size: Optional[float] = None,
    atomic_weight: float = 1.008,
    n_bins: int = 512,
    kernel: str = "cubic_spline",
    chunk: int = _DEF_CHUNK,
    periodic: bool = True,
    profile: str = "gaussian",
    gamma: Optional[float] = None,
    rest_wavelength_angstrom: float = 1215.67,
) -> tuple[Array, np.ndarray]:
    """Per-ray velocity-space spectra.

    Parameters
    ----------
    pos : (N, 3) co-moving positions (projection axis = z; pre-rotate
        otherwise). h : (N,) smoothing lengths. values : (N,) column payloads
        (e.g. ion masses or column-density weights).
    velocities_los : (N,) peculiar LOS velocities, km/s.
    temperatures : (N,) gas temperatures, K (sets the Doppler width).
    cosmology : Cosmology supplying the Hubble flow (H(z)); if None, no
        Hubble flow is added (pure peculiar-velocity space).
    box_size : co-moving box length for periodic wrapping (both spatial and
        the velocity extent of the box).
    atomic_weight : ion mass in amu for the Doppler parameter.
    profile : "gaussian" (thermal core only) or "voigt" (adds natural/
        damping Lorentzian wings — required for saturated absorbers).
    gamma : damping rate Gamma in 1/s (required for profile="voigt";
        H I Lya: 6.265e8).
    rest_wavelength_angstrom : line rest wavelength (default Lya).

    Returns (spectra (R, n_bins), velocity bin centres (km/s)).
    """
    voigt_k = _resolve_profile(profile, gamma, rest_wavelength_angstrom)
    pos = np.asarray(pos)
    h_np = np.asarray(h, np.float32)
    values = np.asarray(values, np.float32)
    v_pec = np.asarray(velocities_los, np.float32)
    temperature = np.asarray(temperatures)

    if box_size is None and periodic:
        raise ValueError("periodic spectra need box_size")

    # effective velocity: proper Hubble flow across the box + peculiar
    if cosmology is not None:
        dv_dx = cosmology.hubble_rate() * cosmology.expansion_factor  # km/s per cMpc
    else:
        dv_dx = 0.0
    v_eff = (pos[:, 2] * dv_dx + v_pec).astype(np.float32)
    v_box = float(box_size * dv_dx) if (box_size is not None and dv_dx > 0) else None

    b_dopp = np.maximum(
        doppler_parameter_kms(temperature, atomic_weight), 1e-3
    ).astype(np.float32)

    # velocity bins spanning the box's velocity extent (or the data range)
    if v_box is not None:
        v_edges = np.linspace(0.0, v_box, n_bins + 1)
    else:
        lo, hi = float(v_eff.min() - 3 * b_dopp.max()), float(v_eff.max() + 3 * b_dopp.max())
        v_edges = np.linspace(lo, hi, n_bins + 1)
    v_centres = 0.5 * (v_edges[:-1] + v_edges[1:]).astype(np.float32)

    lut = jnp.asarray(integrated_kernel_table(kernel), jnp.float32)

    n_rays = np.asarray(ray_x).shape[0]
    rx_all = np.asarray(ray_x, np.float32)
    ry_all = np.asarray(ray_y, np.float32)
    n = pos.shape[0]

    def pad(a, n_pad, fill=0.0):
        return jnp.asarray(
            np.pad(np.asarray(a, np.float32), [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1),
                   constant_values=fill)
        )

    ray_blocks = []
    for r0 in range(0, n_rays, _RAY_MACRO):
        r1 = min(r0 + _RAY_MACRO, n_rays)
        rpad = max(_RAY_MACRO, r1 - r0)
        rx = pad(rx_all[r0:r1], rpad)
        ry = pad(ry_all[r0:r1], rpad)
        block = None
        for s0 in range(0, max(n, 1), _MACRO_BATCH):
            s1 = min(s0 + _MACRO_BATCH, n)
            m = s1 - s0
            n_pad = max(chunk, ((m + chunk - 1) // chunk) * chunk)
            part = _spectra_impl(
                pad(pos[s0:s1, 0], n_pad), pad(pos[s0:s1, 1], n_pad),
                pad(h_np[s0:s1], n_pad, fill=1.0), pad(values[s0:s1], n_pad),
                pad(v_eff[s0:s1], n_pad), pad(b_dopp[s0:s1], n_pad, fill=1.0),
                rx, ry, jnp.asarray(v_centres), lut,
                kernel_name=kernel, chunk=chunk, n_bins=n_bins,
                periodic_box=float(box_size) if periodic else None,
                periodic_velocity=v_box if periodic else None,
                profile=profile, voigt_k=voigt_k,
            )
            block = part if block is None else block + part
        ray_blocks.append(block[: r1 - r0])
    spectra = jnp.concatenate(ray_blocks, axis=0)
    return spectra, v_centres


# ---------------------------------------------------------------------------
# Cell-binned engine (config 4 at scale): same candidate scheme as
# sightlines.column_integrate_binned — per-level cell sort, ray blocks scan
# only their 1-ring cell-row span — with the velocity smear as a matmul
# per candidate chunk: tau[B, nbins] += w_col[B, C] @ phi[C, nbins].
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=(
        "kernel_name", "chunk", "n_blocks", "B", "ncx", "ncy", "periodic",
        "n_pad", "n_bins", "periodic_velocity", "profile", "voigt_k",
    ),
)
def _binned_spectra_impl(
    px, py, h, colv, v_eff, b_dopp,  # cell-sorted particles, padded to n_pad
    row_start, row_end,
    rx, ry, ray_row,
    v_centres, lut, box,
    *,
    kernel_name, chunk, n_blocks, B, ncx, ncy, periodic, n_pad, n_bins,
    periodic_velocity, profile="gaussian", voigt_k=0.0,
):
    kernel = get_kernel(kernel_name)
    S = kernel.support_factor
    n_chunk_rows = n_pad // chunk

    def block_fn(_, b):
        r0 = ray_row[b * B]
        r1 = ray_row[b * B + B - 1]
        rxb = jax.lax.dynamic_slice(rx, (b * B,), (B,))
        ryb = jax.lax.dynamic_slice(ry, (b * B,), (B,))

        lo_r = jnp.maximum(r0 - 1, 0)
        hi_r = jnp.minimum(r1 + 1, ncy - 1)
        loA = row_start[lo_r]
        hiA = row_end[hi_r]
        if periodic:
            # wrap spans only when the wrapped row is not already inside the
            # clamped main span (coarse grids: r1 + 1 can reach ncy - 1)
            need_top = (r0 == 0) & (r1 + 1 < ncy - 1)
            need_bot = (r1 == ncy - 1) & (r0 - 1 > 0)
            loB = jnp.where(need_top, row_start[ncy - 1], 0)
            hiB = jnp.where(need_top, row_end[ncy - 1], 0)
            loC = jnp.where(need_bot, row_start[0], 0)
            hiC = jnp.where(need_bot, row_end[0], 0)
        else:
            loB = hiB = loC = hiC = jnp.int32(0)

        def range_sum(tau, lo, hi):
            c0 = lo // chunk
            c1 = jnp.minimum((hi + chunk - 1) // chunk, n_chunk_rows)

            def inner(c, tau):
                g0 = c * chunk
                xs = jax.lax.dynamic_slice(px, (g0,), (chunk,))
                ys = jax.lax.dynamic_slice(py, (g0,), (chunk,))
                hs = jax.lax.dynamic_slice(h, (g0,), (chunk,))
                Ns = jax.lax.dynamic_slice(colv, (g0,), (chunk,))
                vs = jax.lax.dynamic_slice(v_eff, (g0,), (chunk,))
                bs = jax.lax.dynamic_slice(b_dopp, (g0,), (chunk,))
                gidx = g0 + jax.lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)[:, 0]
                live = (gidx >= lo) & (gidx < hi)
                dx = rxb[:, None] - xs[None, :]
                dy = ryb[:, None] - ys[None, :]
                if periodic:
                    dx = dx - jnp.round(dx / box[0]) * box[0]
                    dy = dy - jnp.round(dy / box[1]) * box[1]
                b2 = dx * dx + dy * dy  # (B, C)
                w_col = integrated_kernel_lookup(lut, jnp.sqrt(b2), hs[None, :], S)
                w_col = jnp.where(
                    live[None, :] & (b2 < (S * hs[None, :]) ** 2),
                    w_col * Ns[None, :], 0.0,
                )
                dv = v_centres[:, None] - vs[None, :]  # (nbins, C)
                phi = _profile_sum(
                    dv, 1.0 / bs[None, :], profile, voigt_k, periodic_velocity
                )
                return tau + jnp.einsum(
                    "rc,bc->rb", w_col, phi,
                    precision=jax.lax.Precision.HIGHEST,
                )

            return jax.lax.fori_loop(c0, c1, inner, tau)

        tau = jnp.zeros((B, n_bins), jnp.float32)
        tau = range_sum(tau, loA, hiA)
        if periodic:
            tau = range_sum(tau, loB, hiB)
            tau = range_sum(tau, loC, hiC)
        return None, tau

    _, taus = jax.lax.scan(block_fn, None, jnp.arange(n_blocks, dtype=jnp.int32))
    return taus.reshape(n_blocks * B, n_bins)


def absorption_spectra_binned(
    pos,
    h,
    values,
    velocities_los,
    temperatures,
    ray_x,
    ray_y,
    *,
    cosmology=None,
    box_size: Optional[float] = None,
    atomic_weight: float = 1.008,
    n_bins: int = 512,
    kernel: str = "cubic_spline",
    chunk: int = 1024,
    ray_block: int = 128,
    periodic: bool = True,
    profile: str = "gaussian",
    gamma: Optional[float] = None,
    rest_wavelength_angstrom: float = 1215.67,
) -> tuple[Array, np.ndarray]:
    """Cell-binned per-ray velocity spectra — :func:`absorption_spectra`
    semantics at O(R * N_local) (the dense engine's O(R * N * bins) is
    intractable at the 1e4-ray x 1e7-particle config-4 scale). Same physics,
    tested to 1e-5 against the dense engine. ``profile``/``gamma``/
    ``rest_wavelength_angstrom`` select Voigt damping wings exactly as in
    :func:`absorption_spectra`.
    """
    voigt_k = _resolve_profile(profile, gamma, rest_wavelength_angstrom)
    pos = np.asarray(pos)
    h_np = np.asarray(h, np.float64)
    values = np.asarray(values, np.float32)
    v_pec = np.asarray(velocities_los, np.float32)
    temperature = np.asarray(temperatures)
    if box_size is None and periodic:
        raise ValueError("periodic spectra need box_size")

    if cosmology is not None:
        dv_dx = cosmology.hubble_rate() * cosmology.expansion_factor
    else:
        dv_dx = 0.0
    v_eff = (pos[:, 2] * dv_dx + v_pec).astype(np.float32)
    v_box = float(box_size * dv_dx) if (box_size is not None and dv_dx > 0) else None
    b_dopp = np.maximum(
        doppler_parameter_kms(temperature, atomic_weight), 1e-3
    ).astype(np.float32)
    if v_box is not None:
        v_edges = np.linspace(0.0, v_box, n_bins + 1)
    else:
        lo, hi = float(v_eff.min() - 3 * b_dopp.max()), float(v_eff.max() + 3 * b_dopp.max())
        v_edges = np.linspace(lo, hi, n_bins + 1)
    v_centres = 0.5 * (v_edges[:-1] + v_edges[1:]).astype(np.float32)
    lut = jnp.asarray(integrated_kernel_table(kernel), jnp.float32)
    kspec = get_kernel(kernel)

    x = np.asarray(pos[:, 0], np.float64)
    y = np.asarray(pos[:, 1], np.float64)
    n_rays = np.asarray(ray_x).shape[0]
    rays = np.stack([np.asarray(ray_x, np.float64), np.asarray(ray_y, np.float64)])

    s = kspec.support_factor * h_np
    if periodic:
        x0 = y0 = 0.0
        Lx = Ly = float(box_size)
        x = np.mod(x, Lx)
        y = np.mod(y, Ly)
        rays = np.mod(rays, Lx)
    else:
        pad_w = float(s.max()) if s.size else 1.0
        x0 = min(x.min() if x.size else 0.0, rays[0].min()) - pad_w
        y0 = min(y.min() if y.size else 0.0, rays[1].min()) - pad_w
        Lx = max(x.max() if x.size else 1.0, rays[0].max()) + pad_w - x0
        Ly = max(y.max() if y.size else 1.0, rays[1].max()) + pad_w - y0

    s_max = float(s.max()) if s.size else 1.0
    from .sightlines import _MAX_BIN_LEVELS

    level = np.zeros(x.shape[0], np.int64)
    if s.size:
        with np.errstate(divide="ignore"):
            level = np.floor(np.log2(s_max / np.maximum(s, 1e-30))).astype(np.int64)
        level = np.clip(level, 0, _MAX_BIN_LEVELS - 1)

    tau_total = jnp.zeros((n_rays, n_bins), jnp.float32)
    for li in range(_MAX_BIN_LEVELS):
        sel = np.nonzero(level == li)[0]
        if sel.size == 0:
            continue
        cell = s_max / (1 << li)
        ncx = min(max(1, int(Lx / cell)), 4096)
        ncy = min(max(1, int(Ly / cell)), 4096)
        cx = np.clip(((x[sel] - x0) / (Lx / ncx)).astype(np.int64), 0, ncx - 1)
        cy = np.clip(((y[sel] - y0) / (Ly / ncy)).astype(np.int64), 0, ncy - 1)
        cid = cy * ncx + cx
        order = np.argsort(cid, kind="stable")
        sel = sel[order]
        cid = cid[order]
        n = sel.size
        n_pad = max(chunk, ((n + chunk - 1) // chunk) * chunk)

        def padded(a, fill=0.0):
            out = np.full(n_pad, fill, np.float32)
            out[:n] = a[sel]
            return jnp.asarray(out)

        row_start = np.searchsorted(cid, np.arange(ncy, dtype=np.int64) * ncx).astype(np.int32)
        row_end = np.searchsorted(cid, (np.arange(ncy, dtype=np.int64) + 1) * ncx).astype(np.int32)

        rcx = np.clip(((rays[0] - x0) / (Lx / ncx)).astype(np.int64), 0, ncx - 1)
        rcy = np.clip(((rays[1] - y0) / (Ly / ncy)).astype(np.int64), 0, ncy - 1)
        rorder = np.argsort(rcy * ncx + rcx, kind="stable")
        Bq = ray_block
        r_pad = max(Bq, ((n_rays + Bq - 1) // Bq) * Bq)
        rxp = np.full(r_pad, rays[0][rorder[-1]], np.float32)
        ryp = np.full(r_pad, rays[1][rorder[-1]], np.float32)
        rxp[:n_rays] = rays[0][rorder]
        ryp[:n_rays] = rays[1][rorder]
        rrow = np.full(r_pad, rcy[rorder[-1]], np.int32)
        rrow[:n_rays] = rcy[rorder].astype(np.int32)

        part = _binned_spectra_impl(
            padded(x), padded(y), padded(h_np, fill=1.0), padded(values),
            padded(v_eff), padded(b_dopp, fill=1.0),
            jnp.asarray(row_start), jnp.asarray(row_end),
            jnp.asarray(rxp), jnp.asarray(ryp), jnp.asarray(rrow),
            jnp.asarray(v_centres), lut, jnp.asarray([Lx, Ly], jnp.float32),
            kernel_name=kernel, chunk=chunk, n_blocks=r_pad // Bq, B=Bq,
            ncx=ncx, ncy=ncy, periodic=periodic, n_pad=n_pad, n_bins=n_bins,
            periodic_velocity=v_box, profile=profile, voigt_k=voigt_k,
        )
        inv = np.empty(n_rays, np.int64)
        inv[rorder] = np.arange(n_rays)
        tau_total = tau_total + jnp.asarray(np.asarray(part)[:n_rays][inv])

    return tau_total, v_centres
