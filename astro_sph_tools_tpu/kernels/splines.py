"""SPH smoothing kernels, pure ``jax.numpy`` (vmappable, differentiable).

Parity target: the reference's native kernel
(`/root/reference/src/astro_sph_tools/tools/projections/_kernels.pyx:9-20`,
named ``quartic_spline_kernel`` but actually the standard M4 *cubic* spline):

    q = r / h
    W = (1 - 1.5 q^2 + 0.75 q^3) / (pi h^3)   for q < 1
    W = 0.25 (2 - q)^3 / (pi h^3)             for 1 <= q < 2
    W = 0                                     otherwise

i.e. compact support of **2 h**. All kernels here follow the same convention:
``h`` is the Gadget-style smoothing length and the support radius is
``support_factor * h`` (2 for cubic/Wendland as used here, 3 for the quintic).
Each kernel integrates to 1 over 3D space.

The Wendland kernels (north-star requirement, BASELINE.json) are expressed
with support ``H = 2 h`` so that the engine's ``r < 2h`` candidate masks
(`_pixel_calculations.pyx:31`) apply uniformly.

These are elementwise: polynomial evaluation + one rsqrt-class op;
branch-free via ``jnp.where`` so they fuse into the deposit pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_INV_PI = 1.0 / math.pi


def cubic_spline_kernel(r: Array, h: Array) -> Array:
    """M4 cubic spline, 3D normalisation, support 2h (reference kernel)."""
    q = r / h
    inv_h3 = _INV_PI / (h * h * h)
    inner = 1.0 - 1.5 * q * q + 0.75 * q * q * q
    outer_base = 2.0 - q
    outer = 0.25 * outer_base * outer_base * outer_base
    w = jnp.where(q < 1.0, inner, jnp.where(q < 2.0, outer, 0.0))
    return w * inv_h3


def wendland_c2_kernel(r: Array, h: Array) -> Array:
    """Wendland C2, 3D, support H = 2h: W = 21/(2 pi H^3) (1-u)^4 (1+4u)."""
    u = r / (2.0 * h)
    norm = 21.0 / (16.0 * math.pi) / (h * h * h)  # 21/(2 pi (2h)^3)
    one_m_u = jnp.maximum(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    return norm * (p2 * p2) * (1.0 + 4.0 * u)


def wendland_c4_kernel(r: Array, h: Array) -> Array:
    """Wendland C4, 3D, support H = 2h: W = 495/(32 pi H^3)(1-u)^6(1+6u+35u^2/3)."""
    u = r / (2.0 * h)
    norm = 495.0 / (256.0 * math.pi) / (h * h * h)  # 495/(32 pi (2h)^3)
    one_m_u = jnp.maximum(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    p6 = p2 * p2 * p2
    return norm * p6 * (1.0 + 6.0 * u + (35.0 / 3.0) * u * u)


def wendland_c6_kernel(r: Array, h: Array) -> Array:
    """Wendland C6, 3D, support H = 2h: W = 1365/(64 pi H^3)(1-u)^8(1+8u+25u^2+32u^3)."""
    u = r / (2.0 * h)
    norm = 1365.0 / (512.0 * math.pi) / (h * h * h)  # 1365/(64 pi (2h)^3)
    one_m_u = jnp.maximum(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    p4 = p2 * p2
    p8 = p4 * p4
    return norm * p8 * (1.0 + 8.0 * u + 25.0 * u * u + 32.0 * u * u * u)


def quintic_spline_kernel(r: Array, h: Array) -> Array:
    """M6 quintic spline, 3D, support 3h: W = [ (3-q)^5 - 6(2-q)^5 + 15(1-q)^5 ] / (120 pi h^3)."""
    q = r / h
    norm = 1.0 / (120.0 * math.pi) / (h * h * h)

    def p5(x):
        xc = jnp.maximum(x, 0.0)
        x2 = xc * xc
        return x2 * x2 * xc

    w = p5(3.0 - q) - 6.0 * p5(2.0 - q) + 15.0 * p5(1.0 - q)
    return norm * jnp.where(q < 3.0, w, 0.0)


# Reference-compat alias: the reference misnames its cubic spline "quartic"
# (_kernels.pyx:9). Provided so code written against the reference API works.
quartic_spline_kernel = cubic_spline_kernel


# --- dimensionless shape functions ------------------------------------------
#
# W(r, h) = norm_3d / h^3 * shape_q(r / h): the hot deposit kernel hoists
# 1/h and the normalisation to per-particle (1, C) factors and evaluates
# only the divide-free polynomial shape on the (R, C) footprint block —
# the (R, C)-wide divides in the W(r, h) form would dominate there.
# Each shape is exactly zero beyond its support.


def cubic_spline_shape(q: Array) -> Array:
    inner = 1.0 - 1.5 * q * q + 0.75 * q * q * q
    outer_base = 2.0 - q
    outer = 0.25 * outer_base * outer_base * outer_base
    return jnp.where(q < 1.0, inner, jnp.where(q < 2.0, outer, 0.0))


def wendland_c2_shape(q: Array) -> Array:
    u = 0.5 * q
    one_m_u = jnp.maximum(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    return (p2 * p2) * (1.0 + 4.0 * u)


def wendland_c4_shape(q: Array) -> Array:
    u = 0.5 * q
    one_m_u = jnp.maximum(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    p6 = p2 * p2 * p2
    return p6 * (1.0 + 6.0 * u + (35.0 / 3.0) * u * u)


def wendland_c6_shape(q: Array) -> Array:
    u = 0.5 * q
    one_m_u = jnp.maximum(1.0 - u, 0.0)
    p2 = one_m_u * one_m_u
    p8 = p2 * p2 * p2 * p2
    return p8 * (1.0 + 8.0 * u + 25.0 * u * u + 32.0 * u * u * u)


def quintic_spline_shape(q: Array) -> Array:
    def p5(x):
        xc = jnp.maximum(x, 0.0)
        x2 = xc * xc
        return x2 * x2 * xc

    w = p5(3.0 - q) - 6.0 * p5(2.0 - q) + 15.0 * p5(1.0 - q)
    return jnp.where(q < 3.0, w, 0.0)


@dataclass(frozen=True)
class KernelSpec:
    """Static description of an SPH kernel family."""

    name: str
    support_factor: float  # support radius = support_factor * h
    w: Callable[[Array, Array], Array]  # W(r, h), 3D-normalised
    # divide-free split: W(r, h) = norm_3d / h^3 * shape_q(r / h)
    shape_q: Optional[Callable[[Array], Array]] = None
    norm_3d: float = 0.0


KERNELS: dict[str, KernelSpec] = {
    "cubic_spline": KernelSpec(
        "cubic_spline", 2.0, cubic_spline_kernel,
        cubic_spline_shape, 1.0 / math.pi,
    ),
    "wendland_c2": KernelSpec(
        "wendland_c2", 2.0, wendland_c2_kernel,
        wendland_c2_shape, 21.0 / (16.0 * math.pi),
    ),
    "wendland_c4": KernelSpec(
        "wendland_c4", 2.0, wendland_c4_kernel,
        wendland_c4_shape, 495.0 / (256.0 * math.pi),
    ),
    "wendland_c6": KernelSpec(
        "wendland_c6", 2.0, wendland_c6_kernel,
        wendland_c6_shape, 1365.0 / (512.0 * math.pi),
    ),
    "quintic_spline": KernelSpec(
        "quintic_spline", 3.0, quintic_spline_kernel,
        quintic_spline_shape, 1.0 / (120.0 * math.pi),
    ),
}


def get_kernel(name: str) -> KernelSpec:
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(
            f"Unknown SPH kernel {name!r}; available: {sorted(KERNELS)}"
        ) from None


# --- line-integrated (column) kernels ---------------------------------------
#
# The reference projector evaluates the *3D* kernel at the projected 2D radius
# (_pixel_calculations.pyx:32-33) — a cheap approximation. For physically
# correct column densities we also provide the line-integrated kernel
#     Y(b, h) = 2 * Integral_0^{sqrt(S^2 - b^2)} W(sqrt(b^2 + z^2), h) dz ,
# with S the support radius. It is tabulated once per kernel into a LUT over
# u = b / S in [0, 1] (dimensionless: Y(b, h) = y(u) / h^2) and looked up with
# linear interpolation — a gather + FMA on TPU, far cheaper than quadrature in
# the inner loop.


def _integrated_shape_table(spec: KernelSpec, n_table: int, n_quad: int = 256) -> np.ndarray:
    """Tabulate y(u) = h^2 * Y(u * S, h) by Gauss-Legendre quadrature (f64)."""
    S = spec.support_factor
    nodes, weights = np.polynomial.legendre.leggauss(n_quad)
    u = np.linspace(0.0, 1.0, n_table)
    b = u * S  # in units of h
    z_max = np.sqrt(np.maximum(S * S - b * b, 0.0))
    # map nodes from [-1,1] to [0, z_max]
    z = 0.5 * z_max[:, None] * (nodes[None, :] + 1.0)
    r = np.sqrt(b[:, None] ** 2 + z**2)
    # escape any ambient jit trace: this quadrature must evaluate eagerly
    # even when the table is first requested from inside a traced function
    with jax.ensure_compile_time_eval():
        r_j = jnp.asarray(r)
        w_vals = np.asarray(spec.w(r_j, jnp.ones_like(r_j)))
    y = 2.0 * 0.5 * z_max * (w_vals * weights[None, :]).sum(axis=1)
    return y.astype(np.float64)


_INTEGRATED_LUT_CACHE: dict[tuple[str, int], np.ndarray] = {}


def integrated_kernel_table(name: str, n_table: int = 4096) -> np.ndarray:
    """The dimensionless line-integral LUT y(u), u = b / (support_factor*h)."""
    key = (name, n_table)
    if key not in _INTEGRATED_LUT_CACHE:
        _INTEGRATED_LUT_CACHE[key] = _integrated_shape_table(get_kernel(name), n_table)
    return _INTEGRATED_LUT_CACHE[key]


def integrated_kernel_lookup(table: Array, b: Array, h: Array, support_factor: float) -> Array:
    """Evaluate Y(b, h) = y(b / (S h)) / h^2 by linear interpolation into *table*."""
    n = table.shape[0]
    u = b / (support_factor * h)
    x = jnp.clip(u, 0.0, 1.0) * (n - 1)
    i0 = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    frac = x - i0.astype(x.dtype)
    y = table[i0] * (1.0 - frac) + table[i0 + 1] * frac
    return jnp.where(u < 1.0, y / (h * h), 0.0)


# --- gather-free column-kernel evaluation (Pallas-safe) ----------------------
#
# LUT interpolation needs a vector gather, which a kernel's register tiles
# do not offer. For the deposit kernel's integrated projection the shape
# function y(u) is instead fit ONCE per kernel with a single high-degree
# Chebyshev series in t = u^2 (even in u, so no sqrt needed) and evaluated by
# the Clenshaw recurrence — pure FMAs, numerically stable in f32
# (max relative error at degree 44: cubic 1.0e-6, Wendland C2 2.3e-6, all
# others <=5e-7 vs the quadrature table; inside the 1e-5 budget).

_INTEGRATED_CHEB_CACHE: dict[tuple[str, int], tuple[float, ...]] = {}


def integrated_kernel_chebyshev(name: str, degree: int = 44) -> tuple[float, ...]:
    """Chebyshev coefficients c_k of y(u) in x = 2 u^2 - 1 on [-1, 1]."""
    key = (name, degree)
    if key not in _INTEGRATED_CHEB_CACHE:
        tab = integrated_kernel_table(name, 8192)
        u = np.linspace(0.0, 1.0, 8192)
        x = 2.0 * u * u - 1.0
        c = np.polynomial.chebyshev.chebfit(x, tab, degree)
        _INTEGRATED_CHEB_CACHE[key] = tuple(float(v) for v in c)
    return _INTEGRATED_CHEB_CACHE[key]


def clenshaw(x: Array, coeffs: tuple[float, ...]) -> Array:
    """Evaluate a Chebyshev series at x in [-1, 1] (static coefficients)."""
    b1 = jnp.zeros_like(x)
    b2 = jnp.zeros_like(x)
    for k in range(len(coeffs) - 1, 0, -1):
        b1, b2 = 2.0 * x * b1 - b2 + coeffs[k], b1
    return x * b1 - b2 + coeffs[0]
