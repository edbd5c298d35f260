# -*- coding: utf-8 -*-
"""Numerically-stable special functions for form-factor kernels.

These are the building blocks of the model bank, written dtype-polymorphic
(float32 on the device for the MC hot loop, float64 on host for golden
validation).
Stability matters because the reference relies on float64 throughout, while
the device compute path is float32: naive evaluation of expressions like
``3(sin x − x cos x)/x³`` loses all precision for small x from catastrophic
cancellation, so every kernel here switches to a Taylor series below a
dtype-aware threshold.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _small_threshold(x):
    # series are accurate to ~eps below these thresholds for each dtype
    return 0.5 if x.dtype == jnp.float32 else 0.05


def sphere_ff(x):
    """Rayleigh sphere form factor 3(sin x − x cos x)/x³ with x = q·r.

    Reference math: src/mcsas/models/sphere.py:55-63.  Series switch keeps
    full relative precision near x→0 where the closed form cancels.
    """
    x = jnp.asarray(x)
    small = jnp.abs(x) < _small_threshold(x)
    xs = jnp.where(small, jnp.ones_like(x), x)  # no 0-div in dead lane
    closed = 3.0 * (jnp.sin(xs) - xs * jnp.cos(xs)) / xs ** 3
    x2 = x * x
    series = 1.0 + x2 * (-1.0 / 10.0 + x2 * (
        1.0 / 280.0 + x2 * (-1.0 / 15120.0)))
    return jnp.where(small, series, closed)


def j1sph_over_x(x):
    """(sin x − x cos x)/x³ == sphere_ff/3; spherical Bessel j1(x)/x."""
    return sphere_ff(x) / 3.0


def sinc_sin(x):
    """sin(x)/x with the x→0 limit handled."""
    x = jnp.asarray(x)
    small = jnp.abs(x) < _small_threshold(x)
    xs = jnp.where(small, jnp.ones_like(x), x)
    x2 = x * x
    series = 1.0 + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0))
    return jnp.where(small, series, jnp.sin(xs) / xs)


# --- cylindrical Bessel J1 -------------------------------------------------
# Rational approximations after Abramowitz & Stegun 9.4.4 / 9.4.6,
# |error| < 1.3e-8 relative to J1 — sufficient for the ≤1e-4/1e-5 golden
# tolerances used by the model regression tests.

_J1_SMALL = np.array([
    0.5, -0.56249985, 0.21093573, -0.03954289, 0.00443319, -0.00031761,
    0.00001109])
_J1_F = np.array([
    0.79788456, 0.00000156, 0.01659667, 0.00017105, -0.00249511,
    0.00113653, -0.00020033])
_J1_THETA = np.array([
    -2.35619449, 0.12499612, 0.00005650, -0.00637879, 0.00074348,
    0.00079824, -0.00029166])


def _poly(coeffs, t):
    if isinstance(coeffs, np.ndarray):
        # float64 numpy scalars are NOT weak types: with x64 enabled they
        # would silently promote a float32 hot-loop argument to float64
        coeffs = coeffs.astype(t.dtype)
    acc = jnp.zeros_like(t) + coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def bessel_j1(x):
    """Cylindrical Bessel function of the first kind, order 1."""
    x = jnp.asarray(x)
    sign = jnp.sign(x)
    ax = jnp.abs(x)
    small = ax <= 3.0
    # |x| <= 3: J1(x)/x as polynomial in (x/3)^2
    t_small = (ax / 3.0) ** 2
    j_small = ax * _poly(_J1_SMALL, t_small)
    # |x| > 3: amplitude/phase form
    ax_big = jnp.where(small, jnp.full_like(ax, 3.0), ax)
    t_big = 3.0 / ax_big
    f1 = _poly(_J1_F, t_big)
    theta1 = ax_big + _poly(_J1_THETA, t_big)
    j_big = f1 * jnp.cos(theta1) / jnp.sqrt(ax_big)
    return sign * jnp.where(small, j_small, j_big)


def j1_over_x(x):
    """J1(x)/x with the x→0 limit 1/2 handled exactly."""
    x = jnp.asarray(x)
    tiny = jnp.abs(x) < 1e-6
    xs = jnp.where(tiny, jnp.ones_like(x), x)
    return jnp.where(tiny, 0.5 - x * x / 16.0, bessel_j1(xs) / xs)


# --- Percus-Yevick / LMA structure factor ----------------------------------

def py_G_over_A(A, alpha, beta, gamma):
    """G(A)/A for the LMA-PY hard-sphere structure factor.

    Closed form from Kinning & Thomas (reference:
    src/mcsas/models/lmadensesphere.py:76-86), evaluated as G/A so the
    downstream 24μG/A never divides by zero, with series switches below
    the cancellation threshold (series derived symbolically):

    g1/A = (sin A − A cos A)/A³              → 1/3 − A²/30 + A⁴/840 …
    g2/A = (2A sin A + (2−A²)cos A − 2)/A⁴   → 1/4 − A²/36 + A⁴/960 …
    g3/A = (−A⁴cos A + 4((3A²−6)cos A + (A³−6A)sin A + 6))/A⁶
                                             → 1/6 − A²/48 + A⁴/1200 …
    """
    A = jnp.asarray(A)
    small = jnp.abs(A) < (1.0 if A.dtype == jnp.float32 else 0.2)
    As = jnp.where(small, jnp.ones_like(A), A)
    s, c = jnp.sin(As), jnp.cos(As)
    g1 = (s - As * c) / As ** 3
    g2 = (2.0 * As * s + (2.0 - As ** 2) * c - 2.0) / As ** 4
    g3 = (-As ** 4 * c
          + 4.0 * ((3.0 * As ** 2 - 6.0) * c
                   + (As ** 3 - 6.0 * As) * s + 6.0)) / As ** 6
    A2 = A * A
    g1s = 1.0 / 3.0 + A2 * (-1.0 / 30.0 + A2 * (
        1.0 / 840.0 + A2 * (-1.0 / 45360.0)))
    g2s = 1.0 / 4.0 + A2 * (-1.0 / 36.0 + A2 * (
        1.0 / 960.0 + A2 * (-1.0 / 50400.0)))
    g3s = 1.0 / 6.0 + A2 * (-1.0 / 48.0 + A2 * (
        1.0 / 1200.0 + A2 * (-1.0 / 60480.0)))
    g1 = jnp.where(small, g1s, g1)
    g2 = jnp.where(small, g2s, g2)
    g3 = jnp.where(small, g3s, g3)
    return alpha * g1 + beta * g2 + gamma * g3


# --- sine integral ---------------------------------------------------------

# Gauss-Laguerre rule for the auxiliary functions of Si:
#   f(y) = ∫₀^∞ e^{-u}·y/(y²+u²) du,   g(y) = ∫₀^∞ e^{-u}·u/(y²+u²) du
# (rational integrands — no transcendentals at evaluation time).  The
# integrands are analytic with poles at u = ±iy, so for y above the
# Taylor cutover the rule converges geometrically; 64 nodes reach ~1e-13
# relative at y=6 (validated in tests/test_models.py against scipy.sici).
_SI_LAG_X, _SI_LAG_W = np.polynomial.laguerre.laggauss(64)
_SI_CUT = 6.0
# Taylor Si(y) = Σ (-1)^k y^(2k+1)/((2k+1)(2k+1)!): coefficients of y²ᵏ
import math as _math

_SI_TAYLOR = np.array(
    [(-1.0) ** k / ((2 * k + 1) * float(_math.factorial(2 * k + 1)))
     for k in range(22)], np.float64)


def sine_integral(y):
    """Si(y) = ∫₀^y sin(u)/u du for y ≥ 0, full float64 accuracy.

    Taylor series below y=6; above, the auxiliary-function identity
    Si(y) = π/2 − f(y)·cos y − g(y)·sin y with f, g evaluated by a fixed
    Gauss-Laguerre rule over rational integrands (A&S 5.2.8/5.2.12-13).
    """
    y = jnp.asarray(y)
    dt = y.dtype
    small = y < _SI_CUT
    # Taylor branch (clamped argument so the large-y lanes stay finite)
    ys = jnp.where(small, y, jnp.zeros_like(y))
    taylor = ys * _poly(jnp.asarray(_SI_TAYLOR, dt), ys * ys)
    # auxiliary branch
    yb = jnp.where(small, jnp.full_like(y, _SI_CUT), y)
    u = jnp.asarray(_SI_LAG_X, dt)
    w = jnp.asarray(_SI_LAG_W, dt)
    den = 1.0 / (yb[..., None] ** 2 + u ** 2)
    f = jnp.sum(w * den, axis=-1) * yb
    g = jnp.sum((w * u) * den, axis=-1)
    asym = (np.pi / 2.0) - f * jnp.cos(yb) - g * jnp.sin(yb)
    return jnp.where(small, taylor, asym)


# --- quadrature ------------------------------------------------------------

def gauss_legendre(n_points: int, n_panels: int = 1):
    """Composite Gauss-Legendre nodes/weights on [0, 1] (host-side numpy).

    Returns float64 (nodes, weights) of length n_points*n_panels; scale by
    the integration interval at use site.
    """
    x, w = np.polynomial.legendre.leggauss(n_points)
    x = 0.5 * (x + 1.0)   # → (0, 1)
    w = 0.5 * w
    nodes, weights = [], []
    for p in range(n_panels):
        lo = p / n_panels
        nodes.append(lo + x / n_panels)
        weights.append(w / n_panels)
    return np.concatenate(nodes), np.concatenate(weights)
