# -*- coding: utf-8 -*-
"""Polymer chain models: Debye Gaussian chain and Kholodenko worm.

Reference math: src/mcsas/models/gaussianchain.py:12-73 and
src/mcsas/models/kholodenko.py:16-94.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.precision import dot
from ..ops.special import gauss_legendre, j1_over_x, sine_integral
from ..utils.units import ANGSTROM_SLD, NM, NoUnit
from .base import ParamSpec, SASModel


# ----------------------------------------------------------- Gaussian chain

def _gauss_debye_over_u(u):
    """sqrt(2·(expm1(−u)+u))/u, stable near u→0 (limit 1)."""
    u = jnp.asarray(u)
    thr = 0.3 if u.dtype == jnp.float32 else 1e-3
    small = jnp.abs(u) < thr
    us = jnp.where(small, jnp.ones_like(u), u)
    # exp(-u)-1+u instead of expm1(-u)+u: the cancellation-prone small-u
    # regime is handled by the series branch
    closed = jnp.sqrt(2.0 * (jnp.exp(-us) - 1.0 + us)) / us
    # 2(expm1(−u)+u)/u² = 1 − u/3 + u²/12 − u³/60 + u⁴/360 …
    series = jnp.sqrt(1.0 + u * (-1.0 / 3.0 + u * (
        1.0 / 12.0 + u * (-1.0 / 60.0 + u / 360.0))))
    return jnp.where(small, series, closed)


def _gauss_ff(q, p):
    beta = p["bp"] - (p["k"] * p["rg"] ** 2) * p["etas"]
    u = (q * p["rg"]) ** 2
    res = _gauss_debye_over_u(u) * beta
    return jnp.where(q <= 0.0, beta * jnp.ones_like(res), res)


def _gauss_volume(p):
    return p["k"] * p["rg"] ** 2


GaussianChain = SASModel(
    name="GaussianChain",
    elementwise_q=True,
    can_smear=True,
    doc="Debye Gaussian polymer coil with excess scattering length β "
        "(SASfit Gauss2)",
    params=(
        ParamSpec("rg", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((1.0, 1e2)), generator="logdec1",
                  is_fit=True, display_name="radius of gyration, Rg"),
        ParamSpec("bp", NM.to_si(100.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="uniform",
                  is_fit=True,
                  display_name="scattering length of the polymer"),
        ParamSpec("etas", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, float("inf")),
                  active_range=ANGSTROM_SLD.to_si((0.1, 10.0)),
                  generator="uniform", is_fit=True,
                  display_name="scattering length density of the solvent"),
        ParamSpec("k", 1.0, NoUnit, (0.0, float("inf")),
                  active_range=(0.1, 10.0), generator="uniform", is_fit=True,
                  display_name="volumetric scaling factor of Rg"),
    ),
    ff=_gauss_ff,
    volume=_gauss_volume,
    default_active=("rg",),
)


# --------------------------------------------------------- Kholodenko worm

# Quadrature layout: the Dirac-propagator kernel decays like e^(−z·rate); the
# oscillatory regime (q > 3/kuhn) is damped within z ≲ Z_CUT, so we spend a
# dense composite Gauss-Legendre rule there and a coarse one on the smooth
# tail.  This replaces the reference's adaptive scipy.integrate.quad
# (epsrel 1e-10, limit 1e4; reference: models/kholodenko.py:31-38) with a
# fixed-shape rule suitable for XLA.
_Z_CUT = 40.0
_HEAD_NODES, _HEAD_WEIGHTS = gauss_legendre(16, 128)  # 2048 points on [0,1]
_TAIL_NODES, _TAIL_WEIGHTS = gauss_legendre(8, 8)     # 64 points on [0,1]
# fit-grade rule (float32 MC hot loop): ~4x cheaper, relative error ~1e-3
# in the most oscillatory regime — far below the measurement uncertainty
_FAST_HEAD = gauss_legendre(16, 32)                   # 512 points


def _kho_fz(z, t):
    """f(z) of the Kholodenko propagator, t = q·kuhn/3, stable for large z.

    t<1: sinh(Ez)/(E sinh z),  E=√(1−t²)
    t>1: sin(Fz)/(F sinh z),   F=√(t²−1)
    t=1: z/sinh z (both branches' limit)
    Evaluated with exponential scaling so sinh never overflows.
    """
    eps = 1e-12
    e = jnp.sqrt(jnp.maximum(1.0 - t * t, eps))
    f = jnp.sqrt(jnp.maximum(t * t - 1.0, eps))
    one_m_em2z = -jnp.expm1(-2.0 * z)
    # sinh(Ez)/(E sinh z) = e^{(E−1)z}·(1−e^{−2Ez}) / (E·(1−e^{−2z}))
    sub = jnp.exp((e - 1.0) * z) * -jnp.expm1(-2.0 * e * z) / (
        e * (one_m_em2z + eps))
    # sin(Fz)/(F sinh z) = 2·sin(Fz)·e^{−z} / (F·(1−e^{−2z}))
    sup = 2.0 * jnp.sin(f * z) * jnp.exp(-z) / (f * (one_m_em2z + eps))
    fz = jnp.where(t < 1.0, sub, sup)
    # z→0 limit of all branches is 1
    return jnp.where(z <= 0.0, jnp.ones_like(fz), fz)


def _kho_p0_sq_tx(t, x, head=None):
    """∫₀ˣ f(z)·(2/x)(1−z/x) dz as a pure function of the invariants
    t = q·kuhn/3, x = 3·contour/kuhn (elementwise in t, x; quadrature on
    the last axis)."""
    head_nodes, head_weights = head if head is not None else (
        _HEAD_NODES, _HEAD_WEIGHTS)
    dtype = jnp.result_type(t, x)
    t = jnp.asarray(t, dtype)[..., None]
    xs = jnp.asarray(x, dtype)[..., None]
    head_hi = jnp.minimum(xs, _Z_CUT)

    def integrate(nodes, weights, lo, hi):
        z = lo + (hi - lo) * jnp.asarray(nodes, dtype)
        w = (hi - lo) * jnp.asarray(weights, dtype)
        core = _kho_fz(z, t) * (2.0 / xs) * (1.0 - z / xs)
        return jnp.sum(w * core, axis=-1)

    total = integrate(head_nodes, head_weights, 0.0, head_hi)
    tail = integrate(_TAIL_NODES, _TAIL_WEIGHTS, head_hi, xs)
    total = total + jnp.where(jnp.asarray(x, dtype) > _Z_CUT, tail,
                              jnp.zeros_like(tail))
    return jnp.maximum(total, 0.0)


def _kho_p0_sq(q, kuhn, contour, head=None):
    return _kho_p0_sq_tx(q * kuhn / 3.0, 3.0 * contour / kuhn, head)


# -------- converged rule: Filon (oscillatory) + Boole (smooth) -------------
#
# The composite-GL head above needs nodes ∝ the oscillation frequency
# F = √(t²−1) (2048 for this model's range corners), which made the exact
# rule the whole cost of the float64 post pass.
# This rule is frequency-robust on a fixed 513-node uniform grid:
#
# * t>1 (oscillatory): f(z) = sin(Fz)/(F·sinh z); splitting
#   1/sinh z = 1/z + 2·s(z) with s smooth gives a singular part with the
#   CLOSED FORM (2/x)[Si(FX) − (1−cos FX)/(Fx)] and a smooth remainder
#   g·s integrated by Filon-Simpson, whose error is O(h⁴) *independent of
#   F*.  sin(F z_i) on the uniform grid comes from a two-term rotation
#   recurrence inside a lax.scan — two transcendentals per (t, x) element
#   instead of two per node.
# * t<1 (smooth): composite Boole rule (O(h⁶)) on the same grid, with
#   sinh(e z_i) from the matching hyperbolic recurrence.
# * x > Z_CUT: the coarse GL tail on [Z_CUT, x] as before (for t>1 the
#   integrand is < e^(−Z_CUT) there; only the smooth branch has mass).

_N_HALF = 256          # 2N uniform intervals (2N % 4 == 0 for Boole)


def _filon_coeffs(th):
    """Filon-Simpson coefficients α, β, γ(θ) (Abramowitz & Stegun
    25.4.47-54), with the small-θ series below the cancellation
    threshold."""
    small = th < 0.05
    ts = jnp.where(small, jnp.ones_like(th), th)
    s, c = jnp.sin(ts), jnp.cos(ts)
    s2, c2 = 2.0 * s * c, c * c
    alpha = 1.0 / ts + s2 / (2.0 * ts ** 2) - 2.0 * s * s / ts ** 3
    beta = 2.0 * ((1.0 + c2) / ts ** 2 - s2 / ts ** 3)
    gamma = 4.0 * (s / ts ** 3 - c / ts ** 2)
    t2 = th * th
    alpha_s = th * t2 * (2.0 / 45.0 - t2 * (2.0 / 315.0
                                            - t2 * (2.0 / 4725.0)))
    beta_s = 2.0 / 3.0 + t2 * (2.0 / 15.0 - t2 * (4.0 / 105.0
                                                  - t2 * (2.0 / 567.0)))
    gamma_s = 4.0 / 3.0 - t2 * (2.0 / 15.0 - t2 * (1.0 / 210.0
                                                   - t2 / 11340.0))
    return (jnp.where(small, alpha_s, alpha),
            jnp.where(small, beta_s, beta),
            jnp.where(small, gamma_s, gamma))


def _kho_p0_sq_conv(t, x):
    """Converged ∫₀ˣ f(z)·(2/x)(1−z/x) dz, elementwise in *t* with a
    scalar *x* (the shape the form factor sees: one contribution, a q
    vector).  Validated ≤1e-8 relative against adaptive quadrature
    (tests/test_models.py); replaces the reference's scipy.integrate.quad
    (epsrel 1e-10: /root/reference/src/mcsas/models/kholodenko.py:31-38)
    at XLA-compatible fixed shapes."""
    if jnp.ndim(x) != 0:
        # array-valued x: per-element node grids would be quadratic work;
        # fall back to the frequency-safe dense GL rule
        return _kho_p0_sq_tx(t, x)
    dtype = jnp.result_type(t, x)
    t = jnp.asarray(t, dtype)
    x = jnp.asarray(x, dtype)
    n2 = 2 * _N_HALF
    X = jnp.minimum(x, _Z_CUT)
    h = X / n2
    z = h * jnp.arange(n2 + 1, dtype=dtype)                  # (2N+1,)
    g = (2.0 / x) * (1.0 - z / x)
    # s(z) = 1/(2 sinh z) − 1/(2z): smooth, s(0)=0; series below 0.1
    zc = jnp.where(z < 0.1, jnp.ones_like(z), z)   # series-branch guard
    s_dir = 0.5 / jnp.sinh(zc) - 0.5 / zc
    z2 = z * z
    s_ser = z * (-1.0 / 12.0 + z2 * (7.0 / 720.0
                                     - z2 * (31.0 / 30240.0)))
    s = jnp.where(z < 0.1, s_ser, s_dir)
    phi = g * s
    zp = jnp.where(z <= 0.0, jnp.ones_like(z), z)  # z==0 guard only
    inv_sinh = jnp.where(z <= 0.0, jnp.zeros_like(z),
                         1.0 / jnp.sinh(zp))
    # composite Boole weights: (2h/45)·[7,32,12,32,14,32,12,...,32,7]
    wb = jnp.full((n2 + 1,), 14.0, dtype)
    wb = wb.at[1::2].set(32.0)
    wb = wb.at[2::4].set(12.0)
    wb = wb.at[0].set(7.0).at[n2].set(7.0)
    gw = wb * (2.0 * h / 45.0) * g
    odd = (jnp.arange(n2 + 1) % 2).astype(dtype)

    eps = 1e-12
    e = jnp.sqrt(jnp.maximum(1.0 - t * t, eps))
    F = jnp.sqrt(jnp.maximum(t * t - 1.0, eps))
    sin_d, cos_d = jnp.sin(F * h), jnp.cos(F * h)
    sinh_d, cosh_d = jnp.sinh(e * h), jnp.cosh(e * h)
    zero = jnp.zeros_like(t)
    one = jnp.ones_like(t)

    def body(carry, xs):
        sF, cF, she, che, a_sub, a_e, a_o = carry
        phi_i, gw_i, invs_i, odd_i, is0_i = xs
        # f_sub(z_i) = sinh(e·z_i)/(e·sinh z_i); z=0 limit is 1
        fsub = jnp.where(is0_i > 0.5, one, she * invs_i / e)
        a_sub = a_sub + gw_i * fsub
        term = phi_i * sF
        a_e = a_e + (1.0 - odd_i) * term
        a_o = a_o + odd_i * term
        sF, cF = sF * cos_d + cF * sin_d, cF * cos_d - sF * sin_d
        she, che = she * cosh_d + che * sinh_d, che * cosh_d + she * sinh_d
        return (sF, cF, she, che, a_sub, a_e, a_o), None

    is0 = jnp.zeros((n2 + 1,), dtype).at[0].set(1.0)
    xs = (phi, gw, inv_sinh, odd, is0)
    init = (zero, one, zero, one + zero, zero, zero, zero)
    (_, _, _, _, sub_head, a_e, a_o), _ = jax.lax.scan(body, init, xs)

    # Filon assembly for the smooth remainder ∫ sin(Fz)·φ(z) dz
    sXF, cXF = jnp.sin(F * X), jnp.cos(F * X)
    alpha, beta, gamma = _filon_coeffs(F * h)
    phi_end = phi[n2]
    S_e = a_e - 0.5 * phi_end * sXF              # φ(0) = 0
    filon = h * (-alpha * phi_end * cXF + beta * S_e + gamma * a_o)
    # singular part: ∫ sin(Fz)·g(z)/z dz = (2/x)[Si(FX) − (1−cos FX)/(Fx)]
    sing = (2.0 / x) * (sine_integral(F * X)
                        - (1.0 - cXF) / (F * x))
    sup_head = (sing + 2.0 * filon) / F

    total = jnp.where(t < 1.0, sub_head, sup_head)
    # smooth tail beyond the head window (x > Z_CUT only)
    tdim = t[..., None]
    xs_t = x
    ztail_lo = jnp.minimum(xs_t, _Z_CUT)
    zt = ztail_lo + (xs_t - ztail_lo) * jnp.asarray(_TAIL_NODES, dtype)
    wt = (xs_t - ztail_lo) * jnp.asarray(_TAIL_WEIGHTS, dtype)
    core = _kho_fz(zt, tdim) * (2.0 / xs_t) * (1.0 - zt / xs_t)
    tail = jnp.sum(wt * core, axis=-1)
    total = total + jnp.where(x > _Z_CUT, tail, jnp.zeros_like(tail))
    return jnp.maximum(total, 0.0)


def _kho_ff_impl(q, p, head=None):
    shape = q.shape
    qf = q.reshape(-1)
    p0 = jnp.sqrt(_kho_p0_sq(qf, p["lenKuhn"], p["lenContour"], head))
    pcs = 2.0 * j1_over_x(qf * p["radius"])
    return (p0 * pcs).reshape(shape)


def _kho_ff(q, p):
    """p0·pcs: worm backbone times circular cross-section
    (reference: models/kholodenko.py:81-90; non-squared like the
    original).  Uses the converged Filon/Boole rule — exact-grade at
    ~1/10 the cost of the dense GL head (see _kho_p0_sq_conv)."""
    shape = q.shape
    qf = q.reshape(-1)
    p0 = jnp.sqrt(_kho_p0_sq_conv(qf * p["lenKuhn"] / 3.0,
                                  3.0 * p["lenContour"] / p["lenKuhn"]))
    pcs = 2.0 * j1_over_x(qf * p["radius"])
    return (p0 * pcs).reshape(shape)


def _kho_ff_fast(q, p):
    """Fit-grade variant using the coarse head rule — ~4x cheaper, ~1e-3
    relative error in the most oscillatory regime, far below the
    measurement uncertainty the float32 MC loop fits against."""
    return _kho_ff_impl(q, p, head=_FAST_HEAD)


def _kho_table_factory(bound, q_grid, dtype, smear=None):
    """Fit-grade parameter-grid row table of the worm backbone p0 for the
    float32 MC loop (see ops/tables.py::ParamTable); the circular
    cross-section 2·j1(qr)/qr stays an exact elementwise factor, so the
    radius axis never needs tabulating.

    With *smear* = (locs, smear_w) the backbone rows are baked on the
    FLATTENED locs grid; the lookup applies the exact cross-section at
    each smearing offset and finishes the contraction in-kernel — the
    radius axis still never needs tabulating."""
    from ..ops import tables
    tab_params = tuple(p for p in bound.active
                       if p in ("lenKuhn", "lenContour"))
    # smeared rows are n_off× wider: trade parameter-grid resolution for
    # bake time/memory (interpolation error stays fit-grade)
    res = tables.cap_res(
        ({0: (), 1: (2048,), 2: (256, 48)} if smear is None else
         {0: (), 1: (1024,), 2: (96, 24)})[len(tab_params)])
    grids = [tables.log_grid(*tables.param_product_range(bound, p), nn)
             for p, nn in zip(tab_params, res)]
    fixed = dict(bound.fixed)
    locs = None if smear is None else np.asarray(smear[0])  # (Nq, n_off)
    qd = jnp.asarray(np.asarray(q_grid) if smear is None
                     else locs.ravel(), dtype)

    def row_fn(vals):
        p = dict(fixed)
        for i, name in enumerate(tab_params):
            p[name] = vals[i]
        # converged Filon/Boole rule — the same exact-grade rule the
        # float64 post pass uses (table-tier error is interpolation only)
        return jnp.sqrt(_kho_p0_sq_conv(
            qd * p["lenKuhn"] / 3.0,
            3.0 * p["lenContour"] / p["lenKuhn"]))

    key = ("Kholodenko", tab_params, tables.grid_fingerprint(q_grid),
           tables.smear_fingerprint(smear),
           tuple(sorted(fixed.items())))
    tab = tables.build_param_table(row_fn, grids, dtype, block=64,
                                   cache_key=key)
    lookup = tables.make_lookup(tab.axes, tab_params)

    if smear is not None:
        def ff(gq, values, p):
            # gq = (locs, smear_w): backbone from the table, exact
            # cross-section per smearing offset, contraction in-kernel
            locs32, sw32 = gq
            p0 = lookup(values, p).reshape(locs32.shape)
            f = p0 * 2.0 * j1_over_x(locs32 * p["radius"])
            return dot(f * f, sw32)

        return ff, tab.values, "intensity"

    def ff(q, values, p):
        # backbone rows are valid only on the baked fit grid (the engine
        # always passes it); the cross-section factor is exact in q
        p0 = lookup(values, p)
        pcs = 2.0 * j1_over_x(q * p["radius"])
        return p0 * pcs

    return ff, tab.values


def _kho_volume(p):
    return math.pi * p["lenContour"] * p["radius"] ** 2


Kholodenko = SASModel(
    name="Kholodenko",
    can_smear=True,
    doc="Worm-like chain after Kholodenko (Macromolecules 26 (1993) 4179)",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((1.0, 5.0)), generator="logdec1",
                  is_fit=True, display_name="Radius"),
        ParamSpec("lenKuhn", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((10.0, 50.0)), generator="uniform",
                  is_fit=True, display_name="kuhn length"),
        ParamSpec("lenContour", NM.to_si(2.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((100.0, 1000.0)), generator="uniform",
                  is_fit=True, display_name="contour length"),
    ),
    ff=_kho_ff,
    ff_fast=_kho_ff_fast,
    ff_table_factory=_kho_table_factory,
    volume=_kho_volume,
    default_active=("radius", "lenKuhn", "lenContour"),
)
