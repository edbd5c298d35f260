# -*- coding: utf-8 -*-
"""Ellipsoid models: isotropic spheroids and core-shell variants.

Reference math: src/mcsas/models/ellipsoidsisotropic.py:15-86,
sphericalcoreshell.py:12-78, ellipsoidalcoreshell.py:14-99.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..ops.precision import dot
from ..ops.special import sphere_ff
from ..utils.units import ANGSTROM_SLD, NM, NoUnit, SLD
from .base import ParamSpec, SASModel

_PI43 = 4.0 * math.pi / 3.0


# ------------------------------------------------- EllipsoidsIsotropic

def _ell_iso_rc(p):
    return jnp.where(p["useAspect"] != 0.0, p["a"] * p["aspect"], p["c"])


def _ell_iso_ff_uv(u, v, n, dtype, _ff=sphere_ff):
    """The orientation average as a pure function of the scale invariants
    u = q·a, v = q·c (elementwise in u, v; quadrature on the last axis)."""
    alpha = jnp.asarray(np.linspace(0.0, math.pi / 2.0, n), dtype=dtype)
    sin_a = jnp.sin(alpha)
    cos_a = jnp.cos(alpha)
    u = jnp.asarray(u, dtype)
    v = jnp.asarray(v, dtype)
    x_plug = jnp.sqrt((u[..., None] * sin_a) ** 2
                      + (v[..., None] * cos_a) ** 2)
    fsplit = _ff(x_plug)
    return jnp.sqrt(jnp.mean(fsplit * fsplit * sin_a, axis=-1))


def _ell_iso_ff(q, p, _ff=sphere_ff):
    """Orientation-averaged spheroid a=b, c (Pedersen 1997; reference:
    ellipsoidsisotropic.py:51-71): plug r(α)=√(a²sin²α+c²cos²α) into the
    Rayleigh function and average F²·sin α over α ∈ [0, π/2]."""
    return _ell_iso_ff_uv(q * p["a"], q * _ell_iso_rc(p),
                          int(p["intDiv"]), q.dtype, _ff=_ff)


def _ell_iso_table_factory(bound, q_grid, dtype, smear=None):
    """Fit-grade parameter-grid row table for the float32 MC loop (see
    ops/tables.py::ParamTable); built with a converged α-rule (target the
    true orientation integral, not the reference's intDiv=100
    discretization of it).  With *smear* = (locs, smear_w) the rows are
    the smeared intensity ff²(locs) @ smear_w (see cylinders.py)."""
    from ..ops import tables
    fixed = dict(bound.fixed)
    if "useAspect" not in fixed:
        return None
    n = max(801, int(fixed.get("intDiv", 100)))
    rele = (("a", "aspect") if fixed["useAspect"] != 0.0 else ("a", "c"))
    tab_params = tuple(p for p in bound.active if p in rele)
    res = tables.cap_res({0: (), 1: (4096,),
                          2: (512, 64)}[len(tab_params)])
    grids = [tables.log_grid(*tables.param_product_range(bound, p), nn)
             for p, nn in zip(tab_params, res)]
    if smear is None:
        q32 = jnp.asarray(np.asarray(q_grid), dtype)
    else:
        q32 = jnp.asarray(np.asarray(smear[0]), dtype)      # (Nq, n_off)
        sw32 = jnp.asarray(np.asarray(smear[1]), dtype)

    def row_fn(vals):
        p = dict(fixed)
        for i, name in enumerate(tab_params):
            p[name] = vals[i]
        for name in bound.active:
            p.setdefault(name, 1.0)
        f = _ell_iso_ff_uv(q32 * p["a"], q32 * _ell_iso_rc(p), n, dtype)
        return dot(f * f, sw32) if smear is not None else f

    key = ("EllipsoidsIsotropic", n, tab_params,
           tables.grid_fingerprint(q_grid),
           tables.smear_fingerprint(smear),
           tuple(sorted(fixed.items())))
    block = 8 if smear is not None else 256
    tab = tables.build_param_table(row_fn, grids, dtype, block=block,
                                   cache_key=key)
    lookup = tables.make_lookup(tab.axes, tab_params)

    def ff(q, values, p):
        # valid only on the baked fit grid (the engine always passes it)
        return lookup(values, p)

    if smear is not None:
        return ff, tab.values, "intensity"
    return ff, tab.values


def _ell_iso_volume(p):
    return _PI43 * p["a"] ** 2 * _ell_iso_rc(p)


EllipsoidsIsotropic = SASModel(
    name="EllipsoidsIsotropic",
    can_smear=True,
    doc="Isotropic spheroid with semi-axes a=b, c (SASfit Ellipsoid II)",
    params=(
        ParamSpec("a", NM.to_si(1.0), NM, NM.to_si((0.1, 1e10)),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Radius of semi-axes a, b"),
        ParamSpec("useAspect", 1.0, NoUnit, (0.0, 1.0),
                  display_name="Use aspect ratio (1) or c-axis length (0)"),
        ParamSpec("c", NM.to_si(10.0), NM, NM.to_si((0.1, 1e10)),
                  active_range=NM.to_si((1.0, 1e4)), generator="logdec1",
                  is_fit=True, display_name="Radius of semi-axes c"),
        ParamSpec("aspect", 10.0, NoUnit, (1e-3, 1e3), generator="logdec1",
                  is_fit=True, display_name="aspect ratio of c to a, b"),
        ParamSpec("intDiv", 100.0, NoUnit, (1.0, 1e4),
                  display_name="Orientation Integration Divisions"),
        ParamSpec("sld", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, SLD("Å⁻²").to_si(1e-2)),
                  display_name="Scattering length density difference"),
    ),
    ff=_ell_iso_ff,
    ff_table_factory=_ell_iso_table_factory,
    volume=_ell_iso_volume,
    absvolume=lambda p: _ell_iso_volume(p) * p["sld"] ** 2,
    default_active=("a",),
)


# ------------------------------------------------- SphericalCoreShell

def _sph_cs_ff(q, p, _ff=sphere_ff):
    """Spherical Shell III (SASfit §3.1.4; reference:
    sphericalcoreshell.py:50-69): K(q,R+t,ηs−ηsol) − (vc/vt)·K(q,R,ηs−ηc)
    with K(q,r,Δη) = Δη·3(sin qr − qr cos qr)/(qr)³."""
    r, t = p["radius"], p["t"]
    vc = _PI43 * r ** 3
    vt = _PI43 * (r + t) ** 3
    v_ratio = vc / vt
    ks = (p["eta_s"] - p["eta_sol"]) * _ff(q * (r + t))
    kc = (p["eta_s"] - p["eta_c"]) * _ff(q * r)
    return ks - v_ratio * kc


SphericalCoreShell = SASModel(
    name="SphericalCoreShell",
    elementwise_q=True,
    can_smear=True,
    doc="Core-shell sphere (SASfit Spherical Shell III, §3.1.4)",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Core Radius"),
        ParamSpec("t", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Thickness of Shell"),
        ParamSpec("eta_c", ANGSTROM_SLD.to_si(3.16e-6), ANGSTROM_SLD,
                  (0.0, float("inf")), display_name="Core SLD"),
        ParamSpec("eta_s", ANGSTROM_SLD.to_si(2.53e-6), ANGSTROM_SLD,
                  (0.0, float("inf")), display_name="Shell SLD"),
        ParamSpec("eta_sol", 0.0, ANGSTROM_SLD, (0.0, float("inf")),
                  display_name="Solvent SLD"),
    ),
    ff=_sph_cs_ff,
    volume=lambda p: _PI43 * (p["radius"] + p["t"]) ** 3,
    surface=lambda p: 4.0 * math.pi * (p["radius"] + p["t"]) ** 2,
    default_active=("radius",),
)


# ----------------------------------------------- EllipsoidalCoreShell

def _ell_cs_table_factory(bound, q_grid, dtype, smear=None):
    """Fit-grade parameter-grid row table over the active size parameters
    (a, b, t) — up to trilinear (2³ row gathers); SLDs are never fittable
    and fold into the build.  With *smear* = (locs, smear_w) the rows are
    the smeared intensity ff²(locs) @ smear_w (see cylinders.py)."""
    from ..ops import tables
    fixed = dict(bound.fixed)
    # the μ-integrand is smooth (no endpoint singularity): n=201 is
    # converged to ~1e-3 and keeps the trilinear build affordable
    n = max(201, int(fixed.get("intDiv", 100)))
    rele = ("a", "b", "t")
    tab_params = tuple(p for p in bound.active if p in rele)
    # P=2 spends resolution evenly: shell-thickness phase error dominates
    # the core-shell oscillation, so t needs the same density as a
    res = tables.cap_res({0: (), 1: (4096,), 2: (384, 256),
                          3: (128, 64, 48)}[len(tab_params)])
    grids = [tables.log_grid(*tables.param_product_range(bound, p), nn)
             for p, nn in zip(tab_params, res)]
    if smear is None:
        q32 = jnp.asarray(np.asarray(q_grid), dtype)
    else:
        locs = np.asarray(smear[0])                         # (Nq, n_off)
        q32 = jnp.asarray(locs.ravel(), dtype)
        sw32 = jnp.asarray(np.asarray(smear[1]), dtype)

    def row_fn(vals):
        p = dict(fixed)
        p["intDiv"] = n          # converged μ-rule for the one-time build
        for i, name in enumerate(tab_params):
            p[name] = vals[i]
        f = _ell_cs_ff(q32, p)
        if smear is not None:
            f = f.reshape(locs.shape)
            return dot(f * f, sw32)
        return f

    key = ("EllipsoidalCoreShell", n, tab_params,
           tables.grid_fingerprint(q_grid),
           tables.smear_fingerprint(smear),
           tuple(sorted(fixed.items())))
    block = 8 if smear is not None else 128
    tab = tables.build_param_table(row_fn, grids, dtype, block=block,
                                   cache_key=key)
    lookup = tables.make_lookup(tab.axes, tab_params)

    def ff(q, values, p):
        # valid only on the baked fit grid (the engine always passes it)
        return lookup(values, p)

    if smear is not None:
        return ff, tab.values, "intensity"
    return ff, tab.values


def _ell_cs_ff(q, p, _ff=sphere_ff):
    """Core-shell ellipsoid (SASfit §3.2.3; reference:
    ellipsoidalcoreshell.py:59-90): orientation average over μ ∈ [0, 1] of
    the SLD-weighted sum of 3j1(x)/x terms (== the Rayleigh function)."""
    n = int(p["intDiv"])
    mu = jnp.asarray(np.linspace(0.0, 1.0, n), dtype=q.dtype)
    a, b, t = p["a"], p["b"], p["t"]
    vc = _PI43 * a * b ** 2
    vt = _PI43 * (a + t) * (b + t) ** 2
    v_ratio = vc / vt
    xc = jnp.outer(q, jnp.sqrt(a ** 2 * mu ** 2 + b ** 2 * (1.0 - mu ** 2)))
    xt = jnp.outer(q, jnp.sqrt((a + t) ** 2 * mu ** 2
                               + (b + t) ** 2 * (1.0 - mu ** 2)))
    fsplit = ((p["eta_c"] - p["eta_s"]) * v_ratio * _ff(xc)
              + (p["eta_s"] - p["eta_sol"]) * _ff(xt))
    return jnp.sqrt(jnp.mean(fsplit ** 2, axis=1))


EllipsoidalCoreShell = SASModel(
    name="EllipsoidalCoreShell",
    can_smear=True,
    doc="Core-shell ellipsoid (SASfit §3.2.3)",
    params=(
        ParamSpec("a", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Principal Core Radius"),
        ParamSpec("b", NM.to_si(10.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((1.0, 1e4)), generator="logdec1",
                  is_fit=True, display_name="Equatorial Core Radius"),
        ParamSpec("t", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Thickness of Shell"),
        ParamSpec("eta_c", ANGSTROM_SLD.to_si(3.15e-6), ANGSTROM_SLD,
                  (0.0, float("inf")), display_name="Core SLD"),
        ParamSpec("eta_s", ANGSTROM_SLD.to_si(2.53e-6), ANGSTROM_SLD,
                  (0.0, float("inf")), display_name="Shell SLD"),
        ParamSpec("eta_sol", 0.0, ANGSTROM_SLD, (0.0, float("inf")),
                  display_name="Solvent SLD"),
        ParamSpec("intDiv", 100.0, NoUnit, (1.0, 1e4),
                  display_name="Orientation Integration Divisions"),
    ),
    ff=_ell_cs_ff,
    ff_table_factory=_ell_cs_table_factory,
    volume=lambda p: _PI43 * (p["a"] + p["t"]) * (p["b"] + p["t"]) ** 2,
    default_active=("a",),
)
