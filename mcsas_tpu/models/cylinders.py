# -*- coding: utf-8 -*-
"""Cylinder model family: orientation-averaged isotropic cylinders and the
legacy in-plane (radially) isotropic variants.

Reference math: src/mcsas/models/cylindersisotropic.py:16-103,
cylindersisotropicaspect.py:13-77, cylindersradiallyisotropic.py:14-84,
cylindersradiallyisotropictilted.py:20-108.

The orientation integrals use fixed division counts (``intDiv`` /
``psiAngleDivisions``) which are *static* configuration here — they shape the
XLA computation and cannot be fitted (matching the reference where they are
plain Parameters, never FitParameters).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..ops.precision import dot
from ..ops.special import bessel_j1, j1_over_x, sinc_sin
from ..utils.units import ANGSTROM_SLD, Angle, DEG, NM, NoUnit
from .base import ParamSpec, SASModel

_D2R = math.pi / 180.0


def _cyl_volume(p):
    if "useAspect" in p:
        half = jnp.where(p["useAspect"] != 0.0,
                         p["radius"] * p["aspect"], 0.5 * p["length"])
    else:
        half = p["radius"] * p["aspect"]
    return math.pi * p["radius"] ** 2 * (2.0 * half)


def _cyl_absvolume(p):
    return _cyl_volume(p) * p["sld"] ** 2


# --------------------------------------------------- CylindersIsotropic

def _cyl_half(p):
    return jnp.where(p["useAspect"] != 0.0,
                     p["radius"] * p["aspect"], 0.5 * p["length"])


def _cyl_iso_ff_ab(a, b, n, dtype):
    """The orientation average as a pure function of the scale invariants
    a = qR, b = qL (elementwise in a, b; quadrature on the last axis)."""
    x, step = np.linspace(0.0, 1.0, n, retstep=True)
    step = float(step)       # weak type: a float64 numpy scalar would
    x = jnp.asarray(x[1:-1], dtype=dtype)  # promote the f32 hot loop
    a = jnp.asarray(a, dtype)
    b = jnp.asarray(b, dtype)
    qr_sqrtx = a[..., None] * jnp.sqrt(1.0 - x * x)
    qlx = b[..., None] * x
    fmid = bessel_j1(qr_sqrtx) * jnp.sin(qlx / 2.0) / (qr_sqrtx * qlx)
    f0 = 0.5 * j1_over_x(a)                           # x→0 limit
    f1 = sinc_sin(b / 2.0)                            # x→1 limit
    # trapezoid rule with uniform step, matching np.trapz(f², dx=step):
    # interior points at full weight, both endpoints at half weight
    integral = step * (jnp.sum(fmid * fmid, axis=-1)
                       + 0.5 * (f0 * f0 + f1 * f1))
    return jnp.sqrt(16.0 * integral)


def _cyl_iso_ff(q, p):
    """SASfit eq. 3.215 orientation average (reference:
    cylindersisotropic.py:50-90), integrating x = cos α over [0, 1] with the
    reference's explicit endpoint limits:
    x→0: ½·J1(qR)/(qR);  x→1: sin(qL/2·2)/(qL·…) = sinc(q·halfLength)."""
    half = _cyl_half(p)
    return _cyl_iso_ff_ab(q * p["radius"], q * (2.0 * half),
                          int(p["intDiv"]), q.dtype)


def _cyl_iso_table_factory(bound, q_grid, dtype, smear=None):
    """Fit-grade parameter-grid row table for the float32 MC loop (see
    ops/tables.py::ParamTable): rows over the active size parameters,
    the q axis exact.  Built with a converged rule — the model's default
    intDiv=100 trapezoid carries up to ~20% discretization noise at qR
    in [10, 100] (measured vs n=801); the table targets the true
    integral.

    With *smear* = (locs, smear_w) the rows are the SMEARED intensity
    (ff²(locs) @ smear_w) baked against the engine's own contraction —
    the lookup then returns intensity, not amplitude (reference smearing
    path: src/mcsas/bases/model/sasmodel.py:56-73)."""
    from ..ops import tables
    fixed = dict(bound.fixed)
    if "useAspect" not in fixed:        # not fittable, so always fixed
        return None
    n = max(801, int(fixed.get("intDiv", 100)))
    # only the parameters the form factor actually reads (half-length
    # comes from aspect or length depending on the useAspect switch)
    rele = (("radius", "aspect") if fixed["useAspect"] != 0.0
            else ("radius", "length"))
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
        # active params outside `rele` do not enter the form factor
        for name in bound.active:
            p.setdefault(name, 1.0)
        f = _cyl_iso_ff_ab(q32 * p["radius"],
                           q32 * (2.0 * _cyl_half(p)), n, dtype)
        return dot(f * f, sw32) if smear is not None else f

    key = ("CylindersIsotropic", n, tab_params,
           tables.grid_fingerprint(q_grid),
           tables.smear_fingerprint(smear),
           tuple(sorted(fixed.items())))
    # smeared rows evaluate on the full (Nq, n_off, n_quad) block: keep
    # the per-block temporary bounded
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


def _psi_grid_table_factory(ff_fn, reads, res_map,
                            div_param="psiAngleDivisions",
                            div_conv=3001):
    """Generic fit-grade table factory for the legacy ψ-grid cylinder
    variants (see ops/tables.py::ParamTable): rows over a log grid of
    the ACTIVE parameters the rule reads, the q axis exact.

    Rows are baked with a CONVERGED ψ rule (``div_conv`` divisions, same
    precedent as the CylindersIsotropic n=801 table): the verbatim
    303-point grids under-resolve the orientation average at high qR —
    their value there is quadrature noise oscillating on a parameter
    scale no interpolation can track, while the converged average is
    smooth.  Fit-grade contract as everywhere: the float64 post pass
    re-evaluates the model's own (verbatim) ``ff``.  With *smear* the
    rows bake the smeared intensity against the dataset's own
    contraction (reference smearing path:
    src/mcsas/bases/model/sasmodel.py:56-73)."""
    def factory(bound, q_grid, dtype, smear=None):
        from ..ops import tables
        tab_params = tuple(p for p in bound.active if p in reads)
        if len(tab_params) not in res_map:
            return None
        res = tables.cap_res(res_map[len(tab_params)])
        if not res:
            return None
        grids = [tables.log_grid(*tables.param_product_range(bound, p),
                                 nn)
                 for p, nn in zip(tab_params, res)]
        fixed = dict(bound.fixed)
        fixed[div_param] = float(max(div_conv,
                                     int(fixed.get(div_param, 0))))
        locs = None if smear is None else np.asarray(smear[0])
        qd = jnp.asarray(np.asarray(q_grid) if smear is None
                         else locs.ravel(), dtype)
        if smear is not None:
            sw = jnp.asarray(np.asarray(smear[1]), dtype)

        def row_fn(vals):
            p = dict(fixed)
            for i, name in enumerate(tab_params):
                p[name] = vals[i]
            # active params the rule does not read never enter the rows
            for name in bound.active:
                p.setdefault(name, 1.0)
            f = ff_fn(qd, p)
            if smear is not None:
                return dot((f * f).reshape(locs.shape), sw)
            return f

        key = (ff_fn.__name__, tab_params, int(fixed[div_param]),
               tables.grid_fingerprint(q_grid),
               tables.smear_fingerprint(smear),
               tuple(sorted(fixed.items())))
        # probe-gated: these legacy wedge / in-plane orientation rules
        # oscillate along the parameter axes with phase ~q·L, so over
        # wide ranges NO resolution interpolates fit-grade (measured:
        # radius 512→1024 left p90 error at 0.73) — the probe engages
        # the table only where production-spacing interpolation meets
        # the fit-grade contract, else the engine keeps the exact
        # in-loop quadrature
        tab = tables.build_param_table(
            row_fn, grids, dtype, block=64, cache_key=key, probe=True,
            probe_rows_are_intensity=smear is not None)
        if tab is None:
            return None
        lookup = tables.make_lookup(tab.axes, tab_params)

        def ff(q, values, p):
            # valid only on the baked fit grid (the engine passes it)
            return lookup(values, p)

        if smear is not None:
            return ff, tab.values, "intensity"
        return ff, tab.values

    return factory


CylindersIsotropic = SASModel(
    name="CylindersIsotropic",
    can_smear=True,
    doc="Orientation-averaged isotropic cylinders (SASfit eq. 3.215)",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM,
                  (NM.to_si(0.1), float("inf")), generator="logdec1",
                  is_fit=True, display_name="Cylinder Radius"),
        ParamSpec("useAspect", 1.0, NoUnit, (0.0, 1.0),
                  display_name="Use aspect ratio (1) or length (0)"),
        ParamSpec("length", NM.to_si(10.0), NM,
                  (NM.to_si(0.1), NM.to_si(1e10)), generator="logdec1",
                  is_fit=True, display_name="Length L of the Cylinder"),
        ParamSpec("aspect", 10.0, NoUnit, (1e-3, 1e3), generator="logdec1",
                  is_fit=True, display_name="Aspect ratio of the Cylinder"),
        ParamSpec("intDiv", 100.0, NoUnit, (1.0, 1e4),
                  display_name="Orientation Integration Divisions"),
        ParamSpec("sld", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, float("inf")),
                  display_name="Scattering length density difference"),
    ),
    ff=_cyl_iso_ff,
    ff_table_factory=_cyl_iso_table_factory,
    volume=_cyl_volume,
    absvolume=_cyl_absvolume,
    default_active=("radius",),
)


# --------------------------------------- CylindersIsotropicAspect (legacy)

def _cyl_iso_aspect_ff(q, p):
    """Legacy duplicate cylinder over a ψ grid (reference:
    cylindersisotropicaspect.py:46-71, including its double angle
    conversion of the SI ψ grid — preserved verbatim for parity)."""
    n = int(p["psiAngleDivisions"])
    psi = np.linspace(0.0, math.pi, n) * _D2R   # reference converts twice
    psi = jnp.asarray(psi, dtype=q.dtype)
    qr_sina = jnp.outer(q, p["radius"] * jnp.sin(psi))
    ql_cosa = jnp.outer(q, p["radius"] * p["aspect"] * jnp.cos(psi))
    fsplit = (2.0 * j1_over_x(qr_sina) * sinc_sin(ql_cosa)
              * jnp.sqrt(jnp.abs(jnp.sin(psi))[None, :]))
    return jnp.sqrt(jnp.mean(fsplit ** 2, axis=1))


CylindersIsotropicAspect = SASModel(
    name="CylindersIsotropicAspect",
    can_smear=True,
    doc="Legacy aspect-ratio cylinder over a ψ grid",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM, (0.0, float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="uniform",
                  is_fit=True, display_name="Cylinder radius"),
        ParamSpec("aspect", 10.0, NoUnit, (0.0, float("inf")),
                  active_range=(1.0, 20.0), generator="uniform", is_fit=True,
                  display_name="Aspect ratio L/(2R) of the cylinder"),
        ParamSpec("psiAngle", DEG.to_si(10.0), DEG,
                  (0.0, DEG.to_si(180.0)), generator="uniform", is_fit=True,
                  display_name="in-plane cylinder rotation"),
        ParamSpec("psiAngleDivisions", 303.0, NoUnit, (1.0, float("inf")),
                  display_name="in-plane angle divisions"),
    ),
    ff=_cyl_iso_aspect_ff,
    ff_table_factory=_psi_grid_table_factory(
        _cyl_iso_aspect_ff, ("radius", "aspect"),
        {1: (4096,), 2: (512, 64)}),
    volume=lambda p: math.pi * p["radius"] ** 2
    * (2.0 * p["radius"] * p["aspect"]),
    default_active=("radius", "psiAngle"),
)


# ------------------------------------------ CylindersRadiallyIsotropic

def _cyl_radial_ff2d(q, psi, p):
    """Anisotropic in-plane cylinder at detector azimuth ψ (Pedersen 1997
    eq. for a cylinder; fig. 1 of Pauw et al., J. Appl. Cryst. 2010): the
    un-averaged integrand of _cyl_radial_ff, evaluated at the data's own
    ψ instead of an orientation grid.  Powers the working 2D (q, ψ) fit
    that the reference's dormant path (mcsas.py:617-651) never finished."""
    a = psi - p["psiAngle"]
    qr_sina = q * p["radius"] * jnp.sin(a)
    ql_cosa = q * (p["radius"] * p["aspect"]) * jnp.cos(a)
    return 2.0 * j1_over_x(qr_sina) * sinc_sin(ql_cosa)


def _cyl_radial_ff(q, p):
    """In-plane isotropic cylinders (reference:
    cylindersradiallyisotropic.py:50-75): ψ grid spans the psiAngle value
    range, rotated by the fitted psiAngle."""
    n = int(p["psiAngleDivisions"])
    psi = jnp.asarray(
        np.linspace(0.01, 2.0 * math.pi + 0.01, n), dtype=q.dtype)
    fsplit = _cyl_radial_ff2d(q[:, None], psi[None, :], p)
    return jnp.sqrt(jnp.mean(fsplit ** 2, axis=1))


CylindersRadiallyIsotropic = SASModel(
    name="CylindersRadiallyIsotropic",
    doc="Radially (in-plane) isotropic cylinders",
    params=(
        ParamSpec("radius", NM.to_si(1.0), NM,
                  (NM.to_si(0.1), float("inf")),
                  active_range=NM.to_si((0.1, 1e3)), generator="logdec1",
                  is_fit=True, display_name="Cylinder radius"),
        ParamSpec("aspect", 10.0, NoUnit, (0.1, float("inf")),
                  active_range=(1.0, 20.0), generator="uniform", is_fit=True,
                  display_name="Aspect ratio L/(2R) of the cylinder"),
        ParamSpec("psiAngle", 0.17, Angle("rad"),
                  (0.01, 2.0 * math.pi + 0.01), generator="uniform",
                  is_fit=True, display_name="in-plane cylinder rotation"),
        ParamSpec("psiAngleDivisions", 303.0, NoUnit, (1.0, float("inf")),
                  display_name="in-plane angle divisions"),
        ParamSpec("sld", ANGSTROM_SLD.to_si(1e-6), ANGSTROM_SLD,
                  (0.0, float("inf")),
                  display_name="scattering length density difference"),
    ),
    ff=_cyl_radial_ff,
    ff_table_factory=_psi_grid_table_factory(
        _cyl_radial_ff, ("radius", "aspect", "psiAngle"),
        {1: (4096,), 2: (512, 64), 3: (128, 32, 16)}),
    ff2d=_cyl_radial_ff2d,
    volume=lambda p: math.pi * p["radius"] ** 2
    * (2.0 * p["radius"] * p["aspect"]),
    absvolume=lambda p: math.pi * p["radius"] ** 2
    * (2.0 * p["radius"] * p["aspect"]) * p["sld"] ** 2,
    default_active=("radius", "psiAngle"),
)


# ------------------------------------- CylindersRadiallyIsotropicTilted

def _phi_centroids(divisions: int) -> np.ndarray:
    """Equal-probability Gaussian segment centroids (positive z-scores).

    Reproduces scipy.stats.norm.interval over linspace(0, 0.99, n+1)
    (reference: cylindersradiallyisotropictilted.py:71-74) without scipy:
    interval(x)[1] == ppf(0.5 + x/2)."""
    from statistics import NormalDist
    x = np.linspace(0.0, 0.99, divisions + 1)
    ctr = x[:-1] + np.diff(x) / 2.0
    nd = NormalDist()
    return np.array([nd.inv_cdf(0.5 + c / 2.0) for c in ctr])


def _cyl_tilted_ff2d(q, psi, p):
    """Anisotropic tilted cylinder at detector azimuth ψ [rad]: the
    un-ψ-averaged integrand of _cyl_tilted_ff with the Gaussian
    out-of-plane tilt average retained — closes the 2D capability for
    the one model the reference left without it (upstream UNFINISHED:
    cylindersradiallyisotropictilted.py:61-102).  The upstream quirks
    are preserved deliberately: tilt centroids are standard z-scores
    interpreted as DEGREES, and the degree-valued psiAngle rotates the
    in-plane azimuth."""
    a = psi - p["psiAngle"] * _D2R
    phi_ctr = _phi_centroids(int(p["phiDistDivisions"]))
    qr_sina = q * p["radius"] * jnp.sin(a)
    f = 0.0
    for phi in phi_ctr:
        ql_cosa = (q * p["radius"] * p["aspect"]
                   * math.cos(phi * _D2R) * jnp.cos(a))
        f = f + 2.0 * j1_over_x(qr_sina) * sinc_sin(ql_cosa)
    return f / len(phi_ctr)


def _cyl_tilted_ff(q, p):
    """Radially isotropic cylinders with Gaussian out-of-plane tilt.
    NOTE: marked *UNFINISHED* upstream — the tilt centroids are standard
    z-scores interpreted as degrees and phiDistWidth is unused; behavior is
    preserved verbatim for parity (reference:
    cylindersradiallyisotropictilted.py:61-102)."""
    n = int(p["psiAngleDivisions"])
    psi = jnp.asarray(np.linspace(0.1, 180.1, n), dtype=q.dtype)
    phi_ctr = _phi_centroids(int(p["phiDistDivisions"]))
    qr_sina = jnp.outer(q, p["radius"] * jnp.sin(psi * _D2R))
    fcyl = 0.0
    for phi in phi_ctr:
        ql_cosa = jnp.outer(
            q, p["radius"] * p["aspect"]
            * math.cos(phi * _D2R) * jnp.cos(psi * _D2R))
        fsplit = (2.0 * j1_over_x(qr_sina)
                  * sinc_sin(ql_cosa))
        fcyl = fcyl + jnp.sqrt(jnp.mean(fsplit ** 2, axis=1)) / len(phi_ctr)
    return fcyl


CylindersRadiallyIsotropicTilted = SASModel(
    name="CylindersRadiallyIsotropicTilted",
    doc="Radially isotropic cylinders with Gaussian out-of-plane tilt "
        "(UNFINISHED upstream, kept for parity)",
    params=(
        ParamSpec("radius", 1.0, NoUnit, (0.1, float("inf")),
                  active_range=(0.1, 1e3), generator="uniform", is_fit=True,
                  display_name="Cylinder radius"),
        ParamSpec("aspect", 10.0, NoUnit, (0.1, float("inf")),
                  active_range=(1.0, 20.0), generator="uniform", is_fit=True,
                  display_name="Aspect ratio L/(2R) of the cylinder"),
        ParamSpec("psiAngle", 0.1, NoUnit, (0.1, 180.1), generator="uniform",
                  is_fit=True, display_name="in-plane cylinder rotation"),
        ParamSpec("psiAngleDivisions", 303.0, NoUnit, (1.0, float("inf")),
                  display_name="in-plane angle divisions"),
        ParamSpec("phiDistWidth", 10.0, NoUnit, (0.1, 90.1),
                  display_name="out-of-plane axis distribution width"),
        ParamSpec("phiDistDivisions", 9.0, NoUnit, (1.0, float("inf")),
                  display_name="out of plane integration divisions"),
    ),
    # no table tier: the upstream-UNFINISHED tilt rule does not converge
    # with its psi grid at high qR (the orientation integrand oscillates
    # ~qL times across the grid), so there is no smooth target to
    # tabulate — the model stays on the quadrature kernel
    ff=_cyl_tilted_ff,
    ff2d=_cyl_tilted_ff2d,
    volume=lambda p: math.pi * p["radius"] ** 2
    * (2.0 * p["radius"] * p["aspect"]),
    default_active=("radius",),
)
