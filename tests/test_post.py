# -*- coding: utf-8 -*-
"""Post-fit analysis: fractions, observability, histograms, moments against
an independent numpy re-derivation of the reference math
(mcsas.py:445-615, utils/parameter.py:20-154,420-479)."""
import math

import numpy as np
import pytest

from mcsas_tpu import data
from mcsas_tpu.config import McSASConfig
from mcsas_tpu.models import get_model
from mcsas_tpu.post.histogram import (HistogramSpec, compute_fractions,
                                      compute_histogram,
                                      default_histograms, histogram_all)

PI43 = 4 * math.pi / 3


@pytest.fixture(scope="module")
def setup(refdata):
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    bound = get_model("Sphere").bind()
    cfg = McSASConfig(num_contribs=20, num_reps=3)
    rng = np.random.default_rng(3)
    # synthetic "fit result": radii clustered near 10 nm
    contribs = rng.uniform(5e-9, 20e-9, (3, 20, 1))
    return d, bound, cfg, contribs


@pytest.fixture(scope="module")
def fractions(setup):
    d, bound, cfg, contribs = setup
    return compute_fractions(contribs, d, bound, cfg)


def test_fraction_identities(setup, fractions):
    """num = vol/v (pre-normalization), int = vol·v, surf = num·s; num, int
    and surf are normalized to unit total; vol is absolute."""
    d, bound, cfg, contribs = setup
    fr = fractions
    for ri in range(3):
        r = contribs[ri, :, 0]
        v = PI43 * r ** 3 * (1e14) ** 2     # absVolume = v·sld²
        s = 4 * math.pi * r ** 2
        vol = fr.fraction["vol"][:, ri]
        num_unnorm = vol / v
        np.testing.assert_allclose(fr.fraction["num"][:, ri],
                                   num_unnorm / num_unnorm.sum(),
                                   rtol=1e-10)
        int_unnorm = vol * v
        np.testing.assert_allclose(fr.fraction["int"][:, ri],
                                   int_unnorm / int_unnorm.sum(),
                                   rtol=1e-10)
        surf_unnorm = num_unnorm * s
        np.testing.assert_allclose(fr.fraction["surf"][:, ri],
                                   surf_unnorm / surf_unnorm.sum(),
                                   rtol=1e-10)
        assert fr.total["vol"][ri] == pytest.approx(vol.sum())
        # normalized weightings sum to 1
        for w in ("num", "int", "surf"):
            assert fr.fraction[w][:, ri].sum() == pytest.approx(1.0)


def test_volume_fraction_scaling_invariance(setup, fractions):
    """vf = w·A/v must be invariant under intensity renormalization: check
    against a direct f64 computation through the model."""
    d, bound, cfg, contribs = setup
    import jax, jax.numpy as jnp
    from mcsas_tpu.core.fitcore import make_constants, solve_scale_bg
    consts = make_constants(d.f, d.fu, jnp.float64)
    ri = 0
    r = contribs[ri, :, 0]
    p_fixed = dict(bound.fixed)
    ft = np.zeros(d.count)
    for rv in r:
        pd = dict(p_fixed, radius=rv)
        ff = np.asarray(jax.jit(
            lambda qq: bound.model.ff(qq, pd))(d.q))
        ft += ff ** 2 * (PI43 * rv ** 3) ** (2 * cfg.compensation_exponent)
    sol = solve_scale_bg(jnp.asarray(ft), consts, True, False)
    a = float(sol.scale)
    w = (PI43 * r ** 3) ** (2 * cfg.compensation_exponent)
    v = PI43 * r ** 3 * 1e28
    np.testing.assert_allclose(fractions.fraction["vol"][:, ri],
                               w * a / v, rtol=1e-8)
    np.testing.assert_allclose(fractions.scaling[0, ri], a, rtol=1e-8)


def test_observability_definition(setup, fractions):
    """minReqVol_c = min_q σ·vf_c/(A·I_c) (reference mcsas.py:574-594)."""
    d, bound, cfg, contribs = setup
    import jax
    ri, c = 1, 4
    rv = contribs[ri, c, 0]
    pd = dict(dict(bound.fixed), radius=rv)
    ff = np.asarray(jax.jit(lambda qq: bound.model.ff(qq, pd))(d.q))
    ipart = ff ** 2 * (PI43 * rv ** 3) ** (2 * cfg.compensation_exponent)
    a = fractions.scaling[0, ri]
    vf = fractions.fraction["vol"][c, ri]
    expected = np.min(d.fu * vf / (a * ipart))
    assert fractions.min_req["vol"][c, ri] == pytest.approx(expected,
                                                            rel=1e-8)


def test_histogram_bins_sum(setup, fractions):
    d, bound, cfg, contribs = setup
    spec = HistogramSpec("radius", 5e-9, 20e-9, bin_count=10,
                         auto_follow=False).resolved(bound)
    # auto_follow=False keeps the explicit range
    assert spec.lower == 5e-9 and spec.upper == 20e-9
    h = compute_histogram(spec, contribs, bound, fractions)
    # all contributions inside the range: bins must sum to the total
    for ri in range(3):
        inside = ((contribs[ri, :, 0] >= 5e-9)
                  & (contribs[ri, :, 0] < 20e-9))
        expected = fractions.fraction["vol"][inside, ri].sum()
        assert h.bins.full[:, ri].sum() == pytest.approx(expected,
                                                         rel=1e-10)
    # CDF normalized
    np.testing.assert_allclose(h.cdf.full[-1, :], 1.0)
    assert np.all(np.diff(h.cdf.full, axis=0) >= -1e-12)


def test_histogram_log_scale_edges(setup, fractions):
    d, bound, cfg, contribs = setup
    spec = HistogramSpec("radius", 1e-9, 1e-6, bin_count=20,
                         xscale="log").resolved(bound)
    h = compute_histogram(spec, contribs, bound, fractions)
    ratios = h.x_lower_edge[1:] / h.x_lower_edge[:-1]
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-9)


def test_moments_match_manual(setup, fractions):
    d, bound, cfg, contribs = setup
    spec = HistogramSpec("radius", 1e-9, 1e-6).resolved(bound)
    h = compute_histogram(spec, contribs, bound, fractions)
    # manual: rep-0 weighted moments
    v = contribs[0, :, 0]
    f = fractions.fraction["vol"][:, 0]
    m = (v > spec.lower) & (v < spec.upper)
    v, f = v[m], f[m]
    mu = (v * f).sum() / f.sum()
    var = ((v - mu) ** 2 * f).sum() / f.sum()
    reps_mu = []
    for ri in range(3):
        vv = contribs[ri, :, 0]
        ff_ = fractions.fraction["vol"][:, ri]
        mm = (vv > spec.lower) & (vv < spec.upper)
        reps_mu.append((vv[mm] * ff_[mm]).sum() / ff_[mm].sum())
    assert h.moments.mean[0] == pytest.approx(np.mean(reps_mu), rel=1e-10)
    assert h.moments.mean[1] == pytest.approx(np.std(reps_mu, ddof=1),
                                              rel=1e-10)
    assert h.moments.variance[0] > 0


def test_default_histograms(setup):
    d, bound, cfg, contribs = setup
    specs = default_histograms(bound)
    assert len(specs) == 1
    assert specs[0].param == "radius"
    assert specs[0].lower == pytest.approx(1e-9)
    assert specs[0].yweight == "vol"


def test_histogram_all_pipeline(setup):
    d, bound, cfg, contribs = setup
    fr, hists = histogram_all(contribs, d, bound, cfg)
    assert len(hists) == 1
    assert hists[0].bins.full.shape == (50, 3)
    assert hists[0].bins.mean.shape == (50,)
    assert np.all(np.isfinite(hists[0].observability))


def test_bad_spec_raises(setup):
    d, bound, cfg, contribs = setup
    with pytest.raises(ValueError):
        HistogramSpec("radius", yweight="mass")
    with pytest.raises(ValueError):
        HistogramSpec("radius", xscale="sqrt")
    with pytest.raises(KeyError):
        HistogramSpec("sld").resolved(bound)


def test_accel_post_tier_matches_cpu_f64():
    """The accelerator-assisted post tier (exact rule, normalized f32
    bank, f64 reductions) must match the straight f64 CPU pass within
    mixed-precision tolerance on a smeared quadrature model — the case
    post_compute='auto' selects it for on a GPU."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(
        __file__).resolve().parent))
    from test_tables import NM, _smeared_cyl_data

    from mcsas_tpu.post.histogram import _post_pass_f64
    d = _smeared_cyl_data()
    bound = get_model("CylindersIsotropic").bind(
        active=("radius",),
        active_ranges={"radius": (0.5 * NM, 100 * NM)})
    rng = np.random.default_rng(3)
    contribs = np.exp(rng.uniform(np.log(1e-9), np.log(5e-8),
                                  (2, 30, 1)))
    outs = {}
    for tier in ("cpu", "accel"):
        cfg = McSASConfig(num_contribs=30, num_reps=2,
                          max_iterations=10000, post_compute=tier)
        outs[tier] = _post_pass_f64(bound, d, cfg, contribs)
    names = ("wset", "vset", "sset", "a", "b", "measval", "ag", "minq")
    tol = dict(wset=0.0, vset=0.0, sset=0.0, a=1e-4, b=1e-4,
               measval=2e-3, ag=1e-4, minq=1e-3)
    for name, a, b in zip(names, outs["cpu"], outs["accel"]):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(float(np.abs(a).max()), 1e-300)
        rel = float(np.abs(a - b).max() / scale)
        assert rel <= max(tol[name], 1e-15), (name, rel)
