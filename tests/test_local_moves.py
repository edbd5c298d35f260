# -*- coding: utf-8 -*-
"""Opt-in local-move proposals: candidates stay in range, default-off keeps
reference semantics, and narrow-basin convergence accelerates."""
import numpy as np
import pytest

from mcsas_tpu import data
from mcsas_tpu.config import McSASConfig
from mcsas_tpu.core.engine import McSASEngine
from mcsas_tpu.models import get_model


@pytest.fixture(scope="module")
def sphere_data(refdata):
    return data.load(refdata / "sasfit_sphere-10-1.dat")


def cfg_for(lm, **kw):
    base = dict(num_contribs=40, num_reps=2, max_iterations=4000,
                chunk_steps=500, candidates_per_step=8, seed=11,
                max_retries=0, local_moves=lm, show_incomplete=True)
    base.update(kw)
    return McSASConfig(**base)


def test_validation():
    with pytest.raises(ValueError):
        McSASConfig(local_moves=1.5)
    with pytest.raises(ValueError):
        McSASConfig(local_moves=0.5, candidates_per_step=1)


def test_zero_local_matches_previous_stream(sphere_data):
    """local_moves=0 must draw the exact same global proposal stream."""
    bound = get_model("Sphere").bind()
    r0 = McSASEngine(sphere_data, bound, cfg_for(0.0)).run()
    r1 = McSASEngine(sphere_data, bound, cfg_for(0.0)).run()
    np.testing.assert_array_equal(r0.contribs, r1.contribs)


def test_candidates_stay_in_range(sphere_data):
    bound = get_model("Sphere").bind()
    eng = McSASEngine(sphere_data, bound, cfg_for(0.5))
    res = eng.run()
    lo, hi = bound.ranges[0]
    assert res.contribs.min() >= lo - 1e-15
    assert res.contribs.max() <= hi * (1 + 1e-6)
    assert np.all(res.n_moves > 0)


def test_local_moves_accelerate_narrow_basin(sphere_data):
    """Monodisperse target: same budget, local moves must reach a lower
    chi2 than pure global proposals."""
    bound = get_model("Sphere").bind()
    budget = dict(num_contribs=60, max_iterations=60000, chunk_steps=1500,
                  candidates_per_step=8)
    r_glob = McSASEngine(sphere_data, bound, cfg_for(0.0, **budget)).run()
    r_loc = McSASEngine(sphere_data, bound, cfg_for(0.5, **budget)).run()
    assert r_loc.conval.mean() < r_glob.conval.mean()


def test_local_moves_in_pallas_kernel(sphere_data):
    cfg = cfg_for(0.5, use_pallas="on")
    eng = McSASEngine(sphere_data, get_model("Sphere").bind(), cfg,
                      interpret=True)
    assert eng.uses_pallas
    res = eng.run()
    lo, hi = eng.bound.ranges[0]
    assert res.contribs.min() >= lo - 1e-15
    assert res.contribs.max() <= hi * (1 + 1e-6)
    assert np.all(np.isfinite(res.conval))
