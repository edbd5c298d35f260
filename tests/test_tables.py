# -*- coding: utf-8 -*-
"""Scale-invariant form-factor tables (ops/tables.py): interpolation
primitives, per-model fit-grade accuracy vs the converged quadrature, and
engine integration."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcsas_tpu import data
from mcsas_tpu.config import McSASConfig
from mcsas_tpu.core.engine import McSASEngine
from mcsas_tpu.models import get_model
from mcsas_tpu.ops import tables

NM = 1e-9
Q = np.geomspace(1.05e6, 9.64e9, 100)   # the sasfit_sphere SI q grid


def test_param_table_lookup_exact_for_loglinear():
    """Multilinear row blending in log coords reproduces functions linear
    in (ln a, ln b) exactly (up to f32 round-off)."""
    a_grid = tables.log_grid(1e-3, 1e3, 64)
    b_grid = tables.log_grid(1e-2, 1e2, 32)
    qdim = 4
    f = lambda a, b: 2.0 + 0.5 * np.log(a) - 0.25 * np.log(b)  # noqa: E731
    tab = tables.build_param_table(
        lambda v: jnp.full((qdim,),
                           2.0 + 0.5 * jnp.log(v[0])
                           - 0.25 * jnp.log(v[1])),
        [a_grid, b_grid])
    rng = np.random.default_rng(1)
    a = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), 200))
    b = np.exp(rng.uniform(np.log(1e-2), np.log(1e2), 200))
    got = np.asarray(jax.vmap(
        lambda ai, bi: tables.lookup_param_table(tab, [ai, bi]))(
            jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))
    np.testing.assert_allclose(got[:, 0], f(a, b), rtol=0, atol=2e-5)


def test_param_table_lookup_clamps_at_domain_edges():
    grid = tables.log_grid(1.0, 10.0, 16)
    tab = tables.build_param_table(
        lambda v: jnp.full((2,), jnp.log(v[0])), [grid])
    inside = float(tables.lookup_param_table(tab, [10.0])[0])
    outside = float(tables.lookup_param_table(tab, [1e6])[0])
    below = float(tables.lookup_param_table(tab, [1e-6])[0])
    assert outside == pytest.approx(inside, rel=1e-5)
    assert below == pytest.approx(0.0, abs=1e-5)


def test_param_table_cache_respects_fixed_params():
    """Two engines differing only in a fixed parameter must not share a
    baked table (code-review r2 finding)."""
    m = get_model("EllipsoidsIsotropic")
    rows = []
    for aspect in (3.0, 5.0):
        bound = m.bind(active=("a",),
                       active_ranges={"a": (1 * NM, 100 * NM)},
                       fixed={"aspect": aspect})
        tab_fn, tab_values = m.ff_table_factory(bound, Q, jnp.float32)
        rows.append(np.asarray(jax.jit(
            lambda q: tab_fn(q, tab_values, bound.pdict(
                jnp.asarray([10 * NM], jnp.float32))))(
                    jnp.asarray(Q, jnp.float32))))
    assert not np.allclose(rows[0], rows[1])


def _rel_err_vs(exact_sq, approx_sq):
    floor = 1e-6 * exact_sq.max(axis=-1, keepdims=True)
    return (np.abs(approx_sq - exact_sq)
            / (np.abs(exact_sq) + floor)).ravel()


def _table_errs(model_name, active, ranges, exact_fn, n_trial=100,
                q_grid=None):
    q_grid = Q if q_grid is None else q_grid
    m = get_model(model_name)
    bound = m.bind(active=active, active_ranges=ranges)
    table_ret = m.ff_table_factory(bound, q_grid, jnp.float32)
    assert table_ret is not None
    tab_fn, tab_values = table_ret
    rng = np.random.default_rng(7)
    vals = np.stack([[np.exp(rng.uniform(np.log(max(lo, 1e-12)),
                                         np.log(hi)))
                      for lo, hi in bound.ranges] for _ in range(n_trial)])
    q64 = jnp.asarray(q_grid)
    q32 = jnp.asarray(q_grid, jnp.float32)
    exact = np.asarray(jax.jit(jax.vmap(
        lambda v: exact_fn(q64, bound.pdict(v))))(jnp.asarray(vals)))
    approx = np.asarray(jax.jit(jax.vmap(
        lambda v: tab_fn(q32, tab_values, bound.pdict(v))))(
            jnp.asarray(vals, jnp.float32)))
    return _rel_err_vs(exact.astype(np.float64) ** 2,
                       approx.astype(np.float64) ** 2)


def test_cylinder_table_accuracy():
    """Table vs the converged (n=801) orientation integral: the model's
    own intDiv=100 trapezoid carries up to ~20% discretization noise at
    qR in [10, 100], so the converged rule is the accuracy reference."""
    from mcsas_tpu.models.cylinders import _cyl_iso_ff_ab

    def exact(q, p):
        half = jnp.where(p["useAspect"] != 0.0,
                         p["radius"] * p["aspect"], 0.5 * p["length"])
        return _cyl_iso_ff_ab(q * p["radius"], q * 2.0 * half, 801,
                              jnp.float64)

    errs = _table_errs("CylindersIsotropic", ("radius",),
                       {"radius": (0.5 * NM, 300 * NM)}, exact)
    assert np.median(errs) < 1e-3
    assert np.percentile(errs, 90) < 5e-2
    assert np.percentile(errs, 99) < 2e-1


def test_ellipsoid_table_accuracy():
    from mcsas_tpu.models.ellipsoids import _ell_iso_ff_uv, _ell_iso_rc

    def exact(q, p):
        return _ell_iso_ff_uv(q * p["a"], q * _ell_iso_rc(p), 801,
                              jnp.float64)

    errs = _table_errs("EllipsoidsIsotropic", ("a",),
                       {"a": (0.5 * NM, 300 * NM)}, exact)
    assert np.median(errs) < 1e-3
    assert np.percentile(errs, 90) < 1e-2
    assert np.percentile(errs, 99) < 1e-1


def test_kholodenko_table_accuracy():
    m = get_model("Kholodenko")
    errs = _table_errs("Kholodenko",
                       ("radius", "lenKuhn", "lenContour"), None, m.ff)
    assert np.median(errs) < 1e-3
    assert np.percentile(errs, 90) < 1e-2
    assert np.percentile(errs, 99) < 2e-1


def test_table_disk_cache_roundtrip(tmp_path, monkeypatch):
    """Persistent table cache (MCSAS_TPU_TABLE_CACHE_DIR): a rebuilt
    process loads the baked table from disk instead of re-evaluating;
    corrupt entries fall back to a rebuild."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_CACHE_DIR", str(tmp_path))
    calls = []

    def row_fn(v):
        calls.append(1)
        return jnp.full((3,), jnp.log(v[0]))

    grid = tables.log_grid(1.0, 10.0, 8)
    key = ("disk-cache-test",)
    t1 = tables.build_param_table(row_fn, [grid], cache_key=key)
    n_built = len(calls)
    assert n_built > 0
    files = list(tmp_path.glob("table-*.npz"))
    assert len(files) == 1
    tables._TABLE_CACHE.clear()           # simulate a fresh process
    t2 = tables.build_param_table(row_fn, [grid], cache_key=key)
    assert len(calls) == n_built          # loaded from disk, not rebuilt
    np.testing.assert_array_equal(np.asarray(t1.values),
                                  np.asarray(t2.values))
    assert t1.axes == t2.axes
    # corrupt entry: rebuild silently
    files[0].write_bytes(b"not an npz")
    tables._TABLE_CACHE.clear()
    t3 = tables.build_param_table(row_fn, [grid], cache_key=key)
    assert len(calls) > n_built
    np.testing.assert_array_equal(np.asarray(t1.values),
                                  np.asarray(t3.values))


def test_table_auto_gating():
    tiny = McSASConfig(num_reps=2, max_iterations=1000)
    big = McSASConfig(num_reps=10, max_iterations=100000)
    assert not tiny.table_ff_enabled()
    assert big.table_ff_enabled()
    assert tiny.replace(table_ff="on").table_ff_enabled()
    assert not big.replace(table_ff="off").table_ff_enabled()


@pytest.fixture(scope="module")
def sphere_data(refdata):
    return data.load(refdata / "sasfit_sphere-10-1.dat")


def test_engine_with_table_descends(sphere_data):
    """CylindersIsotropic on the table path: χ² descends, counters move,
    single-launch drive is active."""
    cfg = McSASConfig(num_contribs=25, num_reps=2, max_iterations=2000,
                      chunk_steps=250, candidates_per_step=4, seed=3,
                      max_retries=0, show_incomplete=True, table_ff="on")
    bound = get_model("CylindersIsotropic").bind(
        active=("radius",), active_ranges={"radius": (0.5 * NM, 300 * NM)})
    eng = McSASEngine(sphere_data, bound, cfg)
    assert eng.uses_table
    # table bodies ride the BOUNDED single-launch drive (a while_loop of
    # at most 32 chunks per launch)
    assert eng._drive is not None
    state = eng._init_batch(jax.random.split(jax.random.PRNGKey(0), 2))
    chi0 = np.asarray(state.conval)
    res = eng.run()
    assert np.all(np.isfinite(res.conval))
    assert np.all(res.conval <= chi0 + 1e-6)
    assert res.n_moves.min() > 0


def test_table_and_exact_paths_statistically_match(sphere_data):
    """Same seed/budget, table on vs off: the threefry proposal stream is
    identical, so only fit-grade kernel differences can flip accepts —
    the fitted radius distributions must agree closely."""
    base = dict(num_contribs=30, num_reps=2, max_iterations=4000,
                chunk_steps=500, candidates_per_step=4, seed=23,
                max_retries=0, show_incomplete=True)
    bound = get_model("CylindersIsotropic").bind(
        active=("radius",), active_ranges={"radius": (0.5 * NM, 300 * NM)})
    res = {}
    for mode in ("on", "off"):
        eng = McSASEngine(sphere_data, bound,
                          McSASConfig(table_ff=mode, **base))
        assert eng.uses_table == (mode == "on")
        res[mode] = eng.run()
    chi_on = res["on"].conval
    chi_off = res["off"].conval
    assert np.all(np.isfinite(chi_on)) and np.all(np.isfinite(chi_off))
    np.testing.assert_allclose(chi_on, chi_off, rtol=0.3)
    lr_on = np.log(res["on"].contribs).mean()
    lr_off = np.log(res["off"].contribs).mean()
    assert abs(lr_on - lr_off) < 0.5


def _smeared_cyl_data(n_steps=13):
    """Slit-smeared synthetic cylinder golden: the converged-rule model
    intensity pushed through the dataset's own trapezoid contraction."""
    from mcsas_tpu.data import DataConfig, TrapezoidSmearing, from_raw
    from mcsas_tpu.models.cylinders import _cyl_iso_ff_ab
    q_nm = np.geomspace(0.01, 2.0, 80)
    sm = TrapezoidSmearing(do_smear=True, n_steps=n_steps, umbra=0.05e9,
                           penumbra=0.2e9)
    dcfg = DataConfig(n_bin=0, smearing=sm)
    ones = np.ones_like(q_nm)
    d0 = from_raw(np.column_stack([q_nm, ones, 0.01 * ones]), config=dcfg)
    assert d0.uses_smearing
    r, asp = 10e-9, 10.0
    ff = jax.jit(lambda q: _cyl_iso_ff_ab(
        q * r, q * (2.0 * r * asp), 801, jnp.float64))(
            jnp.asarray(np.asarray(d0.locs, np.float64)))
    i = np.asarray((ff * ff) @ jnp.asarray(
        np.asarray(d0.smear_w, np.float64)))
    i = i / i.max()
    return from_raw(np.column_stack([q_nm, i, 0.01 * i]),
                    title="synthetic-cylinder-smeared", config=dcfg)


def test_smeared_table_engine_fits(monkeypatch):
    """Smeared param-table tier: rows are baked against the dataset's own
    smearing contraction (lifting the round-2 `not smearing` gate), the
    engine takes the bounded single-launch drive, and the fit descends to
    the golden data's χ² floor."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "768")
    d = _smeared_cyl_data()
    bound = get_model("CylindersIsotropic").bind(
        active=("radius",),
        active_ranges={"radius": (0.5 * NM, 100 * NM)})
    cfg = McSASConfig(num_contribs=40, num_reps=2, max_iterations=30000,
                      chunk_steps=512, candidates_per_step=8, seed=11,
                      max_retries=0, show_incomplete=True, table_ff="on")
    eng = McSASEngine(d, bound, cfg)
    assert eng.uses_table and not eng.uses_pallas
    assert eng._drive is not None       # bounded single-launch drive

    # fit-grade accuracy: the engine's table row vs the direct smeared
    # converged quadrature, shape-compared over the radius range
    locs = jnp.asarray(np.asarray(d.locs, np.float64))
    sw = jnp.asarray(np.asarray(d.smear_w, np.float64))
    errs = []
    for r_nm in (2.0, 5.0, 9.7, 31.0):
        pv = jnp.asarray([r_nm * NM])
        row = np.asarray(eng._intensity_row(eng.grid, pv), np.float64)
        p = dict(bound.fixed)
        p["radius"] = r_nm * NM
        ffv = bound.model.ff(locs, p)
        direct = np.asarray((ffv * ffv) @ sw, np.float64)
        # engine rows carry the w/i_ref normalization: compare shapes
        # via the intensity-weighted relative deviation
        scale = (row * direct).sum() / (direct * direct).sum()
        num = np.abs(row - scale * direct) * direct
        errs.append(float(num.sum() / (scale * (direct * direct).sum())))
    assert np.median(errs) < 2e-2
    assert max(errs) < 2e-1

    res = eng.run()
    assert np.all(np.isfinite(res.conval))
    assert res.n_moves.min() > 0
    # the capped 768-node table sets a χ²≈9.5 interpolation floor on this
    # golden (measured); at production res the same fit reaches χ²≤1
    # (res=3072: conval 0.85/0.99 — the bench.py cylinders-smeared row
    # certifies the uncapped tier on hardware)
    assert res.conval.max() < 20.0


def test_engine_table_off_matches_legacy_path(sphere_data):
    cfg = McSASConfig(num_contribs=10, num_reps=1, max_iterations=200,
                      chunk_steps=100, candidates_per_step=2, seed=3,
                      max_retries=0, show_incomplete=True, table_ff="off")
    bound = get_model("CylindersIsotropic").bind(
        active=("radius",), active_ranges={"radius": (0.5 * NM, 300 * NM)})
    eng = McSASEngine(sphere_data, bound, cfg)
    assert not eng.uses_table
    res = eng.run()
    assert np.all(np.isfinite(res.conval))


def test_probe_engages_smooth_declines_oscillatory(monkeypatch):
    """probe_interp_errors separates interpolable from aliasing row
    functions at production spacing: smooth-in-log rows engage, rows
    oscillating faster than the node spacing decline."""
    # the env bypass (MCSAS_TPU_TABLE_PROBE=off) would short-circuit the
    # decline assertion below
    monkeypatch.delenv("MCSAS_TPU_TABLE_PROBE", raising=False)
    grid = tables.log_grid(1.0, 100.0, 64)
    smooth = tables.probe_interp_errors(
        lambda v: jnp.exp(-jnp.log(v[0]) ** 2 / 8.0) * jnp.ones((4,)),
        [grid])
    assert tables.probe_is_fit_grade(smooth)
    osc = tables.probe_interp_errors(
        lambda v: jnp.sin(300.0 * jnp.log(v[0])) * jnp.ones((4,)),
        [grid])
    assert not tables.probe_is_fit_grade(osc)


@pytest.mark.parametrize("name,active,ranges", [
    ("CylindersIsotropicAspect", ("radius", "aspect"),
     {"radius": (0.5 * NM, 300 * NM), "aspect": (1.0, 20.0)}),
    ("CylindersRadiallyIsotropic", ("radius", "psiAngle"),
     {"radius": (0.5 * NM, 300 * NM)}),
])
def test_psi_grid_table_declines_wide_ranges(name, active, ranges,
                                             monkeypatch):
    """Over the legacy models' full default ranges the wedge / in-plane
    ψ rules oscillate along the parameter axes with phase ~q·L — no
    resolution interpolates fit-grade (measured: radius 512→1024 left
    p90 error at 0.73), so the bake-time probe must DECLINE the table
    (engine falls back to exact in-loop quadrature).  The decline
    happens before the bake, so this is cheap."""
    monkeypatch.delenv("MCSAS_TPU_TABLE_RES_CAP", raising=False)
    monkeypatch.delenv("MCSAS_TPU_TABLE_PROBE", raising=False)
    m = get_model(name)
    bound = m.bind(active=active, active_ranges=ranges)
    assert m.ff_table_factory(bound, Q, jnp.float32) is None
    # the engine then runs the exact quadrature path
    d = data.from_raw(np.column_stack([Q / 1e9,       # SI → nm⁻¹
                                       np.ones_like(Q),
                                       0.05 * np.ones_like(Q)]),
                      title="probe-decline")
    cfg = McSASConfig(num_contribs=8, num_reps=1, max_iterations=64,
                      chunk_steps=32, candidates_per_step=2, seed=5,
                      max_retries=0, show_incomplete=True)
    eng = McSASEngine(d, bound, cfg)
    assert not eng.uses_table
    assert np.all(np.isfinite(eng.run().conval))


@pytest.mark.skipif(
    __import__("os").environ.get("MCSAS_TPU_SLOW_TESTS", "") != "1",
    reason="set MCSAS_TPU_SLOW_TESTS=1: bakes the full 512x64 ψ tables")
@pytest.mark.parametrize("name,active,ranges,qmax", [
    ("CylindersIsotropicAspect", ("radius", "aspect"),
     {"radius": (1 * NM, 20 * NM), "aspect": (1.0, 4.0)}, 1e9),
    ("CylindersRadiallyIsotropic", ("radius", "psiAngle"),
     {"radius": (1 * NM, 30 * NM)}, 1e9),
])
def test_psi_grid_table_accuracy_narrow(name, active, ranges, qmax,
                                        monkeypatch):
    """On narrow (realistic single-population) workloads the probe
    ENGAGES the ψ-grid tables, and engaged tables meet the fit-grade
    contract on random points: the probe's 2x margin is the guarantee
    being certified here.  Rows bake with a CONVERGED ψ rule (the
    verbatim 303-point grids are quadrature noise at high qR —
    CylindersIsotropic n=801 precedent).  No p99 assert: the legacy
    rules keep a fat aliased tail even where median/p90 are fit-grade
    (the probe contract covers median and p90 only).  Slow: bakes the
    full 512x64 grid."""
    monkeypatch.delenv("MCSAS_TPU_TABLE_RES_CAP", raising=False)
    monkeypatch.delenv("MCSAS_TPU_TABLE_PROBE", raising=False)
    m = get_model(name)
    q_narrow = np.geomspace(1e7, qmax, 100)

    def exact(q, p):
        return m.ff(q, dict(p, psiAngleDivisions=3001.0))

    errs = _table_errs(name, active, ranges, exact, n_trial=25,
                       q_grid=q_narrow)
    assert np.median(errs) < 1e-3
    assert np.percentile(errs, 90) < 5e-2


def test_probe_outcome_isolated_in_cache_keys(tmp_path, monkeypatch):
    """A table baked with the probe BYPASSED must never be served to a
    probe-gated caller, and a memoized decline must not mask a later
    bypassed bake (round 4: the cache key carries the effective probe
    mode, memory AND disk)."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("MCSAS_TPU_TABLE_PROBE", raising=False)
    grid = tables.log_grid(1.0, 100.0, 64)
    osc = lambda v: jnp.sin(300.0 * jnp.log(v[0])) * jnp.ones((4,))  # noqa

    key = ("probe-isolation-test",)
    # probe-gated: declines (and memoizes the decline)
    assert tables.build_param_table(osc, [grid], cache_key=key,
                                    probe=True) is None
    # bypassed: bakes and persists — the decline memo must not mask it
    monkeypatch.setenv("MCSAS_TPU_TABLE_PROBE", "off")
    t_off = tables.build_param_table(osc, [grid], cache_key=key,
                                     probe=True)
    assert t_off is not None
    # probe-gated again: must STILL decline (not served the off-bake),
    # both from the in-process memo and from a cleared memo hitting disk
    monkeypatch.delenv("MCSAS_TPU_TABLE_PROBE", raising=False)
    assert tables.build_param_table(osc, [grid], cache_key=key,
                                    probe=True) is None
    tables._TABLE_CACHE.clear()
    assert tables.build_param_table(osc, [grid], cache_key=key,
                                    probe=True) is None
