# -*- coding: utf-8 -*-
"""GPU MC chunk kernel (Pallas, Triton route), validated on the CPU: the
kernel runs in the Pallas interpreter (``interpret=True``, passed
explicitly) against the XLA scan path — the same threefry proposal
stream and the same candidate rows, so trajectories agree exactly — and
its Triton lowering is built for CUDA without a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcsas_tpu import data
from mcsas_tpu.config import McSASConfig
from mcsas_tpu.core.engine import McSASEngine
from mcsas_tpu.core.fitcore import solve_scale_bg
from mcsas_tpu.models import get_model
from mcsas_tpu.ops import mc_kernel


@pytest.fixture(scope="module")
def sphere_data(refdata):
    return data.load(refdata / "sasfit_sphere-10-1.dat")


def make_engine(sphere_data, use_pallas, interpret=None, **kw):
    base = dict(num_contribs=40, num_reps=2, max_iterations=2000,
                chunk_steps=250, candidates_per_step=4, seed=11,
                max_retries=0, use_pallas=use_pallas)
    base.update(kw)
    if interpret is None:
        interpret = use_pallas != "off"
    return McSASEngine(sphere_data, get_model("Sphere").bind(),
                       McSASConfig(**base), interpret=interpret)


def _cyl_bound():
    return get_model("CylindersIsotropic").bind(
        active=("radius",), active_ranges={"radius": (1e-10, 5e-8)},
        fixed={"useAspect": 1.0, "aspect": 10.0})


def run_chunks(eng, keys, n):
    state = eng._init_batch(keys)
    ri = jnp.zeros((), jnp.int32)
    for _ in range(n):
        state, ri = eng._chunk_batch(state, ri)
    return state, ri


def assert_same_trajectory(st_k, st_x):
    assert np.array_equal(np.asarray(st_k.rset), np.asarray(st_x.rset))
    assert np.array_equal(np.asarray(st_k.n_moves),
                          np.asarray(st_x.n_moves))
    assert np.array_equal(np.asarray(st_k.n_iter), np.asarray(st_x.n_iter))
    np.testing.assert_allclose(np.asarray(st_k.conval),
                               np.asarray(st_x.conval), rtol=1e-5)


@pytest.fixture(scope="module")
def pallas_state(sphere_data):
    eng = make_engine(sphere_data, "on")
    assert eng.uses_pallas
    state = eng._init_batch(jax.random.split(jax.random.PRNGKey(7), 2))
    ri = jnp.zeros((), jnp.int32)
    states = [state]
    for _ in range(3):
        state, ri = eng._chunk_batch(state, ri)
        states.append(state)
    return eng, states, ri


def test_grid_lane_padded(pallas_state):
    """The fit grid is padded to the next power of two (Triton blocks)
    with zero-weight points."""
    eng, states, _ = pallas_state
    assert eng.data.count == 100 and eng.grid.shape[0] == 128
    assert np.asarray(eng.consts.u)[eng.data.count:].sum() == 0.0


@pytest.mark.parametrize("n, padded", [(1, 1), (2, 2), (3, 4), (100, 128),
                                       (128, 128), (129, 256)])
def test_padded_len(n, padded):
    assert mc_kernel.padded_len(n) == padded


def test_descent_and_moves(pallas_state):
    _, states, _ = pallas_state
    convals = np.array([np.asarray(s.conval) for s in states])
    assert np.all(np.diff(convals, axis=0) <= 1e-4)
    assert convals[-1].max() < convals[0].min()
    assert np.asarray(states[-1].n_moves).min() > 0


def test_cursor_advances(pallas_state):
    eng, states, ri = pallas_state
    assert int(ri) == (3 * 250) % 40


def test_internal_consistency(pallas_state):
    """ibank rows must equal the kernel evaluated at the stored parameters;
    ft must equal the bank total; conval must equal chi2(ft)."""
    eng, states, _ = pallas_state
    s = states[-1]
    for r in range(2):
        rows = jax.vmap(
            lambda p: eng._intensity_row(eng.grid, p))(s.rset[r])
        rows_np = np.asarray(rows)
        bank_np = np.asarray(s.ibank[r])
        # rtol alone traps deep form-factor minima (elements 9+ decades
        # below the row max are pure float32 round-off); give each row an
        # atol floor scaled to its magnitude
        row_max = np.max(np.abs(bank_np), axis=1, keepdims=True)
        tol = 2e-4 * np.abs(bank_np) + 1e-6 * row_max
        err = np.abs(rows_np - bank_np)
        assert np.all(err <= tol), (
            f"rep {r}: max excess {np.max(err - tol):g}")
        ft = jnp.sum(rows, axis=0)
        sol = solve_scale_bg(ft, eng.consts, True, False)
        assert float(sol.chisqr) == pytest.approx(float(s.conval[r]),
                                                  rel=5e-3)


def test_params_within_range(pallas_state):
    eng, states, _ = pallas_state
    rset = np.asarray(states[-1].rset)
    lo, hi = eng.bound.ranges[0]
    assert rset.min() >= lo - 1e-12
    assert rset.max() <= hi * (1 + 1e-6)


def test_full_run_matches_xla_statistically(sphere_data):
    """Same config, kernel vs XLA path: the kernel consumes the scan
    path's own proposal stream, so whole runs (drive, retries) agree
    exactly — contributions, proposal counts and χ²."""
    budget = dict(max_iterations=6000, chunk_steps=250,
                  candidates_per_step=4, num_contribs=40, num_reps=3,
                  show_incomplete=True, max_retries=1)
    r_pal = make_engine(sphere_data, "on", **budget).run()
    r_xla = make_engine(sphere_data, "off", **budget).run()
    assert r_pal.used_pallas and not r_xla.used_pallas
    assert np.array_equal(r_pal.contribs, r_xla.contribs)
    assert np.array_equal(r_pal.n_iter, r_xla.n_iter)
    assert r_pal.total_iters == r_xla.total_iters
    np.testing.assert_allclose(r_pal.conval, r_xla.conval, rtol=1e-5)


def test_auto_mode_off_on_cpu(sphere_data):
    eng = make_engine(sphere_data, "auto", interpret=False)
    # tests pin the default device to CPU → auto must choose the XLA path
    assert not eng.uses_pallas


def test_on_mode_raises_off_gpu(sphere_data):
    """'on' needs a GPU compute device; the interpreter is never chosen
    implicitly."""
    with pytest.raises(ValueError, match="GPU"):
        make_engine(sphere_data, "on", interpret=False)


def test_auto_mode_selects_kernel_on_gpu(sphere_data, refdata,
                                         monkeypatch):
    """'auto' takes the kernel when the compute device is a GPU and the
    model is eligible, and the XLA path for an ineligible one."""
    class _Gpu:
        platform = "gpu"

    monkeypatch.setattr(McSASEngine, "_compute_device",
                        staticmethod(lambda: _Gpu()))
    assert make_engine(sphere_data, "auto", interpret=False).uses_pallas
    # a quadrature model without its table is not eligible
    cyl = McSASEngine(sphere_data, _cyl_bound(),
                      McSASConfig(num_contribs=10, num_reps=1,
                                  table_ff="off"))
    assert not cyl.uses_pallas


def test_compiled_kernel_refuses_cpu(sphere_data):
    """A kernel built without interpret=True is the Triton program: on
    the CPU it fails instead of falling back to the interpreter."""
    eng = make_engine(sphere_data, "on", interpret=True)
    chunk = mc_kernel.build_chunk_fn(eng)
    state = eng._init_batch(jax.random.split(jax.random.PRNGKey(0), 2))
    with pytest.raises(Exception, match="(?i)triton|gpu|cuda|interpret"):
        chunk(state, jnp.zeros((), jnp.int32))


def test_on_mode_rejects_unsupported(refdata):
    d = data.load(refdata / "sasfit_sphere-10-1.dat")
    cfg = McSASConfig(num_contribs=10, num_reps=1, use_pallas="on",
                      table_ff="off")
    with pytest.raises(ValueError, match="eligible"):
        McSASEngine(d, _cyl_bound(), cfg, interpret=True)


def test_logdec_generator_in_kernel(refdata):
    """GaussianChain's logdec1 proposals ride the kernel's stream."""
    d = data.load(refdata / "sasfit_gauss2-5-1.5-2-1.dat")
    cfg = McSASConfig(num_contribs=20, num_reps=1, max_iterations=500,
                      chunk_steps=250, candidates_per_step=2, seed=0,
                      max_retries=0, use_pallas="on", show_incomplete=True)
    eng = McSASEngine(d, get_model("GaussianChain").bind(), cfg,
                      interpret=True)
    assert eng.uses_pallas
    res = eng.run()
    assert np.all(np.isfinite(res.conval))
    lo, hi = eng.bound.ranges[0]
    assert res.contribs.min() >= lo - 1e-15
    assert res.contribs.max() <= hi * (1 + 1e-6)


@pytest.mark.parametrize("kw", [
    dict(num_reps=1),                      # one program
    dict(candidates_per_step=1),           # reference stepping, K = 1
    dict(candidates_per_step=3),           # K padded to 4, masked
    dict(find_background=False),
    dict(positive_background=True),
], ids=["one-rep", "k1", "k3-padded", "no-bg", "pos-bg"])
def test_kernel_matches_scan_exactly(sphere_data, kw):
    """Shapes and solve variants: after equal step budgets the kernel
    and the scan path agree exactly."""
    ek = make_engine(sphere_data, "on", chunk_steps=40, **kw)
    ex = make_engine(sphere_data, "off", chunk_steps=40, **kw)
    keys = jax.random.split(jax.random.PRNGKey(4), ek.cfg.num_reps)
    st_k, ri_k = run_chunks(ek, keys, 2)
    st_x, ri_x = run_chunks(ex, keys, 2)
    assert int(ri_k) == int(ri_x)
    assert_same_trajectory(st_k, st_x)
    assert np.asarray(st_k.n_moves).min() > 0


def test_seg_steps(sphere_data, monkeypatch):
    """A launch covers chunk_steps, at most num_contribs steps with local
    moves (distinct slots), and at most the row-stream budget."""
    assert mc_kernel.seg_steps(make_engine(sphere_data, "on")) == 250
    assert mc_kernel.seg_steps(make_engine(
        sphere_data, "on", local_moves=0.5)) == 40
    # per step: 2 reps x 4 candidates x 128 points x 4 bytes = 4 KiB
    monkeypatch.setattr(mc_kernel, "_ROWS_BUDGET", 100 * 4096)
    assert mc_kernel.seg_steps(make_engine(sphere_data, "on")) == 100


def _cyl_engine(sphere_data, use_pallas, **kw):
    base = dict(num_reps=4, num_contribs=50, convergence_criterion=2.0,
                max_iterations=200000, chunk_steps=64,
                candidates_per_step=8, seed=7, max_retries=0,
                use_pallas=use_pallas)
    base.update(kw)
    return McSASEngine(sphere_data, _cyl_bound(), McSASConfig(**base),
                       interpret=use_pallas != "off")


def test_prefetch_matches_scan_exactly(sphere_data, monkeypatch):
    """Table tier: the kernel consumes the SAME threefry proposal stream
    and the SAME intensity_row evaluations as the XLA scan path — after
    equal step budgets the ensembles agree bitwise (the only difference,
    solve reduction association, changes no accept decision here)."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    ep = _cyl_engine(sphere_data, "on")
    ex = _cyl_engine(sphere_data, "off")
    assert ep.uses_pallas and ep.uses_table
    assert not ex.uses_pallas
    assert mc_kernel.seg_steps(ep) == 64  # = chunk_steps here
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    st_p, ri_p = run_chunks(ep, keys, 2)
    st_x, ri_x = run_chunks(ex, keys, 2)
    assert int(ri_p) == int(ri_x)
    assert_same_trajectory(st_p, st_x)
    nq = ex.consts.y.shape[0]
    np.testing.assert_allclose(np.asarray(st_p.ft)[:, :nq],
                               np.asarray(st_x.ft), rtol=2e-4)
    # pad lanes stay zero in the bank
    assert np.asarray(st_p.ibank)[:, :, nq:].sum() == 0.0


def test_prefetch_smeared_table(refdata, monkeypatch):
    """Smeared-intensity tables ride the kernel unchanged: rows are baked
    against the dataset's own contraction, so the kernel needs no
    smearing math.  Exact agreement with the scan path."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    from mcsas_tpu.data import DataConfig, TrapezoidSmearing
    dc = DataConfig(smearing=TrapezoidSmearing(
        do_smear=True, n_steps=9, umbra=0.05e9, penumbra=0.2e9))
    d = data.load(refdata / "sasfit_sphere-10-1.dat", config=dc)
    bound = _cyl_bound()
    cfg = dict(num_reps=2, num_contribs=30, convergence_criterion=2.0,
               max_iterations=200000, chunk_steps=32,
               candidates_per_step=4, seed=3, max_retries=0)
    ep = McSASEngine(d, bound, McSASConfig(use_pallas="on", **cfg),
                     interpret=True)
    ex = McSASEngine(d, bound, McSASConfig(use_pallas="off", **cfg))
    assert ep.uses_pallas and ep.uses_table
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    st_p, ri_p = run_chunks(ep, keys, 1)
    st_x, ri_x = run_chunks(ex, keys, 1)
    assert int(ri_p) == int(ri_x)
    assert_same_trajectory(st_p, st_x)


def test_prefetch_local_moves_match_scan(sphere_data, monkeypatch):
    """Local moves ride the kernel: a segment visits strictly distinct
    slots (seg <= num_contribs), so every local proposal is computable
    from the segment-start rset — the stream stays bitwise-identical to
    the XLA scan path chunked at the same length."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "64")
    # chunk_steps=64 > num_contribs=50: the segment cap must bind
    ep = _cyl_engine(sphere_data, "on", local_moves=0.5)
    assert ep.uses_pallas and ep.uses_table
    assert mc_kernel.seg_steps(ep) == 50  # = num_contribs
    ex50 = _cyl_engine(sphere_data, "off", local_moves=0.5,
                       chunk_steps=50)
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    st_p, ri_p = run_chunks(ep, keys, 3)
    st_x, ri_x = run_chunks(ex50, keys, 3)
    assert int(ri_p) == int(ri_x)
    assert_same_trajectory(st_p, st_x)
    assert np.asarray(st_p.n_moves).min() > 0


def test_prefetch_eligibility_gates(sphere_data, refdata, monkeypatch):
    """Elementwise models and table-tier models are eligible; smeared
    elementwise models (no table) and Kholodenko's smeared table, whose
    rows live on the flattened locs grid, are not."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "32")
    from mcsas_tpu.data import DataConfig, TrapezoidSmearing
    es = make_engine(sphere_data, "on", num_reps=2)
    assert es.uses_pallas and not es.uses_table
    dc = DataConfig(smearing=TrapezoidSmearing(
        do_smear=True, n_steps=5, umbra=0.05e9, penumbra=0.2e9))
    ds = data.load(refdata / "sasfit_sphere-10-1.dat", config=dc)
    cfg = McSASConfig(num_contribs=10, num_reps=1, table_ff="on")
    sm = McSASEngine(ds, get_model("Sphere").bind(), cfg, interpret=True)
    assert not sm.uses_pallas
    dk = data.load(refdata / "sasfit_kho-1-10-1000.dat", config=dc)
    kh = McSASEngine(dk, get_model("Kholodenko").bind(), cfg,
                     interpret=True)
    assert kh.uses_table and not kh.uses_pallas


def test_prefetch_kholodenko_partial_table(refdata, monkeypatch):
    """Kholodenko's PARTIAL table (backbone tabulated, exact q-axis
    cross-section applied in the lookup) rides the kernel with local
    moves: stream stays bitwise-identical to the scan path at
    seg-aligned chunking."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "32")
    d = data.load(refdata / "sasfit_kho-1-10-1000.dat")
    bound = get_model("Kholodenko").bind()

    def eng(mode, chunk):
        return McSASEngine(d, bound, McSASConfig(
            num_reps=2, num_contribs=40, convergence_criterion=2.0,
            max_iterations=100000, chunk_steps=chunk,
            candidates_per_step=4, seed=5, max_retries=0,
            local_moves=0.5, use_pallas=mode, table_ff="on"),
            interpret=mode != "off")

    ep = eng("on", 64)
    assert ep.uses_pallas and ep.uses_table
    seg = mc_kernel.seg_steps(ep)
    assert seg == 40  # local moves cap the segment at num_contribs
    ex = eng("off", seg)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    st_p, ri_p = run_chunks(ep, keys, 3)
    st_x, ri_x = run_chunks(ex, keys, 3)
    assert int(ri_p) == int(ri_x)
    assert_same_trajectory(st_p, st_x)
    assert np.asarray(st_p.n_moves).min() > 0


@pytest.mark.parametrize("family", ["sphere", "gaussian-chain",
                                    "cylinders-isotropic"])
def test_kernel_lowers_for_cuda(family, monkeypatch):
    """The Triton program itself (not the interpreter) lowers for CUDA at
    the production widths (K=128, 300 contributions, 10 repetitions):
    block shapes, dtypes and primitives are all accepted by the Pallas
    Triton lowering.  Only compiling it needs the card."""
    import sys
    import pathlib
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "32")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "tools"))
    import drive_audit as da
    entry = {e[0]: e for e in da.CONFIGS}[family]
    d, bound, cfg = da.build_config(entry)
    eng = McSASEngine(d, bound, cfg.replace(use_pallas="on"),
                      interpret=True)
    chunk = mc_kernel.build_chunk_fn(eng)
    keys = jax.random.split(jax.random.PRNGKey(0), cfg.num_reps)
    state = jax.eval_shape(eng._init_batch, keys)
    text = chunk.trace(state, jnp.zeros((), jnp.int32)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "mcsas_chunk" in text
