#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Drive-vs-host-loop trajectory audit across every bench family.

The single-launch while_loop drive (core/engine.py ``_build_drive``) and
the host chunk loop launch the SAME chunk function; only the launch
schedule differs.  This audit runs a config both ways at identical seeds
and compares the per-repetition proposal counters: any drive-only
inflation or divergence is a state-corruption signature.  The
trajectory is deterministic given the seed (threefry proposals), so the
counters must match EXACTLY.

``--sharded`` adds the sharded-tier rows: a ShardedEnsemble on a
1-device mesh must reproduce the unsharded drive's counters bitwise at
the same seed.

Run on the card, one process at a time.  One JSON line per config.
chip_smoke.py imports ``audit``, ``build_config``, ``CONFIGS`` and
``assert_contribs_close``.
"""
import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("MCSAS_TPU_TABLE_CACHE_DIR",
                      os.path.join(_REPO, ".table_cache"))

_NM = 1e-9
# (name, dataset, model, active, ranges, K, local_moves) — the bench
# --suite families at the production workload shape
CONFIGS = [
    ("sphere", "testdata/sasfit_sphere-10-1.dat", "Sphere", None, None,
     128, 0.5),
    ("gaussian-chain", "testdata/sasfit_gauss2-5-1.5-2-1.dat",
     "GaussianChain", None, None, 64, 0.0),
    ("kholodenko-worm", "testdata/sasfit_kho-1-10-1000.dat",
     "Kholodenko", None, None, 128, 0.75),
    ("cylinders-isotropic", "synth:cylinder", "CylindersIsotropic",
     ("radius",), {"radius": (0.5 * _NM, 300 * _NM)}, 128, 0.0),
    ("cylinders-smeared", "synth:cylinder-smeared",
     "CylindersIsotropic", ("radius",),
     {"radius": (0.5 * _NM, 300 * _NM)}, 128, 0.0),
    ("ellipsoids-isotropic", "synth:ellipsoid", "EllipsoidsIsotropic",
     ("a",), {"a": (0.5 * _NM, 300 * _NM)}, 128, 0.0),
    ("core-shell-sphere",
     "testdata/models/SphCoreShell_R100_dR150_c3p16_s2p53.csv",
     "SphericalCoreShell", ("radius", "t"), None, 128, 0.5),
    ("core-shell-ellipsoid", "synth:ellcoreshell",
     "EllipsoidalCoreShell", ("a", "t"),
     {"a": (2 * _NM, 50 * _NM), "t": (10 * _NM, 200 * _NM)}, 128, 0.5),
    # explicit radius range: this audit drives McSASEngine directly,
    # which (unlike fit()) does not default unbounded ranges to the
    # data size estimate
    ("lma-dense-sphere", "testdata/sasfit_sphere-10-1.dat",
     "LMADenseSphere", ("radius", "volFrac"),
     {"radius": (0.5 * _NM, 300 * _NM), "volFrac": (1e-4, 0.1)},
     128, 0.5),
]


def build_config(entry):
    """(data, bound, cfg) for one CONFIGS row."""
    import mcsas_tpu as mt
    from bench import synth_golden
    from mcsas_tpu.config import McSASConfig
    from mcsas_tpu.models import get_model

    name, path, model, active, ranges, k_cand, local = entry
    if path.startswith("synth:"):
        data = synth_golden(path.split(":", 1)[1])
    else:
        data = mt.load(os.path.join(_REPO, path))
    fixed = {"ellipsoids-isotropic": {"aspect": 3.0},
             "core-shell-ellipsoid": {"b": 15 * _NM}}.get(name)
    bound = get_model(model).bind(active=active, active_ranges=ranges,
                                  fixed=fixed)
    cfg = McSASConfig(num_contribs=300, num_reps=10,
                      max_iterations=24_000_000, chunk_steps=1024,
                      candidates_per_step=k_cand, seed=2026,
                      max_retries=0, local_moves=local,
                      show_incomplete=True)
    return data, bound, cfg


def assert_contribs_close(res, base, label):
    """Exact contribution equality with the documented borderline-tie
    fallback (a chisqr comparison landing exactly on an f32 rounding
    boundary can flip one accept and cascade within one repetition —
    the run is then not wrong): at most one repetition may diverge, and
    the χ² of the two ensembles then agrees to 2%.

    Identical trajectories must also have consumed IDENTICAL work: the
    per-rep proposal counters (n_iter — chunk count × steps × K) must
    match, so neither run silently ran extra or fewer chunks.  Returns
    the printed verdict."""
    if np.array_equal(res.contribs, base.contribs):
        assert np.array_equal(res.n_iter, base.n_iter), (
            f"{label}: identical trajectories but different proposal "
            f"counts ({res.n_iter} vs {base.n_iter}) — a drive is "
            "running a different chunk schedule")
        return (f"{label}: contributions equal (exact), identical "
                f"proposal counts; max chi2 {float(res.conval.max()):.3f}")
    rep_equal = np.array([np.array_equal(a, b) for a, b in
                          zip(res.contribs, base.contribs)])
    assert rep_equal.sum() >= max(1, len(rep_equal) - 1), (
        f"{label}: contributions diverged in "
        f"{int(len(rep_equal) - rep_equal.sum())} repetitions")
    np.testing.assert_allclose(np.sort(res.conval),
                               np.sort(base.conval), rtol=2e-2)
    return (f"{label}: {int(rep_equal.sum())}/{len(rep_equal)} reps "
            "bitwise equal (one borderline-tie cascade), chi2 agrees "
            "to 2%")


def audit(name, data, bound, cfg):
    """Drive vs host-loop counters for one config; returns the row."""
    import jax
    import jax.numpy as jnp
    from mcsas_tpu.core.engine import McSASEngine

    eng = McSASEngine(data, bound, cfg)
    if eng._drive is None:
        return {"config": name, "skipped": "no drive tier"}

    # drive mode: the production run() path (init fused where safe)
    res = eng.run()

    # host loop: identical init, chunk-by-chunk launches
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.num_reps)
    st = eng._init_batch(keys)
    ri = jnp.zeros((), jnp.int32)
    crit = cfg.convergence_criterion
    for _ in range(200_000):
        conval = np.asarray(st.conval)
        n_iter = np.asarray(st.n_iter)
        if not np.any((conval > crit) & (n_iter < cfg.max_iterations)):
            break
        st, ri = eng._chunk_batch(st, ri)

    drive_iter = res.n_iter.astype(np.int64)
    host_iter = np.asarray(st.n_iter, np.int64)
    # run() may span retries; the audit only certifies single-attempt
    # trajectories (max_retries=0 in the configs below)
    equal = np.array_equal(drive_iter, host_iter)
    ratio = float(drive_iter.sum()) / max(float(host_iter.sum()), 1.0)
    out = {"config": name,
           "kernel": bool(eng.uses_pallas),
           "table": bool(eng.uses_table),
           "n_iter_equal": bool(equal),
           "drive_total": int(drive_iter.sum()),
           "host_total": int(host_iter.sum()),
           "inflation": round(ratio, 3)}
    if not equal:
        out["drive_iter"] = drive_iter.tolist()
        out["host_iter"] = host_iter.tolist()
    return out


def audit_sharded(name, data, bound, cfg):
    """ShardedEnsemble on a 1-device mesh vs the unsharded engine:
    bitwise counter/contribution equality at the same seed (the rep
    ensemble must be execution-layout invariant — reference semantics
    anchor mcsas/mcsas.py:214).  Returns the row."""
    from mcsas_tpu.core.engine import McSASEngine
    from mcsas_tpu.parallel.mesh import make_mesh
    from mcsas_tpu.parallel.spmd import ShardedEnsemble

    se = ShardedEnsemble(data, bound, cfg, mesh=make_mesh((1, 1)))
    platform = se.mesh.devices.flat[0].platform
    res_s = se.run()
    res_u = McSASEngine(data, bound, cfg).run()
    s_iter = res_s.n_iter.astype(np.int64)
    u_iter = res_u.n_iter.astype(np.int64)
    equal = np.array_equal(s_iter, u_iter)
    ratio = float(s_iter.sum()) / max(float(u_iter.sum()), 1.0)
    out = {"config": name + "+sharded",
           "mesh_platform": platform,
           "kernel_shard": bool(se._pallas_shard),
           "table": bool(se.uses_table),
           "sharded_drive": bool(se._drive is not None),
           "n_iter_equal": bool(equal),
           "contribs_equal": bool(
               np.array_equal(res_s.contribs, res_u.contribs)),
           "sharded_total": int(s_iter.sum()),
           "unsharded_total": int(u_iter.sum()),
           "inflation": round(ratio, 3)}
    if not equal:
        out["sharded_iter"] = s_iter.tolist()
        out["unsharded_iter"] = u_iter.tolist()
    return out


def main():
    only = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--only=")]
    sharded = "--sharded" in sys.argv
    for entry in CONFIGS:
        if only and entry[0] not in only:
            continue
        data, bound, cfg = build_config(entry)
        print(json.dumps(audit(entry[0], data, bound, cfg)), flush=True)
        if sharded:
            print(json.dumps(audit_sharded(entry[0], data, bound, cfg)),
                  flush=True)


if __name__ == "__main__":
    main()
