#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""On-card smoke test: drives the McSAS fit end to end on one NVIDIA GPU
and checks every phase against the repository's own references.

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --devices 4  # only the 4-card sharded ensemble

Phases (one card): device; the headline sphere fit through ``mt.fit``
(twice); the CLI quickstart; one family per engine tier; the
drive-vs-host-loop audit; the GPU chunk kernel against the XLA scan
path, with warm fit times; the accelerator post tier against the CPU
float64 pass; and a TF32 negative control.  Any failure raises and the
exit code is nonzero.  The last line of standard output is one JSON
object naming the device.

Without a GPU, or run from a directory without the package beside it,
the script exits nonzero and prints no result.  It runs in one process.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NM = 1e-9


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi reports
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def require_gpu(count: int):
    """The first *count* JAX devices; exits nonzero unless they are
    GPUs."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found "
                 f"{devices[0].platform!r}")
    if len(devices) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX found "
                 f"{len(devices)}")
    return devices[:count]


def result_line(devices) -> str:
    """The final JSON line."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def say(phase, text):
    print(f"[{phase}] {text}", flush=True)


def timed_median(fn, n=3):
    """Median wall time of *n* warm calls (one untimed call first); each
    call ends with its result on the host (block_until_ready)."""
    import jax
    jax.block_until_ready(fn())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def headline_cfg(**kw):
    """bench.py main()'s headline sphere config (K=128, local moves
    0.5, 300 contributions x 10 repetitions)."""
    from mcsas_tpu.config import McSASConfig
    base = dict(num_contribs=300, num_reps=10, max_iterations=8_000_000,
                chunk_steps=2048, candidates_per_step=128, seed=2026,
                max_retries=1, local_moves=0.5)
    base.update(kw)
    return McSASConfig(**base)


def check_fit(res, label, crit=1.0):
    conv = int(res.converged.sum())
    chi = float(res.conval.max())
    assert conv == res.converged.size and chi <= crit, (
        f"{label}: {conv}/{res.converged.size} converged, max chi2 {chi}")
    return conv, chi


def phase_headline(card):
    import mcsas_tpu as mt
    from mcsas_tpu.models import get_model
    data = mt.load(os.path.join(REPO, "testdata", "sasfit_sphere-10-1.dat"))
    bound = get_model("Sphere").bind()
    iters = []
    for run in (1, 2):
        t0 = time.perf_counter()
        res = mt.fit(data, model=bound, cfg=headline_cfg())
        wall = time.perf_counter() - t0
        conv, chi = check_fit(res.engine, f"headline run {run}")
        iters.append(int(res.engine.total_iters))
        say("headline", f"run {run}: {conv}/10 converged, max chi2 "
            f"{chi:.4f}, total_iters {iters[-1]}, kernel "
            f"{res.engine.used_pallas}, {wall:.3f} s")
    say("headline", f"total_iters repeated run to run: "
        f"{iters[0] == iters[1]} ({iters[0]}, {iters[1]}) on {card}")


def phase_cli():
    from mcsas_tpu import cli
    qs = os.path.join(REPO, "testdata", "quickstartdemo1.csv")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = cli.main([qs, "-m", "Sphere", "-o", out])
        wall = time.perf_counter() - t0
        assert rc == 0, f"CLI quickstart returned {rc} (not converged)"
        written = sorted(f for _, _, files in os.walk(out) for f in files)
        assert any(f.endswith(".dat") for f in written), written
    say("cli", f"quickstartdemo1.csv, default McSASConfig (K=1): "
        f"converged, {len(written)} files written, {wall:.1f} s")


def own_rule_data(bound, radius=10 * NM):
    """A monodisperse curve evaluated with the model's own quadrature
    rule (float64, 1% uncertainty): the synthetic golden curves use a
    converged 801-node rule, which the hot loop's default 100-node rule
    cannot fit to chi2 <= 1 without its table."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mcsas_tpu.data import DataConfig, from_raw
    q_nm = np.geomspace(0.01, 2.0, 100)
    with jax.default_device(jax.devices("cpu")[0]):
        ff = jax.jit(bound.ff)(jnp.asarray(q_nm * 1e9, jnp.float64),
                               jnp.asarray([radius], jnp.float64))
    i = np.asarray(ff, np.float64) ** 2
    i = i / i.max()
    return from_raw(np.column_stack([q_nm, i, 0.01 * i]),
                    title="own-rule-cylinder", config=DataConfig(n_bin=0))


def tier_of(eng) -> str:
    if eng.uses_pallas:
        return "gpu-kernel"
    if eng._drive is None:
        return "host-chunk-loop"
    return "xla-table-drive" if eng.uses_table else "xla-drive"


def phase_tiers(da):
    """One family per engine tier; returns the smeared cylinder fit for
    the post-tier phase."""
    from mcsas_tpu.core.engine import McSASEngine
    entries = {e[0]: e for e in da.CONFIGS}
    plan = [("sphere", {}, "gpu-kernel"),
            ("cylinders-isotropic", {}, "gpu-kernel"),
            ("cylinders-smeared", {}, "gpu-kernel"),
            ("kholodenko-worm", {}, "gpu-kernel"),
            # the quadrature rule in the hot loop (no table)
            ("cylinders-isotropic", {"table_ff": "off"},
             "host-chunk-loop")]
    kept = {}
    for name, over, want in plan:
        data, bound, cfg = da.build_config(entries[name])
        cfg = cfg.replace(**over)
        if over:
            data = own_rule_data(bound)
        t0 = time.perf_counter()
        eng = McSASEngine(data, bound, cfg)
        tier = tier_of(eng)
        assert tier == want, f"{name}: tier {tier}, expected {want}"
        res = eng.run()
        conv, chi = check_fit(res, name)
        say("tiers", f"{name}{' ' + str(over) if over else ''}: tier "
            f"{tier}, table {eng.uses_table}, {conv}/10 converged, max "
            f"chi2 {chi:.4f}, total_iters {res.total_iters}, "
            f"{time.perf_counter() - t0:.1f} s incl. build and compile")
        kept[(name, tuple(over))] = (data, bound, cfg, res)
    return kept


def phase_audit(da):
    entries = {e[0]: e for e in da.CONFIGS}
    for name in ("sphere", "cylinders-isotropic", "kholodenko-worm"):
        row = da.audit(name, *da.build_config(entries[name]))
        assert row.get("n_iter_equal") and row["inflation"] == 1.0, row
        say("audit", json.dumps(row))


def phase_kernel(da, card):
    """The GPU kernel against the XLA scan path (use_pallas='off'): one
    chunk from the same state and keys, a full fit at the kernel's
    segment length, and warm fit() times of both."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import mcsas_tpu as mt
    from mcsas_tpu.core.engine import McSASEngine
    from mcsas_tpu.models import get_model
    from mcsas_tpu.ops import mc_kernel

    entries = {e[0]: e for e in da.CONFIGS}
    sphere = mt.load(os.path.join(REPO, "testdata",
                                  "sasfit_sphere-10-1.dat"))
    cases = [("sphere", sphere, get_model("Sphere").bind(),
              headline_cfg())]
    for name in ("cylinders-isotropic", "kholodenko-worm"):
        cases.append((name,) + tuple(da.build_config(entries[name])))
    for name, data, bound, cfg in cases:
        ek = McSASEngine(data, bound, cfg)
        assert ek.uses_pallas, f"{name}: the kernel did not engage"
        seg = mc_kernel.seg_steps(ek)
        # the scan path chunked at the kernel's segment consumes the
        # same threefry stream
        ex = McSASEngine(data, bound,
                         cfg.replace(use_pallas="off", chunk_steps=seg))
        keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.num_reps)
        ri = jnp.zeros((), jnp.int32)
        sk, _ = ek._chunk_batch(ek._init_batch(keys), ri)
        sx, _ = ex._chunk_batch(ex._init_batch(keys), ri)
        # a χ² tie on a float32 rounding boundary may flip one accept and
        # cascade within one repetition (the full-fit rule below); every
        # other repetition must follow the same trajectory
        same = np.array([np.array_equal(a, b) for a, b in
                         zip(np.asarray(sk.rset), np.asarray(sx.rset))])
        devs = []
        for f in ("conval", "scale", "background"):
            a = np.asarray(getattr(sk, f), np.float64)[same]
            b = np.asarray(getattr(sx, f), np.float64)[same]
            devs.append((f, float(np.max(np.abs(a - b) / np.abs(b)))))
        say("kernel", f"{name}: one {seg}-step chunk vs XLA scan: "
            f"{int(same.sum())}/{same.size} reps on the same trajectory, "
            "max rel there " + ", ".join(f"{f} {d:.2e}" for f, d in devs))
        assert same.sum() >= same.size - 1, f"{name}: reps diverged"
        assert all(d <= 1e-5 for _, d in devs), f"{name}: {devs}"
        say("kernel", da.assert_contribs_close(
            ek.run(), ex.run(), f"{name} full fit, kernel vs XLA scan"))
        t_k = timed_median(lambda: mt.fit(data, model=bound, cfg=cfg)
                           .engine.conval)
        t_x = timed_median(lambda: mt.fit(
            data, model=bound, cfg=cfg.replace(use_pallas="off"))
            .engine.conval)
        say("kernel", f"{name}: warm fit() median of 3: kernel {t_k:.4f} "
            f"s, use_pallas='off' {t_x:.4f} s ({t_x / t_k:.2f}x) on {card}")


def phase_post(kept):
    """Accelerator post tier vs the CPU float64 pass on the smeared
    cylinder fit's contributions."""
    import numpy as np
    from mcsas_tpu.post.histogram import _post_pass_f64
    data, bound, cfg, res = kept[("cylinders-smeared", ())]
    outs = {tier: _post_pass_f64(bound, data,
                                 cfg.replace(post_compute=tier),
                                 res.contribs)
            for tier in ("cpu", "accel")}
    # the background is an intensity: its deviation is relative to the
    # data's intensity scale (a fitted background near zero has no
    # meaningful relative error of its own)
    for i, name, ref in ((3, "scale", None),
                         (4, "background", np.max(np.abs(data.f)))):
        a = np.asarray(outs["cpu"][i], np.float64)
        b = np.asarray(outs["accel"][i], np.float64)
        rel = float(np.max(np.abs(a - b)) / (
            np.max(np.abs(a)) if ref is None else ref))
        assert rel < 1e-6, f"accel post tier {name}: rel {rel:.2e}"
        say("post", f"cylinders-smeared accel vs cpu f64: {name} rel "
            f"{rel:.2e} (< 1e-6{'' if ref is None else ' of max |I|'})")


def phase_tf32(kept, card):
    """The smeared cylinder row's contraction at the package's pinned
    precision and at Precision.DEFAULT, each against float64."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mcsas_tpu.models.cylinders import _cyl_iso_ff_ab
    from mcsas_tpu.ops.precision import dot
    data = kept[("cylinders-smeared", ())][0]
    locs = np.asarray(data.locs, np.float64)            # (Nq, steps)
    sw = np.asarray(data.smear_w, np.float64)          # (steps,)
    radii = np.geomspace(1 * NM, 100 * NM, 256)

    def rows(dtype):
        q = jnp.asarray(locs, dtype)
        r = jnp.asarray(radii, dtype)[:, None, None]
        f = _cyl_iso_ff_ab(q * r, q * (20.0 * r), 64, dtype)
        return f * f                                   # (B, Nq, steps)

    f2 = jax.jit(lambda: rows(jnp.float32))()
    ref = np.asarray(f2, np.float64) @ sw
    sw32 = jnp.asarray(sw, jnp.float32)
    pinned = np.asarray(jax.jit(dot)(f2, sw32), np.float64)
    default = np.asarray(jax.jit(jnp.matmul)(f2, sw32), np.float64)
    scale = np.max(np.abs(ref), axis=1, keepdims=True)
    dev_p = float(np.max(np.abs(pinned - ref) / scale))
    dev_d = float(np.max(np.abs(default - ref) / scale))
    assert dev_p < 1e-5, f"pinned contraction deviates {dev_p:.2e}"
    say("tf32", f"smeared row contraction vs float64: HIGHEST {dev_p:.2e}, "
        f"DEFAULT {dev_d:.2e} ({'also' if dev_d < 1e-5 else 'not'} within "
        f"1e-5) on {card}")


def phase_devices(n, card):
    """The repetition-sharded ensemble on n cards: sphere on (n, 1) and
    (n/2, 2) meshes, the table tier on (n, 1); each against the
    unsharded engine on one card."""
    import jax
    import numpy as np
    import mcsas_tpu as mt
    from mcsas_tpu.core.engine import McSASEngine
    from mcsas_tpu.models import get_model
    from mcsas_tpu.parallel import ShardedEnsemble, make_mesh
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import drive_audit as da

    reps = 4 * n      # a wide ensemble: n times the headline's share
    sphere = mt.load(os.path.join(REPO, "testdata",
                                  "sasfit_sphere-10-1.dat"))
    entries = {e[0]: e for e in da.CONFIGS}
    cyl = da.build_config(entries["cylinders-isotropic"])
    cases = [("sphere", (n, 1), sphere, get_model("Sphere").bind(),
              headline_cfg(num_reps=reps)),
             ("sphere", (n // 2, 2), sphere, get_model("Sphere").bind(),
              headline_cfg(num_reps=reps)),
             ("cylinders-isotropic", (n, 1), cyl[0], cyl[1],
              cyl[2].replace(num_reps=reps))]
    for name, shape, data, bound, cfg in cases:
        se = ShardedEnsemble(data, bound, cfg, mesh=make_mesh(shape))
        state = se._init_drive(cfg.seed)[0]
        devs = sorted(d.id for d in state.ibank.sharding.device_set)
        assert len(devs) == n, f"sharded state on devices {devs}"
        res = se.run()
        check_fit(res, f"{name} mesh {shape}")
        # the XLA scan path at the sharded run's chunking consumes the
        # same threefry stream
        base_cfg = cfg.replace(use_pallas="off")
        if se._pallas_shard:
            base_cfg = base_cfg.replace(chunk_steps=se._kernel_seg)
        base = McSASEngine(data, bound, base_cfg).run()
        say("devices", da.assert_contribs_close(
            res, base, f"{name} mesh {shape} (kernel {se._pallas_shard}, "
            f"state on devices {devs}) vs unsharded"))
        t_s = timed_median(lambda: se.run().conval)
        eng1 = McSASEngine(data, bound, cfg)
        t_1 = timed_median(lambda: eng1.run().conval)
        say("devices", f"{name} mesh {shape}, {reps} reps: warm MC "
            f"median of 3 {t_s:.4f} s on {n} cards, {t_1:.4f} s on one "
            f"({card})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4 runs only the sharded ensemble on 4 cards")
    args = ap.parse_args(argv)
    devices = require_gpu(args.devices)
    import jax
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import mcsas_tpu  # noqa: F401  (fails outside a checkout)
    import drive_audit as da
    card = card_line()
    say("device", f"{card}; {len(jax.devices())} x "
        f"{devices[0].device_kind}; jax {jax.__version__}, "
        f"{devices[0].client.platform_version}")
    t0 = time.perf_counter()
    if args.devices > 1:
        phase_devices(args.devices, card)
    else:
        phase_headline(card)
        phase_cli()
        kept = phase_tiers(da)
        phase_audit(da)
        phase_kernel(da, card)
        phase_post(kept)
        phase_tf32(kept, card)
    say("done", f"all phases passed in {time.perf_counter() - t0:.0f} s")
    print(card)
    print(result_line(devices))


if __name__ == "__main__":
    main()
