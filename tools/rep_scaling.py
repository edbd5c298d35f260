# -*- coding: utf-8 -*-
"""Repetition-batch scaling probe: per-chip throughput vs rep count.

The multi-chip layout is rep-axis data parallelism (each mesh device
hosts a block of repetitions; the single-launch drive has ZERO
cross-device collectives on a (R, 1) mesh — mcsas_tpu/parallel/spmd.py).
Multi-chip throughput is therefore (this curve) x (chip count), so the
honest single-chip basis for the scaling claim is how aggregate
proposals/s grows with the rep batch B hosted on ONE chip: flat
per-rep cost until the card saturates, then linear aggregate gains.

Wall-clock per fit grows mildly with B because the drive runs until the
SLOWEST rep converges (max of iid convergence times) — the same
straggler a real DP mesh pays per device, so it is reported, not hidden.

Usage:
    python tools/rep_scaling.py [--reps 1,2,5,10,20,40] [--json out.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", default="1,2,5,10,20,40")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    reps_list = [int(r) for r in args.reps.split(",")]

    import jax

    import mcsas_tpu as mt
    from bench import find_dataset
    from mcsas_tpu.config import McSASConfig
    from mcsas_tpu.core.engine import McSASEngine
    from mcsas_tpu.models import get_model

    data = mt.load(find_dataset())
    bound = get_model("Sphere").bind()
    rows = []
    for n_reps in reps_list:
        cfg = McSASConfig(num_contribs=300, num_reps=n_reps,
                          max_iterations=8_000_000, chunk_steps=2048,
                          candidates_per_step=128, seed=2026,
                          max_retries=1, local_moves=0.5)
        eng = McSASEngine(data, bound, cfg)
        res = eng.run()                      # warm-up / compile
        wall, best = float("inf"), None
        for _ in range(2):                   # best-of-2 (link variance)
            t0 = time.perf_counter()
            r = eng.run()
            dt = time.perf_counter() - t0
            if dt < wall:                    # keep the run that set the
                wall, best = dt, r           # min so the row is coherent
        res = best
        pps = res.total_iters / wall         # derived from the SAME run
        row = {
            "reps": n_reps,
            "wall_s": round(wall, 4),
            "proposals_per_sec": round(pps),
            "per_rep_proposals_per_sec": round(pps / n_reps),
            "total_proposals": int(res.total_iters),
            "converged": int(res.converged.sum()),
            "max_chi2": round(float(res.conval.max()), 4),
            "kernel": bool(res.used_pallas),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {"device": str(jax.devices()[0]), "rows": rows}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
        print("wrote", args.json)


if __name__ == "__main__":
    main()
