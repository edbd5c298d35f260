#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Suite statistics: run `bench.py --suite` N times and report
median ± spread per config family (single-run suite rows vary; medians
over N>=5 make the claims sturdy).

Runs sequentially in subprocesses (one process at a time may hold the
card).

Usage: python tools/suite_stats.py [--runs 5] [--out suite_stats.json]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    env = dict(os.environ)
    env.setdefault("MCSAS_TPU_TABLE_CACHE_DIR",
                   os.path.join(_REPO, ".table_cache"))
    rows = {}
    for i in range(args.runs):
        r = subprocess.run([sys.executable, "bench.py", "--suite"],
                           capture_output=True, text=True, cwd=_REPO,
                           timeout=3600, env=env)
        if r.returncode != 0:
            print(json.dumps({"run": i, "error": r.stderr[-500:]}),
                  flush=True)
            continue
        for line in r.stdout.splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            d = json.loads(line)
            rows.setdefault(d["config"], []).append(d)
        print(json.dumps({"run": i, "done": True}), file=sys.stderr,
              flush=True)

    out = {}
    for name, runs in rows.items():
        warm = [d["seconds_warm"] for d in runs]
        pps = [d["proposals_per_sec"] for d in runs]
        iters = {d["total_iters"] for d in runs}
        out[name] = {
            "n": len(runs),
            "warm_median_s": round(statistics.median(warm), 3),
            "warm_min_s": round(min(warm), 3),
            "warm_max_s": round(max(warm), 3),
            "pps_median": round(statistics.median(pps)),
            # determinism audit: identical seeds must grind identical
            # proposal totals on every run — spread here means a
            # trajectory regression, not link noise
            "total_iters_distinct": sorted(iters),
            "converged_all": all(d["converged_reps"] == 10
                                 for d in runs),
        }
        print(json.dumps({"config": name, **out[name]}), flush=True)
    if args.out:
        json.dump(out, open(args.out, "w"), indent=1)


if __name__ == "__main__":
    main()
