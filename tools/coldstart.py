#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Cold-start budget per execution tier.

For each tier, runs ONE fresh-process ``fit()`` with ``JAX_LOG_COMPILES=1``
and reports: wall-clock of the first fit, the number of distinct
executables XLA compiled (parsed from the compile log), and the warm
repeat inside the same process.  Run sequentially — each child opens
the card, and one process at a time may hold it.

Usage: python tools/coldstart.py [--tier=sphere ...] [--prewarm]
With --prewarm the child prewarms the engine first (the user-facing
remedy: fit(..., prewarm=True) / mcsas-tpu --prewarm), so cold_s is
the first fit a prewarmed user actually times.
Prints one JSON line per tier.
"""
import json
import os
import re
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, {repo!r})
import mcsas_tpu as mt
from mcsas_tpu.config import McSASConfig
from mcsas_tpu.models import get_model
from bench import synth_golden

tier = {tier!r}
nm = 1e-9
if tier == "sphere":
    data = mt.load(os.path.join({repo!r}, "testdata",
                                "sasfit_sphere-10-1.dat"))
    bound = get_model("Sphere").bind()
    extra = dict(local_moves=0.5)
elif tier == "gaussian-chain":
    data = mt.load(os.path.join({repo!r}, "testdata",
                                "sasfit_gauss2-5-1.5-2-1.dat"))
    bound = get_model("GaussianChain").bind()
    extra = dict(candidates_per_step=64, max_iterations=4_000_000)
elif tier == "cylinders-table":
    data = synth_golden("cylinder")
    bound = get_model("CylindersIsotropic").bind(
        active=("radius",),
        active_ranges={{"radius": (0.5 * nm, 300 * nm)}})
    extra = dict(chunk_steps=1024)
elif tier == "kholodenko-table":
    data = mt.load(os.path.join({repo!r}, "testdata",
                                "sasfit_kho-1-10-1000.dat"))
    bound = get_model("Kholodenko").bind()
    extra = dict(local_moves=0.75, max_iterations=24_000_000)
else:
    raise SystemExit(f"unknown tier {{tier}}")

kw = dict(num_contribs=300, num_reps=10, max_iterations=8_000_000,
          chunk_steps=2048, candidates_per_step=128, seed=2026,
          max_retries=1, show_incomplete=True)
kw.update(extra)
cfg = McSASConfig(**kw)
prewarm = bool(int(os.environ.get("MCSAS_TPU_COLDSTART_PREWARM", "0")))
pre = 0.0
if prewarm:
    # the user-facing cold-start remedy: AOT-compile the launch plan
    # (and bake tables) FIRST, then time the first fit they care about
    t0 = time.perf_counter()
    from mcsas_tpu.api import (_cached_engine, _default_unbounded_ranges,
                               prewarm_post)
    from mcsas_tpu.core.engine import McSASEngine
    b = _default_unbounded_ranges(bound, data)
    eng = _cached_engine(McSASEngine, data, b, cfg)
    eng.prewarm()
    prewarm_post(data, b, cfg)
    pre = time.perf_counter() - t0
t0 = time.perf_counter()
res = mt.fit(data, model=bound, cfg=cfg)
cold = time.perf_counter() - t0
t0 = time.perf_counter()
res = mt.fit(data, model=bound, cfg=cfg)
warm = time.perf_counter() - t0
print(json.dumps(dict(
    tier=tier, prewarm_s=round(pre, 2) if prewarm else None,
    cold_s=round(cold, 2), warm_s=round(warm, 3),
    converged=int(res.engine.converged.sum()),
    kernel=bool(res.engine.used_pallas),
    table=bool(res.engine.used_table))), flush=True)
"""

TIERS = ["sphere", "gaussian-chain", "cylinders-table", "kholodenko-table"]


def run_tier(tier: str, fresh_cache: bool, prewarm: bool = False) -> dict:
    env = dict(os.environ, JAX_LOG_COMPILES="1",
               MCSAS_TPU_COLDSTART_PREWARM=str(int(prewarm)))
    env.setdefault("MCSAS_TPU_TABLE_CACHE_DIR",
                   os.path.join(_REPO, ".table_cache"))
    if fresh_cache:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c",
                        _CHILD.format(repo=_REPO, tier=tier)],
                       capture_output=True, text=True, cwd=_REPO,
                       timeout=3600, env=env)
    # JAX_LOG_COMPILES emits one 'Compiling <name> ...' line per
    # executable handed to the backend (persistent-cache hits included:
    # the count is the number of distinct programs a fresh fit() NEEDS,
    # which is the budget VERDICT asks for)
    names = re.findall(r"Compiling (jit\([^)]*\)|[\w<>\[\]\-.]+) with",
                       r.stderr)
    result = {}
    for line in r.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            result = json.loads(line)
    out = dict(result, executables=len(names),
               distinct_names=sorted(set(names)), rc=r.returncode)
    if r.returncode != 0:
        out["stderr_tail"] = r.stderr[-2000:]
    return out


if __name__ == "__main__":
    only = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--tier=")]
    pw = "--prewarm" in sys.argv
    for tier in (only or TIERS):
        print(json.dumps(run_tier(tier, fresh_cache=False, prewarm=pw)),
              flush=True)
