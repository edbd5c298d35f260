# -*- coding: utf-8 -*-
"""Multi-device fitting over a jax.sharding.Mesh: repetitions shard over
the "rep" axis (pure data parallelism), and optionally the q grid over
"q" with psum-completed χ² reductions.  Accept decisions are invariant
to the q-split (float64-accumulated solve), so results match
single-chip runs exactly.

Run on a multi-GPU host, or simulate one on CPU:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
    JAX_PLATFORMS=cpu python examples/multichip.py path/to/data.dat
"""
import sys

import jax

import mcsas_tpu as mt
from mcsas_tpu.config import McSASConfig
from mcsas_tpu.parallel import make_mesh


def main(path):
    devices = jax.devices()
    n_dev = len(devices)
    print(f"{n_dev} devices: {devices[0].platform}")
    # rep-only layout (n_dev × 1): zero collectives; use
    # (n_dev // 2, 2) to also shard the q axis on very fine grids —
    # every tier (quadrature, param-table, smeared) shards either way
    mesh = make_mesh((n_dev, 1))

    data = mt.load(path)
    cfg = McSASConfig(num_contribs=300, num_reps=2 * n_dev,
                      max_iterations=2_000_000, candidates_per_step=64,
                      chunk_steps=1024)
    result = mt.fit(data, model="Sphere", cfg=cfg, mesh=mesh)
    print(f"chi2 per repetition: {result.engine.conval.round(3)}")
    print(f"{result.engine.iters_per_sec:,.0f} proposals/s across "
          f"{n_dev} devices")


if __name__ == "__main__":
    main(sys.argv[1])
