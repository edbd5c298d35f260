# -*- coding: utf-8 -*-
"""Slit-smeared fitting: configure a trapezoidal beam-length profile
(reference smearing: src/mcsas/dataobj/sasconfig.py:105-200) and fit a
quadrature model — the smeared-intensity param-table tier keeps the MC
loop at table speed, and the float64 post analysis applies the same
contraction (accelerator-assisted on a GPU, post_compute='auto').

    python examples/smeared_fit.py path/to/data.dat
"""
import sys

import mcsas_tpu as mt
from mcsas_tpu.config import McSASConfig
from mcsas_tpu.data import DataConfig, TrapezoidSmearing


def main(path):
    # umbra/penumbra are the flat-top and full base half-widths of the
    # trapezoidal beam-length profile, in SI (m⁻¹): 0.05/0.2 nm⁻¹ here
    smearing = TrapezoidSmearing(do_smear=True, n_steps=25,
                                 umbra=0.05e9, penumbra=0.2e9)
    data = mt.load(path, config=DataConfig(smearing=smearing))
    print(f"loaded {data.title}: {data.count} points, "
          f"smearing={'ON' if data.uses_smearing else 'off'}")

    bound = mt.get_model("CylindersIsotropic").bind(
        active=("radius",),
        active_ranges={"radius": (0.5e-9, 300e-9)})
    cfg = McSASConfig(num_contribs=300, num_reps=10,
                      max_iterations=8_000_000, candidates_per_step=128,
                      chunk_steps=1024)
    result = mt.fit(data, model=bound, cfg=cfg)
    print(f"chi2 per repetition: {result.engine.conval.round(3)}")
    print(f"table tier: {result.engine.used_table}, "
          f"{result.engine.iters_per_sec:,.0f} proposals/s")
    out = mt.OutputFiles(result, "out_smeared/")
    out.write_all(plot=True)


if __name__ == "__main__":
    main(sys.argv[1])
