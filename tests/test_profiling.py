# -*- coding: utf-8 -*-
"""Tracing/profiling helpers (utils/profiling.py)."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np

from mcsas_tpu.utils.profiling import (Stopwatch, annotate, debug_guards,
                                       trace)


def test_trace_writes_capture(tmp_path):
    with trace(tmp_path):
        with annotate("unit-phase"):
            np.asarray(jax.jit(lambda x: x * 2.0)(jnp.ones(8)))
    files = glob.glob(str(tmp_path / "**" / "*"), recursive=True)
    assert any(os.path.isfile(f) for f in files), "no trace artifacts"


def test_debug_guards_restores_flags():
    # flag plumbing only: actually tripping debug_nans dispatches tiny
    # eager ops, each a fresh compile
    prev = jax.config.jax_debug_nans
    with debug_guards(nans=True):
        assert jax.config.jax_debug_nans
    assert jax.config.jax_debug_nans == prev


def test_stopwatch_report():
    sw = Stopwatch()
    with sw.phase("a"):
        pass
    with sw.phase("b"):
        pass
    rep = sw.report()
    assert "a" in rep and "b" in rep and "total" in rep
