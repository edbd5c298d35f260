# -*- coding: utf-8 -*-
"""Every float32 contraction runs at Precision.HIGHEST (ops/precision.py):
on a GPU a default-precision f32 matmul may run in TF32.  Each site is
traced and the precision of its dot_general is read from the jaxpr."""
import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from mcsas_tpu import data
from mcsas_tpu.config import McSASConfig
from mcsas_tpu.core.engine import McSASEngine
from mcsas_tpu.data import DataConfig, TrapezoidSmearing
from mcsas_tpu.models import get_model
from mcsas_tpu.ops import tables

NM = 1e-9
HIGHEST = jax.lax.Precision.HIGHEST


def dot_precisions(fn, *args):
    """The precision of every dot_general in fn's jaxpr (nested
    jaxprs included)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def assert_highest(fn, *args):
    precs = dot_precisions(fn, *args)
    assert precs, "no contraction traced"
    for p in precs:
        assert p is not None and all(x == HIGHEST for x in p), precs


@pytest.fixture(scope="module")
def smeared(refdata):
    dc = DataConfig(smearing=TrapezoidSmearing(
        do_smear=True, n_steps=5, umbra=0.05e9, penumbra=0.2e9))
    d = data.load(refdata / "sasfit_sphere-10-1.dat", config=dc)
    assert d.uses_smearing
    return d


class _Captured(Exception):
    pass


# (model, active, ranges, fixed): one per table factory with a smeared
# row contraction
_TABLE_MODELS = {
    "cylinders-isotropic": ("CylindersIsotropic", ("radius",),
                            {"radius": (1 * NM, 50 * NM)},
                            {"useAspect": 1.0, "aspect": 10.0}),
    "cylinders-psi-grid": ("CylindersIsotropicAspect", ("radius",),
                           {"radius": (1 * NM, 50 * NM)}, None),
    "ellipsoids-isotropic": ("EllipsoidsIsotropic", ("a",),
                             {"a": (1 * NM, 50 * NM)}, {"aspect": 3.0}),
    "core-shell-ellipsoid": ("EllipsoidalCoreShell", ("a", "t"),
                             {"a": (2 * NM, 50 * NM),
                              "t": (10 * NM, 200 * NM)}, {"b": 15 * NM}),
}


@pytest.mark.parametrize("site", sorted(_TABLE_MODELS))
def test_table_bake_contraction_pinned(site, smeared, monkeypatch):
    """The smeared table rows (ff² contracted with the dataset's own
    smearing weights) are baked at HIGHEST precision."""
    name, active, ranges, fixed = _TABLE_MODELS[site]
    bound = get_model(name).bind(active=active, active_ranges=ranges,
                                 fixed=fixed)
    seen = {}

    def capture(row_fn, grids, *a, **k):
        seen["row_fn"], seen["n"] = row_fn, len(grids)
        raise _Captured

    monkeypatch.setattr(tables, "build_param_table", capture)
    with pytest.raises(_Captured):
        bound.model.ff_table_factory(
            bound, np.asarray(smeared.q), jnp.float32,
            smear=(np.asarray(smeared.locs), np.asarray(smeared.smear_w)))
    vals = jnp.full((seen["n"],), 10 * NM, jnp.float32)
    assert_highest(seen["row_fn"], vals)


@pytest.mark.parametrize("model, table", [("Sphere", "off"),
                                          ("Kholodenko", "on")])
def test_engine_smeared_row_pinned(model, table, smeared, monkeypatch):
    """The engine's smeared intensity row: the elementwise path's own
    contraction, and Kholodenko's partial table finishing the
    contraction inside its lookup."""
    monkeypatch.setenv("MCSAS_TPU_TABLE_RES_CAP", "16")
    eng = McSASEngine(smeared, get_model(model).bind(),
                      McSASConfig(num_contribs=4, num_reps=1,
                                  table_ff=table))
    assert eng.uses_table == (table == "on")
    pvec = jnp.asarray([np.sqrt(lo * hi) for lo, hi in eng.bound.ranges],
                       jnp.float32)
    assert_highest(eng._intensity_row, eng.grid, pvec)


def test_accel_post_row_pinned(smeared, monkeypatch):
    """The accelerator post tier's normalized-f32 smeared bank row."""
    from mcsas_tpu.post import histogram
    bound = get_model("CylindersIsotropic").bind(
        active=("radius",), active_ranges={"radius": (1 * NM, 50 * NM)})
    jitted = []
    real_jit = jax.jit

    def capture(fn, *a, **k):
        jitted.append(fn)
        return real_jit(fn, *a, **k)

    monkeypatch.setattr(jax, "jit", capture)
    histogram._accel_bank(bound, smeared, McSASConfig(), smearing=True)
    monkeypatch.setattr(jax, "jit", real_jit)
    assert_highest(jitted[-1], jnp.full((3, 1), 10 * NM, jnp.float32))
