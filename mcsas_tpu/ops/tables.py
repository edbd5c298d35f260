# -*- coding: utf-8 -*-
"""Parameter-grid form-factor row tables: fit-grade evaluation for
quadrature-heavy models.

The orientation/propagator integrals of the quadrature models
(reference integrand e.g. src/mcsas/models/cylindersisotropic.py:50-90)
cost ~100 transcendental nodes per proposal row.  The MC hot loop never
needs to re-integrate: the converged integral is evaluated ONCE per
engine over a log-spaced grid of the active size parameters — with the
fit-grid q axis exact — and each proposal's row becomes a multilinear
blend of 2^P gathered table rows: row gathers (`take(axis=0)`, one
scalar index per candidate) instead of the per-element gathers a
(q·R, q·L)-invariant texture needs (docs/DESIGN.md §tables).

Accuracy contract: this is the same "fit-grade" tier as ``ff_fast``
(core/engine.py make_intensity_kernels) — the float32 MC loop trades
~1e-3 kernel accuracy for throughput, and all float64 analysis
(post-processing, observability, final scaling) re-evaluates the exact
``ff``.

The table build is one jitted vmap whose *shapes* are static (grid
values are runtime arguments), so the builder executable is compiled
once and shared across ranges via the persistent cache; built tables are
additionally memoized per process (keyed on grids AND the bound model's
fixed parameter values).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def grid_fingerprint(q_grid) -> str:
    """Collision-safe cache-key fingerprint of a q grid: digest of the
    full float64 byte content (two datasets with equal point count and
    coincidentally equal sums must not share a baked table)."""
    import hashlib
    return hashlib.sha1(
        np.ascontiguousarray(np.asarray(q_grid, np.float64)).tobytes()
    ).hexdigest()


def cap_res(res: tuple) -> tuple:
    """Applies the MCSAS_TPU_TABLE_RES_CAP env override (tests/CI shrink
    the one-time table build; production keeps the model defaults)."""
    import os
    cap = int(os.environ.get("MCSAS_TPU_TABLE_RES_CAP", "0") or 0)
    if cap > 0:
        return tuple(min(int(r), cap) for r in res)
    return res


def smear_fingerprint(smear) -> tuple:
    """Cache-key fingerprint of a smearing contraction (locs grid +
    weight vector); None stays None (unsmeared tables)."""
    if smear is None:
        return None
    locs, sw = smear
    return (grid_fingerprint(np.asarray(locs).ravel()),
            grid_fingerprint(np.asarray(sw).ravel()))


def log_grid(lo: float, hi: float, n: int) -> np.ndarray:
    """Log-spaced grid; degenerate ranges widen to a factor-2 bracket so
    the interpolation stays well-defined."""
    lo = max(float(lo), 1e-300)
    hi = max(float(hi), lo)
    if hi / lo < 1.0001:
        lo, hi = lo / 2.0, hi * 2.0
    return np.geomspace(lo, hi, n)


_TABLE_CACHE = {}


def _disk_cache_dir():
    """Opt-in persistent table cache (MCSAS_TPU_TABLE_CACHE_DIR): baked
    tables are pure functions of their cache key, so they can be reused
    across processes instead of baked again."""
    import os
    d = os.environ.get("MCSAS_TPU_TABLE_CACHE_DIR", "")
    return d or None


def _disk_cache_path(key):
    import hashlib
    import os
    d = _disk_cache_dir()
    if d is None:
        return None
    digest = hashlib.sha1(repr(key).encode()).hexdigest()
    return os.path.join(d, f"table-{digest}.npz")


def _disk_cache_load(path):
    import os
    if path is None or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            values = z["values"]
            axes = tuple(tuple(ax) for ax in z["axes"])
        axes = tuple((float(l0), float(dl), int(n)) for l0, dl, n in axes)
        return ParamTable(values=jnp.asarray(values), axes=axes)
    except Exception:                       # corrupt entry: rebuild
        return None


def _disk_cache_store(path, table):
    import os
    import tempfile
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # np.savez appends ".npz" unless the name already ends with it,
        # so the temp name must keep the suffix for the atomic publish
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp.npz")
        os.close(fd)
        np.savez(tmp, values=np.asarray(table.values),
                 axes=np.asarray(table.axes, np.float64))
        os.replace(tmp, path)               # atomic publish
    except Exception:                       # cache is best-effort only
        pass


class ParamTable(NamedTuple):
    """Rows of a function f(params, q_grid) over a log-spaced parameter
    grid, with the fit-grid q axis exact (no q interpolation).

    ``values[flat(j1..jP)] = f((exp(l0_k + j_k*dl_k))_k, q_grid)``.
    The lookup per proposal is a multilinear blend of 2^P *row* gathers
    (`take(axis=0)`) instead of the per-element gather a (q,
    param)-invariant texture needs.
    """
    values: jnp.ndarray                    # (n_rows, Nq)
    axes: tuple                            # ((l0, dl, n), ...) per param

    @property
    def n_q(self) -> int:
        return self.values.shape[1]


_DECLINED = "__table_declined__"


def build_param_table(row_fn, grids, dtype=jnp.float32, block: int = 256,
                      cache_key=None, probe: bool = False,
                      probe_rows_are_intensity: bool = False):
    """Evaluates ``row_fn(vals (P,)) -> (Nq,)`` over the cartesian product
    of the log-spaced *grids* (blockwise, one jitted vmap executable).

    *cache_key* memoizes the built table within the process.

    With ``probe=True`` the bake is gated by the interpolation-soundness
    probe (probe_interp_errors / probe_is_fit_grade): returns **None**
    when production-spacing interpolation of this row function cannot
    meet the fit-grade contract — callers then fall back to the exact
    in-loop quadrature path.  Declines are memoized per cache key.
    """
    grids = [np.asarray(g, np.float64) for g in grids]
    dtype = jnp.dtype(dtype)

    def _cast(t):
        # row_fn internals can upcast under package-wide x64 (e.g. f64
        # quadrature nodes); the table contract is the requested dtype —
        # also normalizes stale f64 cache entries stored under f32 keys
        if t.values.dtype != dtype:
            t = t._replace(values=t.values.astype(dtype))
        return t

    key = disk_path = None
    if cache_key is not None:
        import os

        # the probe outcome is part of the cache identity: a table baked
        # with the probe bypassed (MCSAS_TPU_TABLE_PROBE=off) must never
        # be served to a probe-gated caller (it was never certified),
        # and a memoized decline must not mask a later bypassed bake —
        # so the key carries the EFFECTIVE probe mode
        mode = os.environ.get("MCSAS_TPU_TABLE_PROBE", "")
        probe_tag = f"probe:{mode}" if (probe and mode != "off") else ""
        key = (cache_key, tuple((len(g), float(g[0]), float(g[-1]))
                                for g in grids), dtype.name, probe_tag)
        hit = _TABLE_CACHE.get(key)
        if hit is _DECLINED:
            return None
        if hit is not None:
            return _cast(hit)
        disk_path = _disk_cache_path(key)
        hit = _disk_cache_load(disk_path)
        if hit is not None:
            hit = _cast(hit)
            _TABLE_CACHE[key] = hit
            return hit
    if probe:
        errs = probe_interp_errors(
            row_fn, grids, dtype, block=block,
            rows_are_intensity=probe_rows_are_intensity)
        if not probe_is_fit_grade(errs):
            import logging
            logging.getLogger("mcsas_tpu").info(
                "param table declined by interpolation probe (median "
                "%.2g, p90 %.2g vs contract %g/%g at 2x margin) — "
                "falling back to in-loop quadrature",
                float(np.median(errs)), float(np.percentile(errs, 90)),
                FIT_GRADE_MEDIAN, FIT_GRADE_P90)
            if key is not None:
                _TABLE_CACHE[key] = _DECLINED
            return None
    if grids:
        mesh = np.meshgrid(*grids, indexing="ij")
        pts = np.stack([m.ravel() for m in mesh], axis=-1)
    else:
        pts = np.zeros((1, 0))
    n_rows = len(pts)
    pad = (-n_rows) % block
    if pad:
        pts = np.concatenate([pts, np.repeat(pts[-1:], pad, axis=0)])
    fn = jax.jit(jax.vmap(row_fn))
    rows = [fn(jnp.asarray(pts[i:i + block], dtype))
            for i in range(0, len(pts), block)]
    values = jnp.concatenate(rows, axis=0)[:n_rows]
    axes = []
    for g in grids:
        lg = np.log(g)
        dl = float((lg[-1] - lg[0]) / max(len(g) - 1, 1))
        axes.append((float(lg[0]), dl if dl > 0 else 1.0, len(g)))
    table = _cast(ParamTable(values=values, axes=tuple(axes)))
    if key is not None:
        _TABLE_CACHE[key] = table
        _disk_cache_store(disk_path, table)
    return table


def lookup_param_table(table: ParamTable, pvals):
    """Multilinear row blend at scalar parameter values ``pvals`` (one per
    table axis, traced scalars); returns the (Nq,) row.  Clamped to the
    table domain."""
    dt = table.values.dtype
    idx0 = jnp.zeros((), jnp.int32)
    stride = 1
    corners = [(idx0, jnp.ones((), dt))]
    # build corner (index, weight) pairs axis by axis, last axis fastest
    for (l0, dl, n), v in zip(reversed(table.axes), reversed(list(pvals))):
        if n == 1:
            stride *= n
            continue
        f = (jnp.log(jnp.maximum(jnp.asarray(v, dt), 1e-300)) - l0) / dl
        f = jnp.clip(f, 0.0, n - 1.000001)
        i = jnp.floor(f).astype(jnp.int32)
        w = (f - i).astype(dt)
        corners = [(c + i * stride, cw * (1.0 - w)) for c, cw in corners] \
            + [(c + (i + 1) * stride, cw * w) for c, cw in corners]
        stride *= n
    out = None
    for c, cw in corners:
        row = jnp.take(table.values, c, axis=0, mode="clip") * cw
        out = row if out is None else out + row
    return out


def make_lookup(axes, tab_params):
    """Returns ``fn(values, pdict) -> (Nq,)`` with only the *static* axis
    metadata closed over — the (potentially large) ``values`` array stays
    a jit ARGUMENT, so engine executables are shared across datasets
    instead of recompiling per baked table."""
    def fn(values, pdict):
        tab = ParamTable(values=values, axes=axes)
        return lookup_param_table(tab, [pdict[n] for n in tab_params])
    return fn


def probe_interp_errors(row_fn, grids, dtype=jnp.float32, n_probe: int = 8,
                        seed: int = 7, rows_are_intensity: bool = False,
                        block: int = 64) -> np.ndarray:
    """Bake-time soundness probe: per-element intensity-weighted relative
    errors of PRODUCTION-SPACING multilinear interpolation at random
    off-grid points, measured BEFORE paying for the full bake.

    Some row functions are not interpolable at any sane resolution: the
    legacy ψ-grid cylinder variants preserve the reference's wedge /
    in-plane orientation rules (models/cylinders.py), whose rows
    oscillate along the parameter axes with phase ~q·L — at
    q_max·L_max ≫ n_nodes the table aliases pure noise (measured:
    doubling the radius axis 512→1024 left p90 error at 0.73).  The
    probe evaluates, for each of *n_probe* log-uniform interior points,
    the exact row and the multilinear blend of the 2^P surrounding
    grid-corner rows, and returns the flat array of the same error
    metric the accuracy tests use (|Δff²| / (ff² + 1e-6·rowmax)).
    Cost: n_probe·(2^P + 1) row evaluations — negligible next to the
    bake."""
    grids = [np.asarray(g, np.float64) for g in grids]
    if not grids:
        return np.zeros(1)
    rng = np.random.default_rng(seed)
    lgs = [np.log(g) for g in grids]
    pts, corner_sets, weight_sets = [], [], []
    for _ in range(n_probe):
        # an interior point, uniform in log within a random grid cell
        idx = [rng.integers(0, len(g) - 1) if len(g) > 1 else 0
               for g in grids]
        fr = rng.uniform(0.25, 0.75, len(grids))
        lp = [lg[i] + f * (lg[min(i + 1, len(lg) - 1)] - lg[i])
              for lg, i, f in zip(lgs, idx, fr)]
        pts.append(np.exp(lp))
        corners, weights = [[]], [1.0]
        new_c, new_w = [], []
        for k, (lg, i, f) in enumerate(zip(lgs, idx, fr)):
            if len(lg) == 1:
                new_c = [c + [lg[0]] for c in corners]
                new_w = list(weights)
            else:
                new_c = ([c + [lg[i]] for c in corners]
                         + [c + [lg[i + 1]] for c in corners])
                new_w = ([w * (1.0 - f) for w in weights]
                         + [w * f for w in weights])
            corners, weights = new_c, new_w
        corner_sets.append(np.exp(np.asarray(corners)))
        weight_sets.append(np.asarray(weights))
    eval_pts = np.concatenate([np.asarray(pts)]
                              + [cs for cs in corner_sets], axis=0)
    n_eval = len(eval_pts)
    # pad to the bake's block size so the probe and the bake share ONE
    # jitted executable (cold-start compile budget)
    pad = (-n_eval) % block
    if pad:
        eval_pts = np.concatenate(
            [eval_pts, np.repeat(eval_pts[-1:], pad, axis=0)])
    fn = jax.jit(jax.vmap(row_fn))
    rows = np.concatenate(
        [np.asarray(fn(jnp.asarray(eval_pts[i:i + block], dtype)),
                    np.float64)
         for i in range(0, len(eval_pts), block)], axis=0)[:n_eval]
    exact_rows, corner_rows = rows[:n_probe], rows[n_probe:]
    errs = []
    off = 0
    for i in range(n_probe):
        ws = weight_sets[i]
        blend = (corner_rows[off:off + len(ws)] * ws[:, None]).sum(axis=0)
        off += len(ws)
        if rows_are_intensity:          # smeared tables store ff²·w
            e2, a2 = exact_rows[i], blend
        else:                           # amplitude rows: compare ff²
            e2, a2 = exact_rows[i] ** 2, blend ** 2
        floor = 1e-6 * max(e2.max(), 1e-300)
        errs.append(np.abs(a2 - e2) / (np.abs(e2) + floor))
    return np.concatenate(errs)


# Fit-grade interpolation contract (the accuracy tests assert exactly
# this on random points); the factory engagement check applies it to the
# probe with a 2x safety margin so engaged tables pass with headroom.
FIT_GRADE_MEDIAN = 1e-3
FIT_GRADE_P90 = 5e-2


def probe_is_fit_grade(errs: np.ndarray, margin: float = 2.0) -> bool:
    """True when probe errors meet the fit-grade contract with *margin*
    (see probe_interp_errors).  MCSAS_TPU_TABLE_PROBE=off bypasses the
    check (always engage), =strict sets margin 1."""
    import os
    mode = os.environ.get("MCSAS_TPU_TABLE_PROBE", "")
    if mode == "off":
        return True
    if mode == "strict":
        margin = 1.0
    return bool(np.median(errs) <= FIT_GRADE_MEDIAN / margin
                and np.percentile(errs, 90) <= FIT_GRADE_P90 / margin)


def param_product_range(bound, name_or_value) -> tuple:
    """(lo, hi) of one parameter: its sampling range if active, else the
    fixed value as a degenerate range."""
    if name_or_value in bound.active:
        return bound.ranges[bound.active.index(name_or_value)]
    for n, v in bound.fixed:
        if n == name_or_value:
            return (v, v)
    raise KeyError(name_or_value)
