# -*- coding: utf-8 -*-
"""The Monte-Carlo fitting engine: reference McSAS.mcFit/analyse rebuilt as
a chunked ``lax.scan`` over a fixed-shape device state.

Reference control flow (src/mcsas/mcsas/mcsas.py:287-439): a Python while
loop mutating one contribution at a time — two single-contribution model
evaluations plus a scipy LM fit per iteration, sequentially over up to 1e5
iterations × numReps repetitions (:191-285).  The accelerator recast:

* Per repetition the state carries the full per-contribution intensity
  bank ``ibank`` (N × Nq, float32, ~150 KB), so the
  incremental total update is ``ft − ibank[ri] + I(rt)``: *one* kernel row
  evaluation per step instead of the reference's two (the old row is
  cached; mcsas.py:360-371 recomputes it).
* The scale/background LM fit becomes the closed-form solve of
  :mod:`fitcore` — exact, fused into the step.
* The data-dependent ``while χ² > crit`` becomes a *chunked* scan: a jitted
  ``lax.scan`` of ``chunk_steps`` masked steps, with convergence / retry /
  abort decisions on the host between chunks (bounded wasted work, same
  semantics as the reference's loop + retry at mcsas.py:214-246).
* The numReps uncertainty ensemble is batched inside the scan body and, on
  a device mesh, sharded over the "rep" axis (zero-communication data
  parallelism — see :mod:`mcsas_tpu.parallel`).
* Intensities are computed with the weight normalized by a host-side
  float64 reference volume (w/w_ref): float32 never touches the ~1e-32 SI
  magnitudes, and the fitted scale absorbs the factor exactly.

Latency design (the sequential chain is the whole performance story —
SURVEY §7 "hard parts"):

* proposals for an entire chunk are drawn in ONE batched threefry call
  before the scan — no per-step RNG chain;
* the contribution cursor ``ri`` advances deterministically and is carried
  as a single *unbatched* scalar shared by all repetitions, so every bank
  update lowers to a true ``dynamic_update_slice`` — a vmapped per-rep
  cursor would lower each of the five state writes to a scatter;
* ``candidates_per_step`` (K) proposals for the same slot are evaluated
  as one batched kernel row + K-row reduction, and the best
  improving candidate is accepted: per-slot proposal density and accept
  criterion are identical to K reference iterations on that slot at one
  step's latency.

Float discipline: ``ft`` is refreshed from the bank at every chunk
boundary, so incremental float32 drift is bounded to one chunk (the
reference worries about the same drift in float64, mcsas.py:365-366).
"""
from __future__ import annotations

import contextlib
import logging
import math
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import McSASConfig
from ..data import SASData
from ..models.base import BoundModel
from ..ops.precision import dot
from .fitcore import FitConstants, make_constants, solve_scale_bg
from .rng import draw_params

log = logging.getLogger(__name__)


class RepState(NamedTuple):
    """Per-repetition MC state; batched with a leading rep axis.

    The contribution cursor is NOT part of this state: it is deterministic
    and shared across repetitions (see module docstring), carried
    separately as an unbatched scalar.
    """
    key: jax.Array       # per-rep PRNG key
    rset: jax.Array      # (N, P) contribution parameters, SI
    ibank: jax.Array     # (N, Nq) per-contribution intensities (normalized)
    ft: jax.Array        # (Nq,) total intensity
    scale: jax.Array     # fitted A (normalized-intensity units)
    background: jax.Array
    conval: jax.Array    # current reduced χ²
    n_iter: jax.Array    # proposals consumed this attempt (int32)
    n_moves: jax.Array   # accepted moves (int32)


@dataclass
class EngineResult:
    """Raw engine output for one ensemble run (numpy, host)."""
    contribs: np.ndarray      # (R, N, P) SI
    conval: np.ndarray        # (R,)
    n_iter: np.ndarray        # (R,)
    n_moves: np.ndarray       # (R,)
    attempts: np.ndarray      # (R,) mcFit attempts used
    converged: np.ndarray     # (R,) bool
    scaling: np.ndarray       # (R,) scale in SI intensity units
    background: np.ndarray    # (R,)
    measval: np.ndarray       # (R, Nq) fitted model curve A·I+b (data units)
    w_ref: float              # weight normalization used on device
    elapsed: float            # seconds
    iters_per_sec: float
    moves_per_sec: float
    # which execution tier actually ran (vs static eligibility)
    used_pallas: bool = False
    used_table: bool = False
    # accumulated over ALL attempts (retried repetitions included) — the
    # per-rep n_iter above resets on retry, so this is the auditable
    # total a trajectory regression cannot hide behind
    total_iters: int = 0

    @property
    def num_reps(self) -> int:
        return self.contribs.shape[0]


def local_candidates(cur, uniforms, lo, hi, local_scale):
    """Local-move proposal transform: the slot's current value scaled by
    exp of a symmetric uniform, clipped to the active ranges.

    SHARED bitwise by the scan path (`McSASEngine._step`) and the GPU
    kernel's chunk builder (`ops.mc_kernel.build_chunk_fn`) — the
    kernel's correctness contract is the scan path's proposal stream, so
    both paths must run these exact operations.

    *cur* is (..., P); *uniforms* is (..., k_local, P) unit uniforms.
    """
    factor = jnp.exp((2.0 * uniforms - 1.0) * local_scale)
    return jnp.clip(cur[..., None, :] * factor, lo, hi)


def magnitude_probe(bound: BoundModel, probe_grid, two_d_psi=None):
    """Float64 form-factor-magnitude normalization probe at the geometric
    midpoint of the active ranges: i_ref = max |ff²| on the given grid.

    The form factor can carry huge constant factors (core-shell SLD
    differences are ~1e14 SI, squaring to ~1e28) which overflow float32
    just as SI volume weights underflow it; scaling device rows by
    1/i_ref keeps them O(1), and the fitted scale absorbs the factor
    exactly.  Shared by the engine's hot-loop normalization and the
    accelerator-assisted post tier (post/histogram.py::_accel_bank)."""
    mids = np.asarray([np.sqrt(max(lo, 1e-300) * hi) if hi > 0 else lo
                       for lo, hi in bound.ranges], np.float64)
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    with jax.default_device(cpu) if cpu else contextlib.nullcontext():
        probe_grid = np.asarray(probe_grid, np.float64)
        # one jitted call instead of one dispatch per op
        if two_d_psi is not None:
            ffp = np.asarray(jax.jit(
                lambda q, psi, v: bound.model.ff2d(q, psi, bound.pdict(v))
            )(jnp.asarray(probe_grid), jnp.asarray(two_d_psi),
              jnp.asarray(mids)))
        else:
            ffp = np.asarray(jax.jit(bound.ff)(jnp.asarray(probe_grid),
                                               jnp.asarray(mids)))
        probe = np.abs(ffp * ffp)
    i_ref = float(np.nanmax(probe))
    if not np.isfinite(i_ref) or i_ref <= 0.0:
        i_ref = 1.0
    return i_ref


def make_intensity_kernels(bound: BoundModel, data: SASData,
                           cfg: McSASConfig, dtype, allow_table=True,
                           table_grid_width_only=False):
    """Builds the intensity-row kernel for the fit grid.

    intensity_row(grid, pvec) -> (Nq,): F²·(w/w_ref)/i_ref, optionally
    smeared via the precomputed contraction (reference smearing path:
    src/mcsas/bases/model/sasmodel.py:46-79).  The grid is an explicit
    argument so a shard_map caller can pass the q-axis shard local to each
    device.

    *table_grid_width_only* accepts only tables whose rows live on the
    fit grid itself (one value column per q point) — the layout a
    q-axis shard can column-slice.  Tables on a different inner grid
    (Kholodenko's smeared flattened-locs rows, contracted inside the
    lookup) are rejected and the engine falls back to the quadrature
    kernel.
    """
    comp_exp = cfg.compensation_exponent
    v_ref = bound.reference_volume()
    # 2D (q, ψ) fitting: the grid carries both coordinates as columns and
    # the kernel is the model's anisotropic ff2d (see models/base.py)
    two_d = data.psi is not None and bound.model.ff2d is not None
    if two_d and data.uses_smearing and bound.model.can_smear:
        log.warning("2D (q, psi) fitting ignores the smearing config: "
                    "the anisotropic kernel has no smeared variant")
    smearing = (data.uses_smearing and bound.model.can_smear
                and not two_d)
    if smearing:
        # the contraction vector rides the grid pytree as a jit argument
        # (a closure constant would key compiles on the dataset's beam
        # profile — a fresh compile per file in a series run)
        full_grid = (jnp.asarray(data.locs, dtype),
                     jnp.asarray(data.smear_w, dtype))
    elif two_d:
        full_grid = jnp.asarray(
            np.column_stack([data.q, data.psi]), dtype)
    else:
        full_grid = jnp.asarray(data.q, dtype)

    def weight_norm(pvec):
        return (bound.volume(pvec) / v_ref) ** (2.0 * comp_exp)

    # second normalization: see magnitude_probe (converted back to SI in
    # EngineResult.scaling)
    i_ref = magnitude_probe(bound, data.locs if smearing else data.q,
                            two_d_psi=data.psi if two_d else None)
    inv_i_ref = 1.0 / i_ref

    # fit-grade form factor when the model provides one (e.g. Kholodenko's
    # coarse quadrature): the float32 MC loop trades ~1e-3 kernel accuracy
    # for several-fold throughput; all float64 analysis uses the full ff
    model_ff = bound.model.ff
    if (jnp.dtype(dtype) == jnp.float32
            and bound.model.ff_fast is not None):
        model_ff = bound.model.ff_fast
    # parameter-grid row table (ops/tables.py): replaces the quadrature
    # with a multilinear row blend — strictly the fastest fit-grade tier.
    # Rows are baked against THIS fit grid — including, for smeared fits,
    # against the dataset's own smearing contraction: the rows then store
    # the smeared INTENSITY (ff²(locs) @ smear_w) directly and the
    # lookup's result skips the squaring (reference smearing path:
    # src/mcsas/bases/model/sasmodel.py:56-73).  Still disabled for
    # q-axis shards (each device would need its own bake) and 2D.
    # The table VALUES join the grid pytree as a jit *argument* — baking
    # them into the executable as closure constants would force a fresh
    # compile per dataset.
    used_table = False
    table_fn = None
    table_is_intensity = False
    factory = bound.model.ff_table_factory
    if smearing and factory is not None:
        # plugin factories predating the smear tier keep working: only
        # call them smeared if they declare the keyword
        import inspect
        try:
            has_smear = "smear" in inspect.signature(factory).parameters
        except (TypeError, ValueError):
            has_smear = False
        factory = factory if has_smear else None
    if (jnp.dtype(dtype) == jnp.float32
            and factory is not None
            and not two_d
            and allow_table
            and cfg.table_ff_enabled()):
        kw = {}
        if smearing:
            kw["smear"] = (np.asarray(data.locs, np.float64),
                           np.asarray(data.smear_w, np.float64))
        table_ret = factory(
            bound, np.asarray(data.q, np.float64), dtype, **kw)
        if table_ret is not None:
            if len(table_ret) == 3:
                table_fn, table_values, kind = table_ret
                table_is_intensity = kind == "intensity"
            else:
                table_fn, table_values = table_ret
            if (table_grid_width_only
                    and int(table_values.shape[1])
                    != int(np.asarray(data.q).shape[0])):
                # rows not on the fit grid: a q shard cannot
                # column-slice them — quadrature kernel instead
                table_fn = None
                table_is_intensity = False
            else:
                used_table = True
                # smeared tables keep (locs, smear_w) as the inner grid
                # so a partially-tabulated lookup (e.g. Kholodenko's
                # exact q-axis cross-section factor) can finish the
                # contraction in-kernel
                full_grid = (full_grid, jnp.asarray(table_values))

    # float32 overflow guard: candidate rows at extreme range corners can
    # reach (v/v_ref)^(2c)·(ff/ff_ref)² ≈ 1e20, and the solve's Σu·x²
    # then overflows float32 (inf/inf → NaN scale), killing the whole
    # repetition.  Such candidates are astronomically unfittable anyway,
    # so clamping the row magnitude below the overflow threshold changes
    # no accept decision — it only keeps their χ² finite (huge).
    sigma = np.asarray(data.fu, np.float64).copy()
    sigma[sigma == 0.0] = 1.0
    u_max = float(np.max(1.0 / sigma ** 2))
    n_grid = float(np.asarray(data.q).shape[0])
    # budget divided by num_contribs: ft sums N rows, so even with EVERY
    # contribution parked at the clamp the total Σu·ft² stays below the
    # float32 overflow threshold (a single-row budget can still NaN the
    # solve at initialization with extreme ranges)
    row_clamp = math.sqrt(3e37 / (max(u_max, 1e-300) * n_grid)) \
        / max(float(cfg.num_contribs), 1.0)
    row_clamp = max(row_clamp, 1e3)   # stay far above the working range

    def intensity_row(grid, pvec):
        w = weight_norm(pvec) * inv_i_ref
        # normalize at AMPLITUDE level, i.e. (ffv·√w)² rather than
        # ffv²·w: raw |ff|² alone can underflow float32 (and 1/i_ref
        # alone overflow it — e.g. the dimensionless tilted cylinder on
        # an SI q grid: ffv ~ 1e-21, 1/i_ref ~ 1e41), while the
        # amplitude-scaled product is O(1) by construction of the probe
        s = jnp.sqrt(w)
        if used_table:
            gq, tvals = grid
            ffv = table_fn(gq, tvals, bound.pdict(pvec))
            if table_is_intensity:
                row = ffv * w
            else:
                fs = ffv * s
                row = fs * fs
        elif two_d:
            fs = bound.model.ff2d(grid[:, 0], grid[:, 1],
                                  bound.pdict(pvec)) * s
            row = fs * fs
        elif smearing:
            locs, sw = grid
            fs = model_ff(locs, bound.pdict(pvec)) * s
            row = dot(fs * fs, sw)
        else:
            fs = model_ff(grid, bound.pdict(pvec)) * s
            row = fs * fs
        return jnp.minimum(row, row_clamp)

    return (intensity_row, full_grid, v_ref ** (2.0 * comp_exp) * i_ref,
            used_table)


class McSASEngine:
    """Compiled MC fitter for one (data, model, config) triple.

    Reusable across runs (retries, series fits over same-shaped data): all
    jitted functions are built once in __init__.

    *interpret* runs the GPU chunk kernel in the Pallas interpreter, so
    tests can exercise it on the CPU; ``use_pallas='auto'`` then selects
    it on any device.
    """

    # subclasses may veto the table tier outright (_allow_table False)
    # or restrict it to tables whose rows are on the fit grid itself
    # (_table_grid_width_only — the layout a q-axis shard can
    # column-slice; see make_intensity_kernels)
    _allow_table = True

    def __init__(self, data: SASData, bound: BoundModel, cfg: McSASConfig,
                 sharding=None, interpret: bool = False):
        if data.count < 1:
            raise ValueError("no data points on the fit grid")
        for name, (lo, hi) in zip(bound.active, bound.ranges):
            if not (np.isfinite(lo) and np.isfinite(hi)):
                raise ValueError(
                    f"active range of {name!r} is not finite ({lo}, {hi}); "
                    "set active_ranges when binding the model (fit() "
                    "defaults unbounded ranges to the data size estimate)")
        self.data = data
        self.bound = bound
        self.cfg = cfg
        self.dtype = jnp.dtype(cfg.dtype)
        self.sharding = sharding
        self.n_contribs = cfg.num_contribs
        self.consts: FitConstants = make_constants(data.f, data.fu,
                                                   self.dtype)
        (self._intensity_row, self.grid, self.w_ref,
         self.uses_table) = make_intensity_kernels(
             bound, data, cfg, self.dtype,
             allow_table=getattr(self, "_allow_table",
                                 type(self)._allow_table),
             table_grid_width_only=getattr(
                 self, "_table_grid_width_only", False))

        # dtype-preservation guard (abstract eval — free): a float64
        # numpy scalar leaking out of a model kernel or table lookup
        # would silently upcast the whole MC hot loop under x64 (2× HBM,
        # and the Pallas kernels' io-alias check rejects the state)
        row_t = jax.eval_shape(
            self._intensity_row, self.grid,
            jax.ShapeDtypeStruct((bound.n_active,), self.dtype))
        if row_t.dtype != self.dtype:
            raise TypeError(
                f"{bound.model.name}: intensity row is {row_t.dtype} for "
                f"a {self.dtype} engine — a kernel constant is promoting "
                "the hot-loop dtype (cast model/table constants to the "
                "argument dtype)")

        self._interpret = interpret
        self.uses_pallas = self._select_kernel()
        if self.uses_pallas:
            from ..ops.mc_kernel import padded_len
            self._pad_fit_grid(padded_len(self._fit_grid_len()))

        # prewarm plan: (label, jit object, args builder) for every
        # executable in this engine's launch plan — prewarm() AOT-compiles
        # them (populating the persistent compile cache) without running
        # the MC.  Builders receive (keys, state_avals, ri) examples.
        self._prewarm_plan = []

        # grid/consts are jit *arguments*, not baked closure constants:
        # the compiled executables are shared across datasets with the
        # same shapes (and hit the persistent compile cache)
        _init = jax.jit(lambda keys, grid, consts: jax.vmap(
            lambda k: self._init_rep(k, grid, consts))(keys))
        self._init_batch = lambda keys: _init(keys, self.grid, self.consts)
        self._prewarm_plan.append(
            ("init", _init, lambda k, s, ri: (k, self.grid, self.consts)))
        if self.uses_pallas:
            from ..ops.mc_kernel import build_chunk_fn
            _kernel_chunk = build_chunk_fn(self, interpret=interpret)
            # the kernel bakes its (padded) grid/consts, so its
            # executables are per-dataset; the uniform arg signature
            # lets the drive stay shareable for the XLA path
            self._chunk_impl = lambda state, ri, grid, consts: \
                _kernel_chunk(state, ri)
            self._chunk_batch = _kernel_chunk
            self._prewarm_plan.append(
                ("chunk", _kernel_chunk, lambda k, s, ri: (s, ri)))
        else:
            _chunk = jax.jit(self._run_chunk_batched)
            self._chunk_impl = _chunk
            self._chunk_batch = lambda state, ri: _chunk(
                state, ri, self.grid, self.consts)
            self._prewarm_plan.append(
                ("chunk", _chunk,
                 lambda k, s, ri: (s, ri, self.grid, self.consts)))
        self._reinit_merge = jax.jit(self._merge_reinit)

        # result packer: every field the host reads, flattened into ONE
        # float32 buffer (counters bit-cast) that rides the drive launch,
        # so the host fetches a single array per outer iteration
        n_r, n_c, n_p = cfg.num_reps, self.n_contribs, bound.n_active

        def pack_result(state):
            f32 = jnp.float32
            bc = jax.lax.bitcast_convert_type
            return jnp.concatenate([
                state.rset.reshape(n_r, -1).astype(f32),
                state.ft.astype(f32),
                state.scale.astype(f32)[:, None],
                state.background.astype(f32)[:, None],
                state.conval.astype(f32)[:, None],
                bc(state.n_iter, f32)[:, None],
                bc(state.n_moves, f32)[:, None]], axis=1)

        self._fast_pack = self.dtype == jnp.float32
        self._pack_fn = pack_result if self._fast_pack else None
        self._pack = jax.jit(pack_result) if self._fast_pack else None
        if self._pack is not None:
            self._prewarm_plan.append(
                ("pack", self._pack, lambda k, s, ri: (s,)))

        def unpack_result(arr):
            arr = np.asarray(arr)
            o1 = n_c * n_p
            o2 = arr.shape[1] - 5   # ft width follows any later padding
            return dict(
                rset=arr[:, :o1].astype(np.float64).reshape(n_r, n_c,
                                                            n_p),
                ft=arr[:, o1:o2].astype(np.float64),
                scale=arr[:, o2].astype(np.float64),
                background=arr[:, o2 + 1].astype(np.float64),
                conval=arr[:, o2 + 2].astype(np.float64),
                n_iter=arr[:, o2 + 3].copy().view(np.int32).astype(
                    np.float64),
                n_moves=arr[:, o2 + 4].copy().view(np.int32).astype(
                    np.float64))

        self._unpack = unpack_result

        # single-launch driver: a device-side while_loop over chunks runs
        # one whole attempt without a host round trip per chunk (see
        # _build_drive for the tiers)
        self._drive = None
        fast_body = (self.uses_pallas
                     or (bound.model.elementwise_q and not self.uses_table))
        # grid/consts stay jit ARGUMENTS through the drive (sharing
        # executables across datasets on the XLA path); the packed
        # result buffer rides the same launch
        drive = self._build_drive(self._chunk_impl, fast_body)
        if drive is not None:
            _drive = jax.jit(drive)
            self._drive = lambda state, ri: _drive(
                state, ri, self.grid, self.consts)
            self._prewarm_plan.append(
                ("drive", _drive,
                 lambda k, s, ri: (s, ri, self.grid, self.consts)))

            # first attempt fused with initialization: seed → keys →
            # init + whole-attempt while_loop in ONE device launch
            def init_drive(seed, grid, consts):
                keys = jax.random.split(
                    jax.random.PRNGKey(seed), cfg.num_reps)
                state = jax.vmap(
                    lambda k: self._init_rep(k, grid, consts))(keys)
                return drive(state, jnp.zeros((), jnp.int32), grid, consts)

            _init_drive = jax.jit(init_drive)
            self._init_drive = lambda seed: _init_drive(
                seed, self.grid, self.consts)
            self._prewarm_plan.append(
                ("init-drive", _init_drive,
                 lambda k, s, ri: (cfg.seed, self.grid, self.consts)))
        else:
            self._init_drive = None

    def prewarm(self) -> dict:
        """AOT-compiles every executable in this engine's launch plan
        WITHOUT running the MC.

        Compiled programs land in the persistent compile cache, so
        prewarming — in this process, or once per dataset shape in any
        earlier process — moves the compile cost out of the user's
        first timed fit.  Parameter-table bakes
        already happened in ``__init__`` (and persist via
        MCSAS_TPU_TABLE_CACHE_DIR).  Entry points:
        ``fit(..., prewarm=True)`` and the CLI ``--prewarm`` flag.

        Returns {executable label: seconds} (a string marks a skip).
        """
        keys = jax.random.split(jax.random.PRNGKey(self.cfg.seed),
                                self.cfg.num_reps)
        state = jax.eval_shape(self._init_batch, keys)
        ri = jnp.zeros((), jnp.int32)
        timings = {}
        for label, fn, build in self._prewarm_plan:
            t0 = time.perf_counter()
            try:
                fn.lower(*build(keys, state, ri)).compile()
            except Exception as e:   # pragma: no cover - diagnostics only
                timings[label] = f"skipped: {type(e).__name__}: {e}"[:120]
                continue
            timings[label] = round(time.perf_counter() - t0, 3)
        log.info("prewarm compiled %d executables: %s",
                 len(self._prewarm_plan), timings)
        return timings

    def _build_drive(self, chunk_fn, fast_body):
        """Single-launch drive builder — ONE implementation shared by the
        unsharded engine and :class:`~..parallel.spmd.ShardedEnsemble`
        (the round-4 aliasing bugs showed how expensive divergence in
        exactly this machinery is).

        Tier selection + the device-side while_loop over chunks + the
        packed-result fetch: FAST bodies (*fast_body* — the GPU kernel,
        elementwise XLA) run one UNBOUNDED while_loop per attempt; table
        bodies run a BOUNDED loop of at most 32 chunks per launch, after
        which the host checks convergence and launches again; anything
        else (quadrature-heavy, no table) returns None and the caller
        keeps the host chunk loop.

        *chunk_fn(state, ri, \\*args) -> (state, ri)*; extra ``*args``
        pass through the returned ``drive(state, ri, *args) ->
        (state, ri, packed)`` unchanged (the XLA path threads
        grid/consts as jit arguments so executables are shared across
        datasets; the sharded path closes over its shard_map'd chunk and
        passes none).
        """
        if not (fast_body or self.uses_table):
            return None
        drive_trips = None if fast_body else 32
        crit = float(self.cfg.convergence_criterion)
        max_it = self.cfg.max_iterations

        def live(s):
            return jnp.any((s.conval > crit) & (s.n_iter < max_it))

        def drive_loop(state, ri, *args):
            if drive_trips is None:
                return jax.lax.while_loop(
                    lambda carry: live(carry[0]),
                    lambda carry: chunk_fn(*carry, *args), (state, ri))

            def running(carry):
                (s, _), trip = carry
                return (trip < drive_trips) & live(s)

            def body(carry):
                (s, ri_c), trip = carry
                return chunk_fn(s, ri_c, *args), trip + 1

            (state, ri), _ = jax.lax.while_loop(
                running, body, ((state, ri), jnp.zeros((), jnp.int32)))
            return state, ri

        pack = self._pack_fn

        def drive(state, ri, *args):
            state, ri = drive_loop(state, ri, *args)
            packed = (pack(state) if pack is not None
                      else jnp.zeros((), jnp.float32))
            return state, ri, packed

        return drive

    def _select_kernel(self) -> bool:
        """True when this engine runs the GPU chunk kernel, False for the
        XLA scan path.

        ``use_pallas='auto'`` takes the kernel for eligible models when
        the compute device is a GPU; ``'on'`` requires both and raises
        otherwise.  Subclasses (the sharded ensemble) choose their own.
        """
        mode = self.cfg.use_pallas
        if mode == "off" or type(self) is not McSASEngine:
            return False
        from ..ops import mc_kernel
        ok = mc_kernel.eligible(self)
        platform = self._compute_device().platform
        on_gpu = self._interpret or platform == "gpu"
        if mode == "on":
            if not on_gpu:
                raise ValueError(
                    f"use_pallas='on' needs a GPU compute device, not "
                    f"{platform!r}")
            if not ok:
                raise ValueError("use_pallas='on' but this model/config "
                                 "is not eligible for the GPU kernel")
        return ok and on_gpu

    @staticmethod
    def _compute_device():
        """The device arrays will actually land on (honors any
        jax_default_device override, e.g. tests pinning to CPU)."""
        dev = jax.config.jax_default_device
        return dev if dev is not None else jax.devices()[0]

    def _fit_grid_len(self) -> int:
        """Length of the fit grid's q axis (padding included)."""
        main = self.grid
        while isinstance(main, tuple):   # table/smeared grids nest tuples
            main = main[0]
        return int(main.shape[0])

    def _pad_fit_grid(self, length: int):
        """Pads the fit grid to *length* points with zero-weight points
        (invisible to every reduction; measval is sliced back to
        data.count in run()).

        For a tuple grid (smearing: (locs, smear_w)) only the q-axis
        leaf is padded.  Table grids ((q|(locs, smear_w)), values) pad
        the baked VALUES along their q axis with zeros — the table
        lookup never reads the q leaf, so zero rows in the pad lanes
        plus u = 0 keep them invisible to every reduction.
        """
        grid = self.grid
        nq = self._fit_grid_len()
        pad = length - nq
        if pad <= 0:
            return
        if self.uses_table:
            inner, values = grid
            if int(values.shape[1]) != nq:
                # e.g. Kholodenko's smeared table: rows live on the
                # FLATTENED locs grid and the lookup finishes the
                # contraction itself — zero-padding columns would corrupt
                # the reshape.  The kernel's eligibility gate
                # (mc_kernel.kind) excludes this layout, so reaching here
                # is a wiring bug: fail loudly.
                raise ValueError("cannot lane-pad a table whose rows are "
                                 "not on the fit grid")
            leaf = inner[0] if isinstance(inner, tuple) else inner
            leaf = jnp.concatenate(
                [leaf, jnp.repeat(leaf[-1:], pad, axis=0)], axis=0)
            inner = ((leaf,) + inner[1:] if isinstance(inner, tuple)
                     else leaf)
            values = jnp.concatenate(
                [values, jnp.zeros((values.shape[0], pad), values.dtype)],
                axis=1)
            self.grid = (inner, values)
        else:
            main = grid[0] if isinstance(grid, tuple) else grid
            main = jnp.concatenate(
                [main, jnp.repeat(main[-1:], pad, axis=0)], axis=0)
            self.grid = ((main,) + grid[1:] if isinstance(grid, tuple)
                         else main)
        c = self.consts
        zeros = jnp.zeros((pad,), c.y.dtype)
        self.consts = FitConstants(
            y=jnp.concatenate([c.y, zeros]),
            u=jnp.concatenate([c.u, zeros]),
            s_u=c.s_u, s_uy=c.s_uy, n=c.n)

    # ------------------------------------------------------------- build
    def _init_rep(self, key, grid=None, consts=None,
                  axis_name=None) -> RepState:
        grid = self.grid if grid is None else grid
        consts = self.consts if consts is None else consts
        cfg, bound = self.cfg, self.bound
        n = self.n_contribs
        key, sub = jax.random.split(key)
        if cfg.start_from_minimum:
            # deprecated reference option: start all contributions at half
            # the minimum of the active range (mcsas.py:310-315)
            mins = []
            for (lo, hi) in bound.ranges:
                if lo == 0.0:
                    lo = float(np.pi / self.data.q_limit[1])
                mins.append(0.5 * lo)
            rset = jnp.broadcast_to(
                jnp.asarray(mins, self.dtype), (n, bound.n_active))
        else:
            rset = draw_params(sub, bound, count=n, dtype=self.dtype)
        ibank = jax.vmap(lambda p: self._intensity_row(grid, p))(rset)
        ft = jnp.sum(ibank, axis=0)
        sol = solve_scale_bg(ft, consts, cfg.find_background,
                             cfg.positive_background, axis_name=axis_name)
        zero = jnp.zeros((), jnp.int32)
        return RepState(key=key, rset=rset, ibank=ibank, ft=ft,
                        scale=sol.scale, background=sol.background,
                        conval=sol.chisqr, n_iter=zero, n_moves=zero)

    def _step(self, state: RepState, cands, ri, grid=None, consts=None,
              axis_name=None) -> RepState:
        """One accept/reject move of one repetition (reference hot loop
        mcsas.py:354-404).

        *cands*: (K, P) pre-drawn proposals for this step's slot; the last
        ``k_local`` rows are UNIT uniforms turned into log-uniform
        perturbations of the slot's current value here (local-move mode).
        *ri*: scalar contribution cursor (shared across reps).
        """
        grid = self.grid if grid is None else grid
        consts = self.consts if consts is None else consts
        cfg = self.cfg
        k_cand = cfg.candidates_per_step
        crit = jnp.asarray(cfg.convergence_criterion, self.dtype)
        active = (state.conval > crit) & (state.n_iter < cfg.max_iterations)

        k_local = self._k_local()
        if k_local:
            lo, hi = self._range_bounds()
            cur = state.rset[ri]                                  # (P,)
            local_c = local_candidates(cur, cands[k_cand - k_local:],
                                       lo, hi, cfg.local_scale)
            cands = jnp.concatenate([cands[:k_cand - k_local], local_c],
                                    axis=0)

        i_cands = jax.vmap(
            lambda p: self._intensity_row(grid, p))(cands)       # (K, Nq)
        ft_base = state.ft - state.ibank[ri]
        ft_tests = ft_base[None, :] + i_cands
        sols = jax.vmap(
            lambda x: solve_scale_bg(x, consts, cfg.find_background,
                                     cfg.positive_background,
                                     axis_name=axis_name))(ft_tests)
        best = jnp.argmin(sols.chisqr)
        rt = cands[best]
        i_new = i_cands[best]
        sol = jax.tree_util.tree_map(lambda a: a[best], sols)
        accept = active & (sol.chisqr < state.conval)

        upd = jax.lax.dynamic_update_index_in_dim
        sel = lambda new, old: jnp.where(accept, new, old)  # noqa: E731
        rset = upd(state.rset, sel(rt, state.rset[ri]), ri, 0)
        ibank = upd(state.ibank, sel(i_new, state.ibank[ri]), ri, 0)
        return state._replace(
            rset=rset, ibank=ibank, ft=sel(ft_tests[best], state.ft),
            scale=sel(sol.scale, state.scale),
            background=sel(sol.background, state.background),
            conval=sel(sol.chisqr, state.conval),
            n_iter=state.n_iter + k_cand * active.astype(jnp.int32),
            n_moves=state.n_moves + accept.astype(jnp.int32))

    def _k_local(self) -> int:
        """Number of candidates per step drawn as local moves (static)."""
        return int(round(self.cfg.candidates_per_step
                         * self.cfg.local_moves))

    def _range_bounds(self):
        """(lo, hi) active-range bound vectors in the engine dtype."""
        lo = jnp.asarray([r[0] for r in self.bound.ranges], self.dtype)
        hi = jnp.asarray([r[1] for r in self.bound.ranges], self.dtype)
        return lo, hi

    def _draw_chunk_proposals(self, keys, n_steps=None):
        """Pre-draws all proposals for one chunk in one batched RNG call:
        (n_steps, R, K, P) from per-rep keys.  With local moves enabled
        the last k_local candidate rows hold unit uniforms (transformed by
        the step against the slot's current value)."""
        cfg = self.cfg
        n_steps = cfg.chunk_steps if n_steps is None else n_steps
        k_local = self._k_local()
        k_global = cfg.candidates_per_step - k_local
        p = self.bound.n_active

        def per_rep(key):
            kg, kl = jax.random.split(key)
            parts = []
            if k_global:
                parts.append(draw_params(
                    kg, self.bound, count=n_steps * k_global,
                    dtype=self.dtype).reshape(n_steps, k_global, p))
            if k_local:
                parts.append(jax.random.uniform(
                    kl, (n_steps, k_local, p), dtype=self.dtype))
            return jnp.concatenate(parts, axis=1)
        return jnp.swapaxes(jax.vmap(per_rep)(keys), 0, 1)

    def _run_chunk_batched(self, state: RepState, ri0, grid=None,
                           consts=None, axis_name=None):
        """chunk_steps masked steps over the batched ensemble; returns the
        advanced state and cursor."""
        # refresh totals from the bank: bounds float32 drift per chunk
        state = state._replace(ft=jnp.sum(state.ibank, axis=1))
        keys = jax.vmap(jax.random.split)(state.key)
        state = state._replace(key=keys[:, 0])
        proposals = self._draw_chunk_proposals(keys[:, 1])

        def body(carry, cands_t):
            s, ri = carry
            s = jax.vmap(
                lambda srep, c: self._step(srep, c, ri, grid, consts,
                                           axis_name))(s, cands_t)
            return (s, (ri + 1) % self.n_contribs), None

        (state, ri), _ = jax.lax.scan(body, (state, ri0), proposals)
        return state, ri

    def _merge_reinit(self, state: RepState, fresh: RepState, mask):
        """Replaces rows of the batched state where mask is True
        (retry semantics: reference mcsas.py:217-246 re-runs mcFit)."""
        def pick(new, old):
            m = mask.reshape((-1,) + (1,) * (old.ndim - 1))
            return jnp.where(m, new, old)
        return jax.tree_util.tree_map(pick, fresh, state)

    # --------------------------------------------------------------- run
    def run(self, stop: Optional[Callable[[], bool]] = None,
            progress: Optional[Callable[[dict], None]] = None
            ) -> EngineResult:
        """Runs the MC optimization (retries included)."""
        cfg = self.cfg
        n_reps = cfg.num_reps
        attempts = np.ones(n_reps, dtype=np.int64)
        retry_key = None                     # derived lazily (rare path)
        max_attempts = cfg.max_retries + 2   # reference retry budget
        total_iters = 0
        t0 = time.perf_counter()

        # without cooperative-abort/progress hooks, the whole attempt runs
        # as ONE device launch (while_loop over chunks) and the FIRST
        # attempt additionally fuses key derivation and initialization
        # into that launch
        drive_mode = (self._drive is not None and stop is None
                      and progress is None and self.sharding is None)
        step_fn = self._drive if drive_mode else self._chunk_batch
        packed = None
        if drive_mode:
            state, ri, packed = self._init_drive(cfg.seed)
            primed = True
        else:
            keys = jax.random.split(jax.random.PRNGKey(cfg.seed), n_reps)
            ri = jnp.zeros((), jnp.int32)
            state = self._init_batch(keys)
            if self.sharding is not None:
                state = jax.device_put(state, self.sharding)
            primed = False
        prev_iter = None
        while True:
            if not primed:
                if drive_mode:
                    state, ri, packed = step_fn(state, ri)
                else:
                    state, ri = step_fn(state, ri)
            primed = False
            # ONE fetch per outer iteration covering everything the host
            # ever needs — the convergence scalars now, the small result
            # fields if this turns out to be the last iteration (the
            # (R, N, Nq) intensity bank is never pulled), as one packed
            # float32 buffer riding the drive launch
            if self._fast_pack:
                if packed is None:
                    packed = self._pack(state)
                fetched = self._unpack(jax.device_get(packed))
                packed = None
            else:
                fetched = {
                    k: np.asarray(v, np.float64)
                    for k, v in jax.device_get(dict(
                        rset=state.rset, ft=state.ft, scale=state.scale,
                        background=state.background, conval=state.conval,
                        n_iter=state.n_iter,
                        n_moves=state.n_moves)).items()}
            conval = np.asarray(fetched["conval"], dtype=np.float64)
            n_iter = np.asarray(fetched["n_iter"], dtype=np.int64)
            converged = conval <= cfg.convergence_criterion
            # non-finite χ² (e.g. unbounded parameter ranges → inf
            # proposals) or a stalled counter can never converge: treat as
            # an exhausted attempt so the retry/abort budget applies
            # instead of looping forever (converged reps freeze their
            # counter legitimately and are excluded)
            stuck = ~np.isfinite(conval)
            if prev_iter is not None:
                stuck |= (n_iter == prev_iter) & ~converged
            prev_iter = n_iter.copy()
            if stuck.any():
                log.warning("%d repetition(s) made no progress "
                            "(non-finite chi2 or stalled proposals)",
                            int(stuck.sum()))
            exhausted = (n_iter >= cfg.max_iterations) | stuck
            running = ~converged & ~exhausted
            if progress is not None:
                progress(dict(conval=conval, n_iter=n_iter,
                              converged=converged, attempts=attempts))
            if stop is not None and stop():
                log.warning("stop requested, exiting MC loop")
                break
            need_retry = ~converged & exhausted & (attempts < max_attempts)
            if need_retry.any():
                total_iters += int(n_iter[need_retry].sum())
                if retry_key is None:
                    retry_key = jax.random.fold_in(
                        jax.random.PRNGKey(cfg.seed), 977)
                retry_key, sub = jax.random.split(retry_key)
                fresh = self._init_batch(
                    jax.random.split(sub, n_reps))
                state = self._reinit_merge(state, fresh,
                                           jnp.asarray(need_retry))
                attempts[need_retry] += 1
                prev_iter = None   # fresh attempt: counters restart
                log.warning("%d repetition(s) did not converge within "
                            "max_iterations; retrying (attempt %d/%d)",
                            int(need_retry.sum()),
                            int(attempts[need_retry].max()), max_attempts)
                continue
            if not running.any():
                break

        state_np = type(state)(
            key=None, ibank=None,
            **{k: np.asarray(v, dtype=np.float64) for k, v in
               fetched.items()})
        elapsed = time.perf_counter() - t0
        conval = state_np.conval
        n_iter = state_np.n_iter.astype(np.int64)
        # a cooperative abort only interrupts still-running repetitions;
        # any repetition whose χ² already reached the criterion genuinely
        # converged and is reported as such
        converged = conval <= cfg.convergence_criterion
        total_iters += int(n_iter.sum())
        n_moves = state_np.n_moves.astype(np.int64)
        measval = (state_np.scale[:, None] * state_np.ft
                   + state_np.background[:, None])[:, :self.data.count]
        return EngineResult(
            contribs=state_np.rset,
            conval=conval,
            n_iter=n_iter,
            n_moves=n_moves,
            attempts=attempts,
            converged=converged,
            scaling=state_np.scale / self.w_ref,
            background=state_np.background,
            measval=measval,
            w_ref=self.w_ref,
            elapsed=elapsed,
            iters_per_sec=total_iters / max(elapsed, 1e-9),
            moves_per_sec=int(n_moves.sum()) / max(elapsed, 1e-9),
            total_iters=total_iters,
            used_pallas=(self.uses_pallas
                         or getattr(self, "_pallas_shard", False)),
            used_table=self.uses_table,
        )
