# -*- coding: utf-8 -*-
"""SPMD ensemble execution: the MC engine over a ("rep", "q") device mesh.

The repetition ensemble shards over "rep" (pure data parallelism, no
communication); optionally the q grid shards over "q", in which case every
χ² reduction inside the hot loop completes with a ``psum`` over the
device interconnect.
Because each accept/reject decision depends on psum-complete scalars, all
q-shards of a repetition stay in lockstep by construction — the per-rep
PRNG key is replicated across the "q" axis so every shard proposes the
same candidate.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import McSASConfig
from ..core.engine import McSASEngine, RepState
from ..core.fitcore import FitConstants
from ..data import SASData
from ..models.base import BoundModel
from .mesh import make_mesh, pad_reps_for_mesh


def _state_specs() -> RepState:
    return RepState(
        key=P("rep"), rset=P("rep"), ibank=P("rep", None, "q"),
        ft=P("rep", "q"),
        scale=P("rep"), background=P("rep"), conval=P("rep"),
        n_iter=P("rep"), n_moves=P("rep"))


class ShardedEnsemble(McSASEngine):
    """McSASEngine whose ensemble runs SPMD over a device mesh."""

    # ParamTable rows are baked ONCE against the full (unsharded) fit
    # grid.  Values are one column per q point, so under q-axis sharding
    # each device simply takes its column shard — the row blend is
    # elementwise in q.  The only exclusion is tables whose rows are NOT
    # on the fit grid (Kholodenko's smeared flattened-locs layout,
    # contracted inside the lookup): a q shard cannot column-slice
    # those, so such models fall back to the quadrature kernel
    # (``table_grid_width_only`` in make_intensity_kernels).
    _allow_table = True

    def __init__(self, data: SASData, bound: BoundModel, cfg: McSASConfig,
                 mesh=None, mesh_shape=None, interpret: bool = False):
        self.mesh = mesh if mesh is not None else make_mesh(mesh_shape)
        self._table_grid_width_only = self.mesh.shape["q"] > 1
        self._orig_reps = cfg.num_reps
        cfg = cfg.replace(num_reps=pad_reps_for_mesh(cfg.num_reps,
                                                     self.mesh))
        super().__init__(data, bound, cfg, interpret=interpret)
        self.sharding = None  # parent device_put hook unused

        # the GPU chunk kernel applies when the q axis is unsharded and
        # the model is eligible: each device runs it on its local
        # repetition shard (pure data parallelism, no collectives).  The
        # selection rule is the unsharded engine's, against the MESH's
        # platform.
        from ..ops import mc_kernel
        n_rep_axis = self.mesh.shape["rep"]
        mesh_platform = self.mesh.devices.flat[0].platform
        kernel = False
        if cfg.use_pallas != "off":
            on_gpu = interpret or mesh_platform == "gpu"
            kernel = self.mesh.shape["q"] == 1 and mc_kernel.eligible(self)
            if cfg.use_pallas == "on" and not (on_gpu and kernel):
                raise ValueError(
                    "use_pallas='on' needs a GPU mesh with an unsharded q "
                    "axis and a kernel-eligible model")
            kernel = kernel and on_gpu
        self._pallas_shard = kernel
        if self._pallas_shard:
            self._pad_fit_grid(mc_kernel.padded_len(self._fit_grid_len()))

        # zero-weight padding points make the q length divisible by the
        # q-axis size (invisible to every reduction: u = 0)
        n_q = self.mesh.shape["q"]
        self._pad_fit_grid(-(-self._fit_grid_len() // n_q) * n_q)

        mesh = self.mesh
        specs = _state_specs()
        if self.uses_table:
            # (inner grid, baked table values): values are one column
            # per q point and shard along q with the grid (replicating
            # trivially on rep-only meshes)
            inner = self.grid[0]
            inner_spec = ((P("q", None), P()) if isinstance(inner, tuple)
                          else P("q"))
            grid_spec = (inner_spec, P(None, "q"))
        elif isinstance(self.grid, tuple):
            # smearing: (locs (Nq, nSteps) sharded along q, contraction
            # vector replicated)
            grid_spec = (P("q", None), P())
        elif self.grid.ndim == 1:
            grid_spec = P("q")
        else:
            grid_spec = P("q", None)
        consts_spec = FitConstants(y=P("q"), u=P("q"), s_u=P(), s_uy=P(),
                                   n=P())
        # always psum over "q" (identity for a singleton axis): keeps the
        # replication of accept decisions statically inferable by shard_map
        axis = "q"

        def init_local(keys, grid, consts):
            return jax.vmap(
                lambda k: self._init_rep(k, grid, consts, axis))(keys)

        def chunk_local(state, ri0, grid, consts):
            return self._run_chunk_batched(state, ri0, grid, consts, axis)

        sm_init = jax.shard_map(init_local, mesh=mesh,
                                in_specs=(P("rep"), grid_spec, consts_spec),
                                out_specs=specs)
        sm_chunk = jax.shard_map(
            chunk_local, mesh=mesh,
            in_specs=(specs, P(), grid_spec, consts_spec),
            out_specs=(specs, P()))
        def put(g, sp):
            if isinstance(g, tuple):
                return tuple(put(gi, spi) for gi, spi in zip(g, sp))
            return jax.device_put(g, NamedSharding(mesh, sp))

        grid_sharded = put(self.grid, grid_spec)
        consts_sharded = jax.tree_util.tree_map(
            lambda leaf, sp: jax.device_put(jnp.asarray(leaf),
                                            NamedSharding(mesh, sp)),
            self.consts, consts_spec)

        # the prewarm plan re-registers against the SHARDED executables
        # (the parent's init/chunk/drive entries point at launch paths
        # this engine never runs); the pack entry carries over unchanged
        self._prewarm_plan = [e for e in self._prewarm_plan
                              if e[0] == "pack"]
        _sm_init_jit = jax.jit(lambda keys: sm_init(
            keys, grid_sharded, consts_sharded))
        self._init_batch = _sm_init_jit
        self._prewarm_plan.append(
            ("init", _sm_init_jit, lambda k, s, ri: (k,)))
        if self._pallas_shard:
            # a per-shard engine clone builds the kernel for the local
            # repetition count; shard_map runs it per device.  Pin the
            # table decision to the parent's: the auto gate thresholds
            # on the TOTAL proposal budget, which the smaller local rep
            # count would misjudge.
            local = McSASEngine(
                data, bound,
                self.cfg.replace(num_reps=self.cfg.num_reps // n_rep_axis,
                                 use_pallas="on",
                                 table_ff="on" if self.uses_table
                                 else "off"),
                interpret=interpret)
            assert local.uses_pallas
            # steps per kernel launch: an unsharded scan baseline aligned
            # to the kernel's proposal stream must chunk at this value
            self._kernel_seg = mc_kernel.seg_steps(local)
            local_chunk = local._chunk_batch

            sm_pallas = jax.shard_map(
                lambda st, ri0: local_chunk(st, ri0),
                mesh=mesh, in_specs=(specs, P()), out_specs=(specs, P()),
                check_vma=False)   # per-shard ri outputs are identical

            self._chunk_batch = jax.jit(sm_pallas)
        else:
            self._chunk_batch = jax.jit(lambda state, ri: sm_chunk(
                state, ri, grid_sharded, consts_sharded))
        self._prewarm_plan.append(
            ("chunk", self._chunk_batch, lambda k, s, ri: (s, ri)))
        self._reinit_merge = jax.jit(self._merge_reinit)

        # ---- single-launch drive: a device-side while_loop AROUND the
        # shard_map'd chunk body, so multi-device fits make no host round
        # trip per chunk.  The state stays sharded across loop
        # iterations; the `live` condition reduces the small (R,)
        # convergence scalars, for which XLA inserts the all-reduce.
        # Tiering and loop machinery come from the parent's shared
        # _build_drive (one audit surface for both execution layouts).
        # Initialization stays sharded: it goes through the same
        # shard_map'd init, fused into the drive's launch.
        fast_body = (self._pallas_shard
                     or (bound.model.elementwise_q and not self.uses_table))
        # the jitted shard_map'd chunk inlines under the drive's jit
        drive = self._build_drive(self._chunk_batch, fast_body)
        if drive is not None:
            self._drive = jax.jit(drive)
            self._prewarm_plan.append(
                ("drive", self._drive, lambda k, s, ri: (s, ri)))

            def init_seeded(seed):
                keys = jax.random.split(jax.random.PRNGKey(seed),
                                        cfg.num_reps)
                return sm_init(keys, grid_sharded, consts_sharded)

            _fused = jax.jit(lambda seed: drive(
                init_seeded(seed), jnp.zeros((), jnp.int32)))
            self._init_drive = _fused
            self._prewarm_plan.append(
                ("init-drive", _fused, lambda k, s, ri: (cfg.seed,)))
        else:
            self._drive = None
            self._init_drive = None

    def run(self, **kw):
        res = super().run(**kw)
        r = self._orig_reps
        for f in ("contribs", "conval", "n_iter", "n_moves", "attempts",
                  "converged", "scaling", "background", "measval"):
            setattr(res, f, getattr(res, f)[:r])
        res.measval = res.measval[:, :self.data.count]  # drop q padding
        return res
