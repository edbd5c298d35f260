# -*- coding: utf-8 -*-
"""Multi-device execution over a jax device mesh.

The reference has no parallelism of any kind (SURVEY §2.13; the numReps
ensemble is a sequential Python loop, src/mcsas/mcsas/mcsas.py:214).  Here:

- **rep axis (data parallel)**: the numReps uncertainty ensemble is batched
  with vmap and sharded over the mesh's "rep" axis — embarrassingly
  parallel, zero collectives until the final host gather.
- **q axis (sequence parallel)**: for very fine q grids / smearing matrices
  the intensity bank is sharded along q inside ``shard_map``; the χ² fit's
  reductions complete with ``psum`` over the device interconnect (see
  :func:`mcsas_tpu.core.fitcore.solve_scale_bg`).
"""
from .mesh import (make_mesh, rep_sharding, replicate_sharding,
                   pad_reps_for_mesh)
from .spmd import ShardedEnsemble

__all__ = ["make_mesh", "rep_sharding", "replicate_sharding",
           "pad_reps_for_mesh", "ShardedEnsemble"]
