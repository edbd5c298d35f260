# -*- coding: utf-8 -*-
"""Device-mesh construction and sharding helpers."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Sequence] = None, devices=None) -> Mesh:
    """Builds a Mesh with axes ("rep", "q").

    *shape*: (n_rep, n_q) or None → all devices on the "rep" axis.
    *devices*: the devices to lay out (default ``jax.devices()``); a
    shape that needs more devices than given raises.
    """
    devices = list(jax.devices() if devices is None else devices)
    if shape is None:
        shape = (len(devices), 1)
    n_rep, n_q = int(shape[0]), int(shape[1])
    if n_rep * n_q > len(devices):
        raise ValueError(
            f"mesh {n_rep}x{n_q} needs {n_rep * n_q} devices, "
            f"have {len(devices)}")
    dev = np.array(devices[:n_rep * n_q]).reshape(n_rep, n_q)
    return Mesh(dev, axis_names=("rep", "q"))


def rep_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays with a leading repetition axis."""
    return NamedSharding(mesh, P("rep"))


def replicate_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_reps_for_mesh(num_reps: int, mesh: Mesh) -> int:
    """Number of repetitions padded up to a multiple of the rep-axis size
    (extra repetitions are free — they fill otherwise-idle devices — and
    are simply discarded from results)."""
    n = mesh.shape["rep"]
    return int(math.ceil(num_reps / n) * n)
