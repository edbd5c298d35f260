# -*- coding: utf-8 -*-
"""The package's one float32 contraction.

On a GPU a default-precision float32 matmul may run in TF32 (about three
decimal digits), which the smeared and table tiers and the
accelerator post tier cannot afford; every contraction in the package
goes through :func:`dot` at ``Precision.HIGHEST``.
"""
import jax
import jax.numpy as jnp


def dot(a, b):
    """``a @ b`` at full float32 (or float64) precision."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
