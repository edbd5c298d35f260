# -*- coding: utf-8 -*-
"""Scaling+background fit and reduced-χ² computation.

The reference runs a scipy Levenberg-Marquardt least-squares fit of the two
linear coefficients (scale A, background b) on *every* MC iteration
(reference: src/mcsas/mcsas/backgroundscalingfit.py:94-139 and its call at
mcsas/mcsas.py:376-377).  Because the model ``y ≈ A·x + b`` is linear in
(A, b), the weighted least-squares optimum has a closed form — the 2×2
normal equations — which is exact, branch-free, and costs four reductions
over the q grid.  That replaces an iterative host-side optimizer with a few
fused reductions inside the jitted MC step: the single biggest
algorithmic win of the rebuild.

Semantics preserved from the reference:
 - ``find_background=False`` pins b = 0 (backgroundscalingfit.py:130-131),
 - ``positive_background=True`` restricts b ≥ 0.  The reference implements
   this by fitting |b| (chiPosBg, :59-63); since χ² is quadratic in b, the
   constrained optimum is b = max(0, b_unconstrained) with A refit at the
   boundary — equivalent, but exact.
 - χ² is the *reduced* χ² without parameter-count correction
   (chiSqr, :72-77), and the alternative goodness-of-fit of [Henn 2016]
   is available as ``agofs`` (aGoFsAlpha, :79-84 with the 1/α factor
   applied at :136-138).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class FitConstants(NamedTuple):
    """Data-side constants of the weighted linear fit, precomputed once.

    ``y`` is the measured intensity on the fit grid, ``u`` the weights
    1/σ² (σ==0 treated as 1, matching backgroundscalingfit.py:115-117).
    """
    y: jnp.ndarray        # (Nq,)
    u: jnp.ndarray        # (Nq,)
    s_u: jnp.ndarray      # Σu          scalar
    s_uy: jnp.ndarray     # Σu·y        scalar
    n: int                # number of fit points


def make_constants(f, fu, dtype=jnp.float32) -> FitConstants:
    y = jnp.asarray(np.asarray(f), dtype)
    sigma = np.asarray(fu, dtype=np.float64).copy()
    sigma[sigma == 0.0] = 1.0
    u = jnp.asarray(1.0 / sigma ** 2, dtype)
    return FitConstants(y=y, u=u, s_u=jnp.sum(u), s_uy=jnp.sum(u * y),
                        n=int(np.asarray(f).shape[0]))


class ScaleBg(NamedTuple):
    scale: jnp.ndarray
    background: jnp.ndarray
    chisqr: jnp.ndarray   # reduced χ²


def solve_scale_bg(x, c: FitConstants, find_background: bool,
                   positive_background: bool, axis_name=None) -> ScaleBg:
    """Exact weighted least-squares for y ≈ A·x + b, plus reduced χ².

    χ² is evaluated in residual form (not via the expanded normal-equation
    identity) so float32 accumulation stays stable near convergence.

    With ``axis_name`` set, ``x`` / ``c.y`` / ``c.u`` are q-axis shards
    inside a ``shard_map`` and every reduction is completed with a psum
    over the mesh axis — the sequence-parallel analogue called for in
    SURVEY §2.13 (the q grid is the only "sequence" in this workload).

    All reductions accumulate in float64 (cast before the sum/psum) so
    the accept decisions driven by these scalars are invariant to the
    q-axis device split: the residual float64 association difference is
    ~1e-16 relative, far below the float32 rounding of the returned
    scalars.
    """
    dt = x.dtype
    acc = jnp.float64 if jax.config.jax_enable_x64 else dt

    def reduce(v):
        s = jnp.sum(v.astype(acc))
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name)
        return s

    u, y = c.u, c.y
    s_x = reduce(u * x)
    s_xx = reduce(u * x * x)
    s_xy = reduce(u * x * y)

    s_u = jnp.asarray(c.s_u, acc)
    s_uy = jnp.asarray(c.s_uy, acc)

    # scale-invariant guards: x may span absurd absolute magnitudes
    # (SI intensities ~1e-30), so degeneracy must be judged relative to
    # s_u·s_xx (det = s_u·s_xx·(1 − corr²)), never against absolute eps
    rel_eps = jnp.asarray(
        1e-6 if jnp.dtype(dt) == jnp.float32 else 1e-12, acc)
    xx_zero = s_xx <= 0.0
    a_nobg = jnp.where(xx_zero, jnp.zeros_like(s_xy),
                       s_xy / jnp.where(xx_zero, jnp.ones_like(s_xx),
                                        s_xx))

    if find_background:
        denom = s_u * s_xx
        det = denom - s_x * s_x
        degenerate = xx_zero | (det <= rel_eps * denom)
        safe_det = jnp.where(degenerate, jnp.ones_like(det), det)
        a_bg = (s_u * s_xy - s_x * s_uy) / safe_det
        b_bg = (s_uy - a_bg * s_x) / s_u
        a = jnp.where(degenerate, a_nobg, a_bg)
        b_deg = (s_uy - a_nobg * s_x) / s_u
        b = jnp.where(degenerate, b_deg, b_bg)
        if positive_background:
            neg = b < 0.0
            a = jnp.where(neg, a_nobg, a)
            b = jnp.maximum(b, 0.0)
    else:
        a = a_nobg
        b = jnp.zeros_like(a)

    a = a.astype(dt)
    b = b.astype(dt)
    r = y - a * x - b
    chisqr = (reduce(u * r * r) / c.n).astype(dt)
    return ScaleBg(scale=a, background=b, chisqr=chisqr)


def chisqr_at(x, scale, background, c: FitConstants):
    """Reduced χ² at a given (A, b) — for re-evaluating stored fits."""
    r = c.y - scale * x - background
    return jnp.sum(c.u * r * r) / c.n


def agofs(x, scale, background, c: FitConstants, num_params: int):
    """Alternative goodness-of-fit after Henn 2016
    (doi:10.1107/S2053273316013206); reference:
    backgroundscalingfit.py:79-84,136-138."""
    model = scale * x + background
    val = jnp.sum((c.y - model) ** 2) / jnp.sum(1.0 / c.u)
    # dof guard: a fit grid with <= num_params points must not divide
    # by zero/negative (mirrors the reference's n_pts/max(n-P, 1) clamp)
    return val * c.n / jnp.maximum(c.n - num_params, 1.0)
