# -*- coding: utf-8 -*-
"""GPU MC chunk kernel (Pallas, Triton route): a whole chunk of
accept/reject steps in one launch.

The XLA scan path (core/engine.py) runs every MC step as a handful of
small fused kernels in sequence.  The work per step is tiny
(R·K·Nq floats), so that chain is bound by launch latency rather than by
FLOPs or bytes.  This kernel runs one program per repetition
(repetitions never interact) and loops over the chunk's steps inside
it; the totals ``ft`` and the fit scalars stay in registers, and a step
reads and writes one bank row ``ibank[r, slot]`` and one ``rset[r, slot]``
in device memory.

Candidate rows are evaluated by XLA, outside the kernel, for the whole
segment at once: one batched pass over S·R·K rows spreads the form
factor's transcendentals (or the parameter table's row gathers,
ops/tables.py) over the whole card, and the kernel reads one (K, Nq)
tile per step.  Evaluating the rows inside the kernel keeps that work
on the R SMs that run the programs; on an H100 it made the headline
sphere fit 8x slower than the XLA scan path (PERF.md, Findings).

The XLA scan path stays the semantics oracle.  The proposal stream is
the scan path's own: proposals are pre-drawn by
``engine._draw_chunk_proposals`` (threefry), local moves are transformed
by ``engine.local_candidates`` from the segment-start ``rset`` (so a
segment visits strictly distinct slots, ``seg_steps``), and the rows are
the engine's own ``intensity_row``.  The solve accumulates in float64
like ``fitcore.solve_scale_bg``; only the association of the row sums
differs.

Triton blocks are powers of two: the engine pads the fit grid with
zero-weight points to the next power of two (``padded_len``) and the
kernel pads K with masked duplicate candidates.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# device-memory cap for one segment's (S, R, K, Nq) row stream
_ROWS_BUDGET = 256 * 2 ** 20


def padded_len(n: int) -> int:
    """Next power of two >= n (Triton block sizes)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def eligible(engine) -> bool:
    """True when the kernel can run this engine's configuration: float32
    elementwise-in-q models on a plain 1-D grid, or the parameter-table
    tier (quadrature and smeared rows are too large to evaluate a whole
    segment at once without a table)."""
    cfg, bound = engine.cfg, engine.bound
    if (jnp.dtype(cfg.dtype) != jnp.float32 or bound.n_active < 1
            # a chunk re-reads a slot's bank row one step after writing
            # it when N == 1; nothing orders that store and load across
            # the program's threads
            or cfg.num_contribs < 2):
        return False
    grid = engine.grid
    if engine.uses_table:
        inner, values = grid
        while isinstance(inner, tuple):
            inner = inner[0]
        # rows on another inner grid (Kholodenko's smeared
        # flattened-locs table, contracted inside the lookup) cannot be
        # zero-padded per column
        nq = int(inner.shape[0])
        return int(values.shape[1]) == nq or nq == padded_len(nq)
    return (bound.model.elementwise_q and not isinstance(grid, tuple)
            and grid.ndim == 1)


def seg_steps(engine) -> int:
    """Steps per launch: the chunk size, capped at ``num_contribs`` with
    local moves (a segment must visit distinct slots, so every local
    proposal can be drawn from the segment-start ``rset``) and by the
    row stream's device-memory budget."""
    cfg = engine.cfg
    cap = int(cfg.chunk_steps)
    if engine._k_local():
        cap = min(cap, int(cfg.num_contribs))
    per_step = (int(cfg.num_reps) * padded_len(cfg.candidates_per_step)
                * int(engine.consts.y.shape[0]) * 4)
    return max(1, min(cap, _ROWS_BUDGET // per_step))


def _solve(x, y, u, s_u, s_uy, find_bg, pos_bg, n_fit):
    """Per-candidate closed-form (scale, background) and reduced χ² for
    the (K, Nq) tile *x*: ``fitcore.solve_scale_bg`` term by term
    (float64 sums, same degeneracy guards, residual-form χ²)."""
    f64 = jnp.float64
    ux = u * x
    s_x = jnp.sum(ux.astype(f64), axis=1)
    s_xx = jnp.sum((ux * x).astype(f64), axis=1)
    s_xy = jnp.sum((ux * y).astype(f64), axis=1)
    xx_zero = s_xx <= 0.0
    a_nobg = jnp.where(xx_zero, 0.0, s_xy / jnp.where(xx_zero, 1.0, s_xx))
    if find_bg:
        denom = s_u * s_xx
        det = denom - s_x * s_x
        degen = xx_zero | (det <= 1e-6 * denom)
        safe = jnp.where(degen, 1.0, det)
        a_bg = (s_u * s_xy - s_x * s_uy) / safe
        b_bg = (s_uy - a_bg * s_x) / s_u
        a = jnp.where(degen, a_nobg, a_bg)
        b = jnp.where(degen, (s_uy - a_nobg * s_x) / s_u, b_bg)
        if pos_bg:
            a = jnp.where(b < 0.0, a_nobg, a)
            b = jnp.maximum(b, 0.0)
    else:
        a = a_nobg
        b = jnp.zeros_like(a)
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    res = y - a[:, None] * x - b[:, None]
    chi = (jnp.sum((u * res * res).astype(f64), axis=1) / n_fit
           ).astype(jnp.float32)
    return a, b, chi


def build_chunk_fn(engine, interpret=False):
    """Returns jitted ``chunk_fn(state, ri) -> (state, ri)`` advancing
    ``seg_steps`` MC steps in one kernel launch.

    The engine's grid and constants must already be padded to a power of
    two (u = 0 on the pad points, so they are invisible to every
    reduction).  *interpret* runs the kernel in the Pallas interpreter
    (tests on the CPU)."""
    cfg, bound = engine.cfg, engine.bound
    n_reps, n = int(cfg.num_reps), int(cfg.num_contribs)
    k_cand = int(cfg.candidates_per_step)
    k_pad = padded_len(k_cand)
    n_p = bound.n_active
    nq = int(engine.consts.y.shape[0])
    if nq != padded_len(nq):
        raise ValueError(f"fit grid of {nq} points is not padded to a "
                         "power of two")
    seg = seg_steps(engine)
    crit = float(cfg.convergence_criterion)
    max_iter = int(cfg.max_iterations)
    find_bg, pos_bg = cfg.find_background, cfg.positive_background
    n_fit = float(engine.consts.n)

    def kernel(y_ref, u_ref, sc_ref, ri_ref, cands_ref, rows_ref,
               *refs):
        # the state inputs alias the outputs: read and write through the
        # output refs only
        rset_ref, ibank_ref, ft_ref, fs_ref, is_ref = refs[5:]
        r = pl.program_id(0)
        y = y_ref[...][None, :]
        u = u_ref[...][None, :]
        s_u = sc_ref[0].astype(jnp.float64)
        s_uy = sc_ref[1].astype(jnp.float64)
        ri0 = ri_ref[0]
        kio = jax.lax.broadcasted_iota(jnp.int32, (k_pad,), 0)

        def live(cv, n_it):
            return (cv > jnp.float32(crit)) & (n_it < jnp.int32(max_iter))

        def cond(c):
            s, _, _, _, cv, n_it, _ = c
            return (s < jnp.int32(seg)) & live(cv, n_it)

        def body(c):
            # a converged repetition leaves the loop: every later step
            # of the chunk would be a no-op on its state
            s, ft, sc, bg, cv, n_it, n_mv = c
            ri = jax.lax.rem(ri0 + s, jnp.int32(n))
            cand = [cands_ref[s, r, :, p] for p in range(n_p)]
            rows = rows_ref[s, r, :, :]
            old = ibank_ref[r, ri, :]
            ft_base = ft - old
            x = ft_base[None, :] + rows
            a, b, chi = _solve(x, y, u, s_u, s_uy, find_bg, pos_bg, n_fit)
            chi = jnp.where(kio < jnp.int32(k_cand), chi, jnp.inf)
            best_chi = jnp.min(chi)
            # first index of the minimum, selected by masked sums
            best = jnp.min(jnp.where(chi <= best_chi, kio, jnp.int32(k_pad)))
            pick = kio == best
            best_row = jnp.sum(jnp.where(pick[:, None], rows, 0.0), axis=0)
            accept = best_chi < cv
            ibank_ref[r, ri, :] = jnp.where(accept, best_row, old)
            for p in range(n_p):
                rset_ref[r, ri, p] = jnp.where(
                    accept, jnp.sum(jnp.where(pick, cand[p], 0.0)),
                    rset_ref[r, ri, p])
            return (s + 1,
                    jnp.where(accept, ft_base + best_row, ft),
                    jnp.where(accept, jnp.sum(jnp.where(pick, a, 0.0)), sc),
                    jnp.where(accept, jnp.sum(jnp.where(pick, b, 0.0)), bg),
                    jnp.where(accept, best_chi, cv),
                    n_it + jnp.int32(k_cand),
                    n_mv + accept.astype(jnp.int32))

        _, ft, sc, bg, cv, n_it, n_mv = jax.lax.while_loop(
            cond, body,
            (jnp.int32(0), ft_ref[r, :], fs_ref[r, 0], fs_ref[r, 1],
             fs_ref[r, 2], is_ref[r, 0], is_ref[r, 1]))
        ft_ref[r, :] = ft
        fs_ref[r, 0] = sc
        fs_ref[r, 1] = bg
        fs_ref[r, 2] = cv
        is_ref[r, 0] = n_it
        is_ref[r, 1] = n_mv

    tile = k_pad * nq
    n_const = 6
    pallas_fn = pl.pallas_call(
        kernel,
        grid=(n_reps,),
        out_shape=(
            jax.ShapeDtypeStruct((n_reps, n, n_p), jnp.float32),   # rset
            jax.ShapeDtypeStruct((n_reps, n, nq), jnp.float32),    # ibank
            jax.ShapeDtypeStruct((n_reps, nq), jnp.float32),       # ft
            jax.ShapeDtypeStruct((n_reps, 3), jnp.float32),  # scale, bg, χ²
            jax.ShapeDtypeStruct((n_reps, 2), jnp.int32),    # n_iter, moves
        ),
        input_output_aliases={n_const + i: i for i in range(5)},
        interpret=interpret,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, min(8, tile // 2048))),
        name="mcsas_chunk",
    )

    grid = engine.grid
    y, u = engine.consts.y, engine.consts.u
    sc = jnp.asarray([engine.consts.s_u, engine.consts.s_uy], jnp.float32)
    row_eval = jax.vmap(lambda p: engine._intensity_row(grid, p))
    k_local = engine._k_local()
    k_global = k_cand - k_local
    if k_local:
        from ..core.engine import local_candidates
        lo_p, hi_p = engine._range_bounds()

    @jax.jit
    def chunk_fn(state, ri):
        keys = jax.vmap(jax.random.split)(state.key)
        cands = engine._draw_chunk_proposals(keys[:, 1], n_steps=seg)
        ri0 = ri.astype(jnp.int32)
        if k_local:
            # distinct slots within the segment: each slot's current
            # value at its step is its segment-start value
            slots = jnp.remainder(
                ri0 + jnp.arange(seg, dtype=jnp.int32), jnp.int32(n))
            cur = jnp.swapaxes(jnp.take(state.rset, slots, axis=1), 0, 1)
            cands = jnp.concatenate(
                [cands[:, :, :k_global],
                 local_candidates(cur, cands[:, :, k_global:], lo_p, hi_p,
                                  cfg.local_scale)], axis=2)
        if k_pad != k_cand:
            # masked in the kernel; duplicates keep the rows finite
            cands = jnp.concatenate(
                [cands, jnp.repeat(cands[:, :, :1], k_pad - k_cand, axis=2)],
                axis=2)
        rows = row_eval(cands.reshape(-1, n_p)).reshape(
            seg, n_reps, k_pad, nq)
        fs = jnp.stack([state.scale, state.background, state.conval], 1)
        it = jnp.stack([state.n_iter, state.n_moves], 1)
        # totals refreshed from the bank, as the scan path does per chunk
        ft = jnp.sum(state.ibank, axis=1)
        rset, ibank, ft, fs, it = pallas_fn(
            y, u, sc, ri0.reshape(1), cands, rows,
            state.rset, state.ibank, ft, fs, it)
        new_state = state._replace(
            key=keys[:, 0], rset=rset, ibank=ibank, ft=ft,
            scale=fs[:, 0], background=fs[:, 1], conval=fs[:, 2],
            n_iter=it[:, 0], n_moves=it[:, 1])
        return new_state, jnp.remainder(ri0 + jnp.int32(seg), jnp.int32(n))

    return chunk_fn
