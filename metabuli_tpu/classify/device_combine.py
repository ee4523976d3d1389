"""Device-side path combination and species scoring.

Re-expresses ``combineMatchPaths`` (`/root/reference/src/commons/Taxonomer.cpp:410-468`)
as fixed-shape loops: paths of one (read, species) pair are sorted by
(score desc, hamming asc, start desc), then greedily accepted unless they
overlap an accepted path by >= 24 bases (or entirely); overlaps < 24 trim
the incoming path's extent, score and hamming using the boundary match's
per-codon hammings (`trimMatchPath`, `:475-485`). The final species score
is min(1, sum of accepted scores / read length)
(`getBestSpeciesMatches`, `:354-356`).

Shapes: [P, G] path grids (G = (read, species) groups kept minor,
P = path capacity; groups with more paths are flagged for host fallback).
The inner greedy is two static fori loops (P^2 tiny steps, vectorized over
groups).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class CombineResult(NamedTuple):
    group_read: jax.Array     # [G] int32
    group_species: jax.Array  # [G] int32
    score: jax.Array          # [G] float32 combined species score (capped)
    group_valid: jax.Array    # [G] bool
    fallback: jax.Array       # [G] bool (path capacity exceeded)
    # paths of fallback groups, compacted to ov_budget rows so the host can
    # re-combine just those groups exactly (padding read == INT32_MAX)
    ov_read: jax.Array        # [OV] int32
    ov_species: jax.Array     # [OV] int32
    ov_start: jax.Array       # [OV] int32
    ov_end: jax.Array         # [OV] int32
    ov_score: jax.Array       # [OV] float32
    ov_ham: jax.Array         # [OV] int32
    ov_sh16: jax.Array        # [OV] int32
    ov_eh16: jax.Array        # [OV] int32
    n_ov: jax.Array           # [] int32 (may exceed OV: overflow signal)


def _part_score(h16, rng, from_right):
    """getRight/LeftPartScore + hamming (`Match.h:46-86`); rng traced 0..8."""
    s = jnp.zeros(h16.shape, jnp.float32)
    hd = jnp.zeros(h16.shape, jnp.int32)
    for i in range(8):
        h = jnp.where(
            from_right, (h16 >> (2 * i)) & 3, (h16 >> (14 - 2 * i)) & 3
        )
        use = i < rng
        s = s + jnp.where(
            use,
            jnp.where(h == 0, jnp.float32(3.0),
                      jnp.float32(2.0) - jnp.float32(0.5) * h.astype(jnp.float32)),
            0.0,
        )
        hd = hd + jnp.where(use, h, 0)
    return s, hd


@functools.partial(jax.jit, static_argnames=("n_groups", "p_max", "ov_budget"))
def combine_paths(
    p_read, p_species, p_start, p_end, p_score, p_ham, p_sh16, p_eh16,
    p_valid,
    read_lens,  # [R] int32 total read length per read id
    *,
    n_groups: int,
    p_max: int,
    ov_budget: int = 1,
) -> CombineResult:
    """Flat path arrays -> per-(read, species) combined scores."""
    # sort paths into (read, species, score desc, ham asc, start desc) order
    big = jnp.int32(2**31 - 1)
    # pre-trim path scores are strictly positive, so the IEEE bit pattern of
    # a score is a positive int32 ordered like the float; negate for desc
    neg_score_key = -jax.lax.bitcast_convert_type(p_score, jnp.int32)
    k_read = jnp.where(p_valid, p_read, big)
    s = jax.lax.sort(
        (k_read, p_species, neg_score_key, p_ham, -p_start,
         p_start, p_end, p_score, p_sh16, p_eh16,
         p_valid.astype(jnp.int32)),
        num_keys=5,
    )
    (s_read, s_species, _, s_ham, _, s_start, s_end, s_score,
     s_sh16, s_eh16, s_valid) = s
    s_valid = s_valid.astype(bool)

    # group = (read, species) run. Paths are SORTED, so each group's rows
    # are one contiguous run: the [P, G] grids are windowed GATHERS from
    # the flat arrays at the per-group run start (one scatter-min builds
    # the run-start table) instead of scattering every path row into the
    # grids.
    M = s_read.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    new_g = jnp.ones(M, bool)
    new_g = new_g.at[1:].set(
        ~((s_read[1:] == s_read[:-1]) & (s_species[1:] == s_species[:-1]))
    )
    new_g = new_g & s_valid
    gid = jnp.cumsum(new_g.astype(jnp.int32)) - 1
    gid = jnp.where(s_valid, gid, n_groups)
    n_valid = jnp.sum(s_valid.astype(jnp.int32))

    gstart_tab = (
        jnp.full(n_groups + 2, M, jnp.int32)
        .at[jnp.where(new_g, jnp.minimum(gid, n_groups + 1), n_groups + 1)]
        .min(idx, mode="drop")
    )
    gstart = gstart_tab[:n_groups]                      # [G]
    gend = jnp.minimum(gstart_tab[1 : n_groups + 1], n_valid)
    run_len = jnp.maximum(gend - gstart, 0)             # [G]
    # host-recombine flag: more paths than device slots. (Groups past the
    # table surface through the caller's g_budget overflow counter, as in
    # the scatter formulation.)
    fallback = run_len > p_max
    win = gstart[None, :] + jnp.arange(p_max, dtype=jnp.int32)[:, None]
    occ = win < gend[None, :]                           # [P, G]
    win_c = jnp.minimum(win, M - 1)

    # ONE row gather instead of six scalar gathers: a [M, 8]-table row
    # fetch brings all six path fields at once (same idea as the
    # deep-group aligned tier, pipeline.py). Scores are sums of multiples
    # of 0.5 accumulated in a fixed loop order, so they are exact in
    # float32 on every backend.
    tab = jnp.stack(
        (s_start, s_end,
         jax.lax.bitcast_convert_type(s_score, jnp.int32),
         s_ham, s_sh16, s_eh16,
         jnp.zeros_like(s_start), jnp.zeros_like(s_start)),
        axis=1,
    )                                                   # [M, 8]
    rows = tab[win_c]                                   # [P, G, 8]

    def grid(col, fill, dtype):
        v = rows[..., col]
        if dtype == jnp.float32:
            v = jax.lax.bitcast_convert_type(v, jnp.float32)
        return jnp.where(occ, v, fill)

    G_occ = occ
    G_start = grid(0, 0, jnp.int32)
    G_end = grid(1, -1, jnp.int32)
    G_score = grid(2, 0, jnp.float32)
    G_ham = grid(3, 0, jnp.int32)
    G_sh16 = grid(4, 0, jnp.int32)
    G_eh16 = grid(5, 0, jnp.int32)
    gs_c = jnp.minimum(gstart, M - 1)
    group_valid = run_len > 0
    group_read = jnp.where(group_valid, s_read[gs_c], big)
    group_species = jnp.where(group_valid, s_species[gs_c], 0)

    nb = n_groups

    class St(NamedTuple):
        acc_start: jax.Array  # [P, G] accepted extents (frozen)
        acc_end: jax.Array
        acc_n: jax.Array      # [G] accepted count
        total: jax.Array      # [G] float32

    st0 = St(
        acc_start=jnp.zeros((p_max, nb), jnp.int32),
        acc_end=jnp.full((p_max, nb), -(2**30), jnp.int32),
        acc_n=jnp.zeros(nb, jnp.int32),
        total=jnp.zeros(nb, jnp.float32),
    )

    def outer(p, st: St):
        occ = G_occ[p]
        start0 = G_start[p]
        end0 = G_end[p]
        score0 = G_score[p]
        sh16 = G_sh16[p]
        eh16 = G_eh16[p]

        class Cur(NamedTuple):
            start: jax.Array
            end: jax.Array
            score: jax.Array
            ham: jax.Array
            rejected: jax.Array

        cur0 = Cur(start0, end0, score0, G_ham[p], ~occ)

        def inner(j, cur: Cur):
            has_j = j < st.acc_n
            a_s = st.acc_start[j]
            a_e = st.acc_end[j]
            disjoint = (cur.end < a_s) | (a_e < cur.start)
            ov = jnp.minimum(cur.end, a_e) - jnp.maximum(cur.start, a_s) + 1
            full_cover = ov == cur.end - cur.start + 1
            overlap = has_j & ~cur.rejected & ~disjoint
            reject = overlap & (full_cover | (ov >= 24))
            trim = overlap & ~full_cover & (ov < 24)
            # trimMatchPath: right side if cur.start < accepted.start
            right_side = cur.start < a_s
            rng = jnp.clip(ov // 3, 0, 8)
            r_s, r_h = _part_score(eh16, rng, True)
            l_s, l_h = _part_score(sh16, rng, False)
            t_end = jnp.where(right_side, a_s - 1, cur.end)
            t_start = jnp.where(right_side, cur.start, a_e + 1)
            t_score = cur.score - jnp.where(right_side, r_s, l_s) - (
                (ov % 3).astype(jnp.float32)
            )
            t_ham = jnp.maximum(
                0, cur.ham - jnp.where(right_side, r_h, l_h)
            )
            return Cur(
                start=jnp.where(trim, t_start, cur.start),
                end=jnp.where(trim, t_end, cur.end),
                score=jnp.where(trim, t_score, cur.score),
                ham=jnp.where(trim, t_ham, cur.ham),
                rejected=cur.rejected | reject,
            )

        cur = jax.lax.fori_loop(0, p_max, inner, cur0)
        accept = occ & ~cur.rejected
        n = st.acc_n
        at_n = jnp.arange(p_max)[:, None] == n[None, :]
        new_start = jnp.where(at_n, cur.start[None, :], st.acc_start)
        new_end = jnp.where(at_n, cur.end[None, :], st.acc_end)
        return St(
            acc_start=jnp.where(accept[None, :], new_start, st.acc_start),
            acc_end=jnp.where(accept[None, :], new_end, st.acc_end),
            acc_n=n + accept.astype(jnp.int32),
            total=st.total + jnp.where(accept, cur.score, 0.0),
        )

    st = jax.lax.fori_loop(0, p_max, outer, st0)
    rl = read_lens[jnp.clip(group_read, 0, read_lens.shape[0] - 1)]
    # total / read length, correctly rounded to float32 like the host
    # taxonomers' f32 division: XLA:GPU's f32 divide is not correctly
    # rounded (it was 1 ulp low on a golden read), while an f64 divide
    # rounded to f32 is exact for f32 operands (53 >= 2*24 + 2 bits)
    score = jnp.minimum(
        (st.total.astype(jnp.float64)
         / jnp.maximum(rl, 1).astype(jnp.float64)).astype(jnp.float32),
        1.0,
    )
    score = jnp.where(group_valid, score, 0.0)

    # compact the paths of fallback groups so the host can redo exactly
    # those groups (partition sort, same pattern as compact_paths)
    in_ov = s_valid & fallback[jnp.minimum(gid, n_groups - 1)] \
        & (gid < n_groups)
    n_ov = jnp.sum(in_ov.astype(jnp.int32))
    rows = jax.lax.sort(
        jnp.where(in_ov, idx, jnp.int32(2**31 - 1))
    )
    if rows.shape[0] < ov_budget:  # budget may exceed the path capacity
        rows = jnp.pad(rows, (0, ov_budget - rows.shape[0]),
                       constant_values=2**31 - 1)
    rows = rows[:ov_budget]
    pad = rows == jnp.int32(2**31 - 1)
    safe = jnp.minimum(rows, M - 1)
    take = lambda a, fill: jnp.where(pad, fill, a[safe])
    return CombineResult(
        group_read=group_read,
        group_species=group_species,
        score=score,
        group_valid=group_valid,
        fallback=fallback,
        ov_read=take(s_read, jnp.int32(big)),
        ov_species=take(s_species, jnp.int32(0)),
        ov_start=take(s_start, jnp.int32(0)),
        ov_end=take(s_end, jnp.int32(-1)),
        ov_score=take(s_score, jnp.float32(0)),
        ov_ham=take(s_ham, jnp.int32(0)),
        ov_sh16=take(s_sh16, jnp.int32(0)),
        ov_eh16=take(s_eh16, jnp.int32(0)),
        n_ov=n_ov,
    )
