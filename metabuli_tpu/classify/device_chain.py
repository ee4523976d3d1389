"""Device-side match chaining (the on-device taxonomer's DP stage).

Re-expresses the reference's per-read chain DP (`getMatchPaths`,
`/root/reference/src/commons/Taxonomer.cpp:487-648`) as a fixed-shape scan:

  * matches (already sorted by read, species, frame, pos) are scattered into
    a dense grid [column, slot, block] where a block is one
    (read, species, frame) run, a column is the position quotient pos//3
    relative to the block start, and slots hold position-group ties;
  * one `lax.scan` over columns carries the previous non-empty position
    group's path states (score/start/depth/hamming + target DNA encodings)
    and applies the reference's rules: connect iff 0 < shift <= maxCodonShift
    and the 24-bit codon encodings overlap (isConsecutive2, operand order
    swapped on reverse frames), take the best-scoring connectable
    predecessor (first-wins ties), emit unconnected predecessors with
    depth >= minConsCnt, and emit the final group unconditionally
    (depth-gated).

Layout note: every hot tensor keeps the BLOCK axis minor ([k, NB], grids
[w, k, NB]) and the tiny slot axis k is unrolled into Python loops of
[NB]-wide ops, so each scan step works on long contiguous vectors rather
than a k=4-wide minor dimension (ROADMAP Design 3 re-decides it on GPU
measurements).

Blocks exceeding the column/slot capacity are flagged for host fallback.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.float32(-1e30)  # np literal, not a device constant (see device_compact.INT32_MAX)


class ChainResult(NamedTuple):
    # stacked emissions: step axis = W columns + 1 final flush
    emit_mask: jax.Array    # [W+1, K, NB] bool
    start: jax.Array        # [W+1, K, NB] int32 query coordinate
    end: jax.Array          # [W+1, K, NB] int32
    score: jax.Array        # [W+1, K, NB] float32
    hamming: jax.Array      # [W+1, K, NB] int32
    depth: jax.Array        # [W+1, K, NB] int32
    start_h16: jax.Array    # [W+1, K, NB] int32 (startMatch rightEndHamming)
    end_h16: jax.Array      # [W+1, K, NB] int32 (endMatch rightEndHamming)
    block_read: jax.Array   # [NB] int32 qid per block
    block_species: jax.Array  # [NB] int32
    fallback: jax.Array     # [NB] bool: block exceeded grid capacity
    n_real_blocks: jax.Array  # [] int32: blocks past NB are silently absent
                              # from `fallback` (their slot is sliced off),
                              # so callers must check this count


def _match_score(h16: jax.Array) -> jax.Array:
    """Match::getScore over all 8 codons (`Match.h:32-44`), float32."""
    s = jnp.zeros(h16.shape, jnp.float32)
    for i in range(8):
        h = (h16 >> (2 * i)) & 3
        s = s + jnp.where(h == 0, jnp.float32(3.0),
                          jnp.float32(2.0) - jnp.float32(0.5) * h.astype(jnp.float32))
    return s


def _increment(h16: jax.Array, shift: jax.Array):
    """(score, hamming) increments over the low `shift` codons
    (`Taxonomer.cpp:650-669`); shift is traced (1..8)."""
    s = jnp.zeros(h16.shape, jnp.float32)
    hd = jnp.zeros(h16.shape, jnp.int32)
    for i in range(8):
        h = (h16 >> (2 * i)) & 3
        use = i < shift
        s = s + jnp.where(
            use,
            jnp.where(h == 0, jnp.float32(3.0),
                      jnp.float32(2.0) - jnp.float32(0.5) * h.astype(jnp.float32)),
            0.0,
        )
        hd = hd + jnp.where(use, h, 0)
    return s, hd


@functools.partial(
    jax.jit, static_argnames=("n_blocks", "w", "k", "max_shift", "kmer_format"),
)
def chain_matches(
    qid, species, frame, pos, hamming, dna, h16,  # [M] int32 sorted arrays
    valid,                                        # [M] bool
    min_depth_of_species,                         # [S] int32 (euk-aware)
    *,
    n_blocks: int,
    w: int,
    k: int,
    max_shift: int,
    kmer_format: int = 2,
) -> ChainResult:
    M = qid.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)

    new_block = jnp.ones(M, bool)
    same = (
        (qid[1:] == qid[:-1])
        & (species[1:] == species[:-1])
        & (frame[1:] == frame[:-1])
    )
    new_block = new_block.at[1:].set(~same)
    new_block = new_block & valid
    bid = jnp.cumsum((new_block & valid).astype(jnp.int32)) - 1
    bid = jnp.where(valid, bid, n_blocks)  # invalid rows -> dropped

    # rows arrive block-sorted with pos ascending, so the per-block
    # minimum quotient is just the value AT THE BLOCK HEAD — a segmented
    # broadcast scan instead of a segment_min scatter (~35ms/1.2M rows)
    from .device_redundancy import seg_broadcast, seg_suffix_or

    q = pos // 3
    q0_row = seg_broadcast(new_block, q)
    col = q - q0_row

    # slot within the (block, column) group
    cell_new = jnp.ones(M, bool)
    cell_same = (bid[1:] == bid[:-1]) & (col[1:] == col[:-1])
    cell_new = cell_new.at[1:].set(~cell_same)
    run_start = jax.lax.cummax(jnp.where(cell_new, idx, 0))
    slot = idx - run_start

    n_real_blocks = jnp.sum((new_block & valid).astype(jnp.int32))
    ok = valid & (bid < n_blocks) & (col >= 0) & (col < w) & (slot < k)
    over = valid & ((bid >= n_blocks) | (col >= w) | (slot >= k))

    # per-block head rows via partition sort; block b's head is the b-th
    # head in row order (same order as bid), so head-row gathers of the
    # tiny [n_blocks] tables replace the per-row scatter reductions
    BIG = jnp.int32(2**31 - 1)
    headslot = jax.lax.sort(jnp.where(new_block, idx, BIG))
    if headslot.shape[0] < n_blocks:
        headslot = jnp.pad(headslot, (0, n_blocks - headslot.shape[0]),
                           constant_values=2**31 - 1)
    headslot = headslot[:n_blocks]
    hpad = headslot == BIG
    hsafe = jnp.minimum(headslot, M - 1)
    blk_last = jnp.concatenate([new_block[1:], jnp.ones(1, bool)])
    over_sfx = seg_suffix_or(blk_last, over)
    fallback = jnp.where(hpad, False, over_sfx[hsafe])

    b_i = jnp.where(ok, bid, n_blocks)
    c_i = jnp.where(ok, col, 0)
    s_i = jnp.where(ok, slot, 0)

    def grid(x, fill, dtype):
        g = jnp.full((w, k, n_blocks + 1), fill, dtype)
        return g.at[c_i, s_i, b_i].set(x.astype(dtype), mode="drop")[
            :, :, :n_blocks
        ]

    # Grid scatters are this stage's main cost, so the per-row payload is
    # packed into TWO i32 scatters:
    #   g1 = dna24 << 1 | occ
    #   g2 = h16 << 8 | hammingSum << 2 | pos%3
    # pos itself is reconstructed inside the scan as 3*(q0_block + column)
    # + rem (the column IS the position quotient relative to the block
    # head). Rows outside the grid (b_i = n_blocks) all land in the
    # padding block that is sliced off, so the unordered scatter of
    # repeated indices never reaches a kept cell; every kept
    # (column, slot, block) cell is written by exactly one row.
    g1 = grid((dna << 1) | 1, 0, jnp.int32)
    g2 = grid((h16 << 8) | ((hamming & 63) << 2) | (pos % 3), 0, jnp.int32)

    # qid/species/frame are constant within a block: read them at the head
    block_read = jnp.where(hpad, 2**31 - 1, qid[hsafe])
    block_species = jnp.where(hpad, 0, species[hsafe])
    block_q0 = jnp.where(hpad, 0, q[hsafe])
    block_forward = jnp.where(hpad, False, frame[hsafe] < 3)
    if kmer_format != 2:
        # old format uses isConsecutive (operand roles swapped vs fmt 2)
        block_forward = ~block_forward
    block_min_depth = min_depth_of_species[
        jnp.minimum(block_species, min_depth_of_species.shape[0] - 1)
    ]

    class Carry(NamedTuple):
        n_groups: jax.Array   # [NB] distinct non-empty columns so far
        q: jax.Array          # [NB] quotient of the previous non-empty group
        occ: jax.Array        # [K, NB]
        dna: jax.Array        # [K, NB]
        h16: jax.Array        # [K, NB] endMatch h16 (the group's own match)
        pos: jax.Array        # [K, NB]
        p_score: jax.Array    # [K, NB] path score
        p_start: jax.Array    # [K, NB]
        p_ham: jax.Array      # [K, NB]
        p_depth: jax.Array    # [K, NB]
        p_sh16: jax.Array     # [K, NB]

    nb = n_blocks
    init = Carry(
        n_groups=jnp.zeros(nb, jnp.int32),
        q=jnp.zeros(nb, jnp.int32),
        occ=jnp.zeros((k, nb), bool),
        dna=jnp.zeros((k, nb), jnp.int32),
        h16=jnp.zeros((k, nb), jnp.int32),
        pos=jnp.zeros((k, nb), jnp.int32),
        p_score=jnp.zeros((k, nb), jnp.float32),
        p_start=jnp.zeros((k, nb), jnp.int32),
        p_ham=jnp.zeros((k, nb), jnp.int32),
        p_depth=jnp.zeros((k, nb), jnp.int32),
        p_sh16=jnp.zeros((k, nb), jnp.int32),
    )

    def step(carry: Carry, xs):
        g1_c, g2_c, c_step = xs                 # [K, NB], [K, NB], []
        occ_c = (g1_c & 1) == 1
        dna_c = g1_c >> 1
        h16_c = g2_c >> 8
        ham_c = (g2_c >> 2) & 63
        # reconstruct absolute positions: the column IS the quotient offset
        pos_c = 3 * (block_q0[None, :] + c_step) + (g2_c & 3)
        score_c = jnp.where(occ_c, _match_score(h16_c), 0.0)
        has_cur = occ_c[0]
        for i in range(1, k):
            has_cur = has_cur | occ_c[i]
        cur_col_q = block_q0 + c_step
        shift = jnp.where(carry.n_groups > 0, cur_col_q - carry.q,
                          jnp.int32(2**30))
        connectable = has_cur & (shift >= 1) & (shift <= max_shift)

        # pairwise connectivity prev slot i x cur slot j, unrolled ([NB] ops)
        sh = jnp.clip(shift, 1, 8)
        mask_bits = (jnp.int32(1) << (24 - 3 * sh)) - 1
        sh3 = 3 * sh
        conn = [[None] * k for _ in range(k)]
        for i in range(k):
            for j in range(k):
                c_fwd = (carry.dna[i] & mask_bits) == (dna_c[j] >> sh3)
                c_rev = (dna_c[j] & mask_bits) == (carry.dna[i] >> sh3)
                conn[i][j] = (
                    jnp.where(block_forward, c_fwd, c_rev)
                    & carry.occ[i] & occ_c[j] & connectable
                )

        inc_s, inc_h = _increment(h16_c, jnp.minimum(sh, jnp.int32(8))[None, :])
        sh_clip = jnp.clip(shift, 0, 8)

        new_score, new_start, new_ham, new_depth, new_sh16 = [], [], [], [], []
        for j in range(k):
            # best predecessor (strictly-greater, first/lowest-i wins ties)
            bs = jnp.full(nb, NEG)
            sel_score = jnp.zeros(nb, jnp.float32)
            sel_start = jnp.zeros(nb, jnp.int32)
            sel_ham = jnp.zeros(nb, jnp.int32)
            sel_depth = jnp.zeros(nb, jnp.int32)
            sel_sh16 = jnp.zeros(nb, jnp.int32)
            for i in range(k):
                cand = jnp.where(conn[i][j], carry.p_score[i], NEG)
                better = cand > bs
                bs = jnp.where(better, cand, bs)
                sel_score = jnp.where(better, carry.p_score[i], sel_score)
                sel_start = jnp.where(better, carry.p_start[i], sel_start)
                sel_ham = jnp.where(better, carry.p_ham[i], sel_ham)
                sel_depth = jnp.where(better, carry.p_depth[i], sel_depth)
                sel_sh16 = jnp.where(better, carry.p_sh16[i], sel_sh16)
            has_pred = bs > 0.0
            new_score.append(jnp.where(has_pred, sel_score + inc_s[j], score_c[j]))
            new_start.append(jnp.where(has_pred, sel_start, pos_c[j]))
            new_ham.append(jnp.where(has_pred, sel_ham + inc_h[j], ham_c[j]))
            new_depth.append(jnp.where(has_pred, sel_depth + sh_clip, 1))
            new_sh16.append(jnp.where(has_pred, sel_sh16, h16_c[j]))

        # emissions: prev slots not connected to ANY cur slot, depth gate
        emit = []
        for i in range(k):
            connected_prev = conn[i][0]
            for j in range(1, k):
                connected_prev = connected_prev | conn[i][j]
            emit.append(
                carry.occ[i]
                & has_cur
                & ~connected_prev
                & (carry.p_depth[i] >= block_min_depth)
            )
        out = (
            jnp.stack(emit),
            carry.p_start,
            carry.pos + 23,
            carry.p_score,
            carry.p_ham,
            carry.p_depth,
            carry.p_sh16,
            carry.h16,
        )

        sel = has_cur
        pick = lambda new_kb, old_kb: jnp.where(sel[None, :], new_kb, old_kb)
        new_carry = Carry(
            n_groups=carry.n_groups + has_cur.astype(jnp.int32),
            q=jnp.where(sel, cur_col_q, carry.q),
            occ=pick(occ_c, carry.occ),
            dna=pick(dna_c, carry.dna),
            h16=pick(h16_c, carry.h16),
            pos=pick(pos_c, carry.pos),
            p_score=pick(jnp.stack(new_score), carry.p_score),
            p_start=pick(jnp.stack(new_start), carry.p_start),
            p_ham=pick(jnp.stack(new_ham), carry.p_ham),
            p_depth=pick(jnp.stack(new_depth), carry.p_depth),
            p_sh16=pick(jnp.stack(new_sh16), carry.p_sh16),
        )
        return new_carry, out

    xs = (g1, g2, jnp.arange(w, dtype=jnp.int32))
    final, outs = jax.lax.scan(step, init, xs)

    # final flush: last group, depth-gated, needs >= 2 distinct groups
    f_emit = (
        final.occ
        & (final.p_depth >= block_min_depth[None, :])
        & (final.n_groups >= 2)[None, :]
    )
    f_out = (
        f_emit, final.p_start, final.pos + 23, final.p_score,
        final.p_ham, final.p_depth, final.p_sh16, final.h16,
    )
    stacked = tuple(
        jnp.concatenate([o, f[None]], axis=0) for o, f in zip(outs, f_out)
    )
    return ChainResult(
        emit_mask=stacked[0], start=stacked[1], end=stacked[2],
        score=stacked[3], hamming=stacked[4], depth=stacked[5],
        start_h16=stacked[6], end_h16=stacked[7],
        block_read=block_read, block_species=block_species,
        fallback=fallback, n_real_blocks=n_real_blocks,
    )
