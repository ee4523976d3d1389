"""Device-side redundancy filtering (per-quotient best match + LCA).

Re-expresses ``filterRedundantMatches`` (`/root/reference/src/commons/Taxonomer.cpp:205-241`)
with fixed shapes: within one (read, species), matches sharing a position
quotient ``pos // dnaShift`` reduce to a single taxid — the minimum-hamming
match's, with equal-minimum ties collapsed by taxonomy LCA. (The reference's
sequential reset-and-accumulate loop equals "LCA of all matches whose
hamming equals the quotient minimum", since the last reset happens at the
first occurrence of the global minimum.)

LCA runs on device via the Euler-tour sparse table (the same structure the
host Taxonomy uses), reduced over tie sets with log-rounds of
distance-2^r segmented combining.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class DeviceTaxonomy(NamedTuple):
    """Euler-tour LCA structure as device arrays (from db.taxonomy)."""

    euler_first: jax.Array  # [N+1] int32
    euler_node: jax.Array   # [m] int32
    euler_depth: jax.Array  # [m] int32 depth per euler position
    sparse: jax.Array       # [levels, m] int32 argmin positions
    parent: jax.Array       # [N+1] int32


def device_taxonomy(tax) -> DeviceTaxonomy:
    # quotient_best packs euler_first into the low 25 bits of a sort key
    # (hamming << 25 | euler_first); a longer Euler tour would silently
    # corrupt LCA taxids, so refuse it outright
    if len(tax.euler_first) and int(np.max(tax.euler_first)) >= (1 << 25):
        raise ValueError(
            f"taxonomy Euler tour too long for the device LCA sort key: "
            f"max euler_first {int(np.max(tax.euler_first))} >= 2^25 "
            f"(~16.7M tour entries, ~8.4M nodes); use the host taxonomer"
        )
    return DeviceTaxonomy(
        euler_first=jax.device_put(np.asarray(tax.euler_first, np.int32)),
        euler_node=jax.device_put(np.asarray(tax.euler_node, np.int32)),
        euler_depth=jax.device_put(np.asarray(tax._euler_depth, np.int32)),
        sparse=jax.device_put(np.asarray(tax.sparse, np.int32)),
        parent=jax.device_put(np.asarray(tax.parent, np.int32)),
    )


def seg_broadcast(flag, val):
    """Propagate ``val`` forward from flagged rows through each run
    (segmented broadcast as an associative scan instead of per-element
    scatters/gathers)."""
    def op(a, b):
        af, av = a
        bf, bv = b
        return af | bf, jnp.where(bf, bv, av)

    return jax.lax.associative_scan(op, (flag, val))[1]


def seg_suffix_or(blk_last, val):
    """Segmented suffix-OR: row i gets OR(val[i:]) within its run, where
    ``blk_last`` marks each run's last row."""
    def op(a, b):
        af, av = a
        bf, bv = b
        return af | bf, bv | (~bf & av)

    f, v = jax.lax.associative_scan(
        op, (jnp.flip(blk_last), jnp.flip(val))
    )
    return jnp.flip(v)


def lca_pairs(dt: DeviceTaxonomy, a: jax.Array, b: jax.Array) -> jax.Array:
    """Vectorized LCA of internal-id arrays; 0 propagates the other side."""
    fa = dt.euler_first[jnp.maximum(a, 0)]
    fb = dt.euler_first[jnp.maximum(b, 0)]
    lo = jnp.minimum(fa, fb)
    hi = jnp.maximum(fa, fb)
    length = hi - lo + 1
    k = 31 - jax.lax.clz(length)
    left = dt.sparse[k, lo]
    right = dt.sparse[k, hi - (jnp.int32(1) << k) + 1]
    pick_right = dt.euler_depth[right] < dt.euler_depth[left]
    res = dt.euler_node[jnp.where(pick_right, right, left)]
    return jnp.where(a <= 0, b, jnp.where(b <= 0, a, res))


class QuotientResult(NamedTuple):
    # flat per-(read, species, quotient) rows, compacted to `max_rows`
    row_read: jax.Array     # [R] int32 (INT32_MAX padding)
    row_species: jax.Array  # [R] int32
    row_taxid: jax.Array    # [R] int32 LCA'd best taxid of the quotient
    n_rows: jax.Array       # [] int32
    n_ties: jax.Array       # [] int32 rows whose tie set needed a real LCA


@functools.partial(
    jax.jit, static_argnames=("dna_shift", "max_rows", "tie_budget")
)
def quotient_best(
    dt: DeviceTaxonomy,
    qid, species, pos, hamming, taxid,  # [M] int32 sorted match arrays
    valid,                              # [M] bool
    *,
    dna_shift: int,
    max_rows: int,
    tie_budget: int = 0,
) -> QuotientResult:
    M = qid.shape[0]
    quot = pos // dna_shift
    # quotients span frames, but matches arrive frame-major — re-sort so
    # each (read, species, quotient) set is one contiguous segment
    # (`filterRedundantMatches` walks the whole species range, all frames).
    # The 4th KEY is (hamming << 25 | euler_first[taxid]): within a segment
    # the minimum-hamming ties come first, ordered by Euler first-occurrence
    # — so the tie set's extremal Euler pair (all the LCA needs) falls out
    # of segment-head/ tie-block-end SCANS, with no scatter tables at all.
    # hamming <= 7 post-cutoff; euler positions < 2^25 (tour = 2N+1 entries,
    # so ~8.4M nodes — enforced by device_taxonomy()).
    big_key = jnp.int32(2**31 - 1)
    k_qid = jnp.where(valid, qid, big_key)
    ef_all = jnp.clip(
        dt.euler_first[jnp.maximum(taxid, 0)], 0, (1 << 25) - 1
    )
    hamef_key = (jnp.minimum(hamming, 63) << 25) | ef_all
    qid, species, quot, hamef = jax.lax.sort(
        (k_qid, species, quot, hamef_key),
        num_keys=4,
    )
    valid = qid != big_key
    seg_new = jnp.ones(M, bool)
    seg_new = seg_new.at[1:].set(
        ~(
            (qid[1:] == qid[:-1])
            & (species[1:] == species[:-1])
            & (quot[1:] == quot[:-1])
        )
    )
    seg_new = seg_new | ~valid

    # segment head carries (min hamming, min Euler-first) of the tie set
    head_hamef = seg_broadcast(seg_new, hamef)
    ham_row = hamef >> 25
    efmin_row = head_hamef & jnp.int32((1 << 25) - 1)
    # tie-block end carries the max Euler-first: blocks are (segment, ham)
    # runs; reverse-broadcast ef from each block's last row
    blk_new = seg_new.at[1:].set(seg_new[1:] | (ham_row[1:] != ham_row[:-1]))
    blk_last = jnp.concatenate([blk_new[1:], jnp.ones(1, bool)])
    ef_row = hamef & jnp.int32((1 << 25) - 1)
    efmax_row = jnp.flip(
        seg_broadcast(jnp.flip(blk_last), jnp.flip(ef_row))
    )

    first_of_seg = seg_new & valid
    # partition sort (see pipeline._classify_core): segment heads compact
    # to the front in slot order, cheaper than nonzero's scatter lowering.
    # qid/species and the (efmin, efmax) pair ride as payloads — payload
    # operands cost ~1 ms per [M]; the per-row gathers they replace cost
    # ~6-10 ns per 32-bit element (the old LCA block was ~30 ms/batch).
    slot = jnp.arange(M, dtype=jnp.int32)
    INT32_MAX = jnp.int32(2**31 - 1)
    efp = (
        efmin_row.astype(jnp.uint64) << jnp.uint64(32)
    ) | efmax_row.astype(jnp.uint64)
    rows, s_qid, s_sp, s_efp = jax.lax.sort(
        (jnp.where(first_of_seg, slot, INT32_MAX), qid, species, efp),
        num_keys=1,
    )

    def pad_to(x, fill):
        if x.shape[0] < max_rows:  # budget may exceed the match capacity
            x = jnp.pad(x, (0, max_rows - x.shape[0]),
                        constant_values=fill)
        return x[:max_rows]

    rows = pad_to(rows, 2**31 - 1)
    s_qid, s_sp, s_efp = pad_to(s_qid, 0), pad_to(s_sp, 0), pad_to(s_efp, 0)
    pad = rows == INT32_MAX
    L1 = dt.euler_node.shape[0] - 1
    efmin_r = jnp.clip(
        jax.lax.bitcast_convert_type(
            (s_efp >> jnp.uint64(32)).astype(jnp.uint32), jnp.int32),
        0, L1)
    efmax_r = jnp.clip(
        jax.lax.bitcast_convert_type(
            (s_efp & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32), jnp.int32),
        efmin_r, L1)
    # a quotient whose min-hamming tie set holds ONE distinct Euler
    # position needs no range query: euler_node[euler_first[t]] == t.
    row_taxid = dt.euler_node[efmin_r]
    if tie_budget:
        # compact the (rare) genuine tie ranges and run the sparse-table
        # range-min only on them; overflow reported for the retry ladder
        tie = ~pad & (efmax_r > efmin_r)
        n_ties = jnp.sum(tie.astype(jnp.int32))
        ridx = jnp.arange(max_rows, dtype=jnp.int32)
        trows, t_efp = jax.lax.sort(
            (jnp.where(tie, ridx, INT32_MAX), s_efp), num_keys=1
        )
        if trows.shape[0] < tie_budget:
            trows = jnp.pad(trows, (0, tie_budget - trows.shape[0]),
                            constant_values=2**31 - 1)
            t_efp = jnp.pad(t_efp, (0, tie_budget - t_efp.shape[0]))
        trows = trows[:tie_budget]
        t_efp = t_efp[:tie_budget]
        lo_r = jnp.clip(
            jax.lax.bitcast_convert_type(
                (t_efp >> jnp.uint64(32)).astype(jnp.uint32), jnp.int32),
            0, L1)
        hi_r = jnp.clip(
            jax.lax.bitcast_convert_type(
                (t_efp & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32),
                jnp.int32),
            lo_r, L1)
        length = hi_r - lo_r + 1
        kk = 31 - jax.lax.clz(length)
        left = dt.sparse[kk, lo_r]
        right = dt.sparse[kk, hi_r - (jnp.int32(1) << kk) + 1]
        pick_right = dt.euler_depth[right] < dt.euler_depth[left]
        lca = dt.euler_node[jnp.where(pick_right, right, left)]
        # write back; INT32_MAX pad indices fall out of range and drop
        row_taxid = row_taxid.at[trows].set(lca, mode="drop")
    else:
        # no tie compaction: full-width range query on every row
        n_ties = jnp.int32(0)
        length = efmax_r - efmin_r + 1
        kk = 31 - jax.lax.clz(length)
        left = dt.sparse[kk, efmin_r]
        right = dt.sparse[kk, efmax_r - (jnp.int32(1) << kk) + 1]
        pick_right = dt.euler_depth[right] < dt.euler_depth[left]
        row_taxid = dt.euler_node[jnp.where(pick_right, right, left)]
    return QuotientResult(
        row_read=jnp.where(pad, INT32_MAX, s_qid),
        row_species=jnp.where(pad, INT32_MAX, s_sp),
        row_taxid=jnp.where(pad, 0, row_taxid),
        n_rows=jnp.sum(first_of_seg.astype(jnp.int32)),
        n_ties=n_ties,
    )
