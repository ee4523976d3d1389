"""Full device taxonomer: matches -> per-read classifications.

Composes the oracle-verified device blocks (chain DP, path combination,
quotient redundancy reduction) into one flow equivalent to
``Taxonomer::chooseBestTaxon`` (`/root/reference/src/commons/Taxonomer.cpp:130-202`):

  device: chain -> paths -> per-(read, species) combined scores
          + per-(read, species, quotient) best taxids
  host:   species selection (ties -> taxonomy LCA), min-score /
          min-sp-score branches, clade-count BFS below species, EM mappings

Only the small per-group tensors leave the device (~3 ints per distinct
quotient instead of 5 per match). This IS the default classifier path
(``params.device_tax=1``; ``--device-tax 0`` or ``--print-log`` fall back
to the host taxonomer), cross-validated byte-identically against the
Python and native-C++ taxonomers by the differential tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _pow2(n: int, cap: int) -> int:
    v = 1024
    while v < n:
        v *= 2
    return min(v, cap)


@functools.partial(
    jax.jit,
    static_argnames=("path_budget", "g_budget", "max_rows", "dna_shift",
                     "p_max", "n_blocks", "w", "k", "max_shift",
                     "kmer_format"),
)
def _full_program(dt, qid_a, sp_a, frame_a, pos_a, ham_a, dna_a, tax_a,
                  h16_a, valid_a, min_depth, rl, *, path_budget, g_budget,
                  max_rows, dna_shift, p_max, n_blocks, w, k, max_shift,
                  kmer_format):
    """Single-dispatch device taxonomer: chain DP -> path compaction ->
    combine -> group compaction -> quotient reduction."""
    from .device_compact import compact_groups, compact_paths

    chain_res = chain_matches(
        qid_a, sp_a, frame_a, pos_a, ham_a, dna_a, h16_a, valid_a,
        min_depth, n_blocks=n_blocks, w=w, k=k, max_shift=max_shift,
        kmer_format=kmer_format,
    )
    flat = compact_paths(chain_res, budget=path_budget)
    comb = combine_paths(
        flat.read, flat.species, flat.start, flat.end, flat.score,
        flat.ham, flat.sh16, flat.eh16, flat.valid, rl,
        n_groups=g_budget, p_max=p_max,
    )
    groups = compact_groups(comb, budget=g_budget)
    qres = quotient_best(
        dt, qid_a, sp_a, pos_a, ham_a, tax_a, valid_a,
        dna_shift=dna_shift, max_rows=max_rows,
    )
    overflow = (
        (flat.n_paths > path_budget).astype(jnp.int32)
        + comb.fallback.any().astype(jnp.int32)
        + (groups.n_groups > g_budget).astype(jnp.int32)
        + chain_res.fallback.any().astype(jnp.int32)
        + (chain_res.n_real_blocks > n_blocks).astype(jnp.int32)
    )
    counts = jnp.stack([groups.n_groups, qres.n_rows, overflow])
    return groups, qres, counts


from .device_chain import chain_matches
from .device_combine import combine_paths
from .device_redundancy import device_taxonomy, quotient_best
from .taxonomer import ReadClassification, TaxonomerParams

INT32_MAX = np.int32(2**31 - 1)  # np literal: a module-level jax scalar takes the first shard_map mesh into its cached aval and poisons later traces under a different mesh


@functools.partial(
    jax.jit,
    static_argnames=(
        # classify statics
        "n_db", "search_iters", "cap", "max_matches", "reduced", "syncmer",
        "smer_len", "kmer_format", "prefix_bits", "cap2", "cap_ov_budget",
        "packed_search", "direct_bits", "hit_budget", "sovf_budget",
        "direct2_bits", "resid_budget", "codes_packed", "deep_w",
        "cap_ovd_budget",
        # taxonomer statics
        "path_budget", "g_budget", "max_rows", "taxcnt_budget", "dna_shift",
        "p_max", "n_blocks", "w", "k", "max_shift", "ov_budget",
        "tie_budget",
    ),
)
def _fused_classify_tax(
    db,
    tax2species,
    dt, min_depth, rl,
    codes, lens, pos_offsets, qid_offsets,
    *,
    n_db, search_iters, cap, max_matches, reduced, syncmer, smer_len,
    kmer_format, prefix_bits, cap2, cap_ov_budget, path_budget, g_budget,
    max_rows, taxcnt_budget, dna_shift, p_max, n_blocks, w, k, max_shift,
    ov_budget, packed_search=False, direct_bits=0, hit_budget=0,
    sovf_budget=0, direct2_bits=0, resid_budget=0, codes_packed=False,
    tie_budget=0, deep_w=0, cap_ovd_budget=0,
):
    """One device program: encoded reads -> per-(read, species) combined
    scores + per-(read, species, taxid) quotient-count rows.

    Fuses the match pipeline (`pipeline._classify_core`) with the device
    taxonomer blocks so the 20-byte-per-match tensors never leave the
    device — only the tiny group/taxcount tensors transfer (the
    full-device analogue of `Classifier::assignTaxonomy`,
    `Classifier.cpp:166-208`)."""
    from .device_compact import compact_groups, compact_paths
    from .pipeline import _classify_core

    s_qid, s_species, s_pos, s_dna, s_taxid, s_packed, cls_counts = (
        _classify_core(
            db, tax2species,
            codes, lens, pos_offsets, qid_offsets,
            n_db=n_db, search_iters=search_iters, cap=cap,
            max_matches=max_matches, reduced=reduced, syncmer=syncmer,
            smer_len=smer_len, kmer_format=kmer_format,
            prefix_bits=prefix_bits, cap2=cap2, ov_budget=cap_ov_budget,
            packed_search=packed_search, direct_bits=direct_bits,
            hit_budget=hit_budget, sovf_budget=sovf_budget,
            direct2_bits=direct2_bits, resid_budget=resid_budget,
            codes_packed=codes_packed, deep_w=deep_w,
            ovd_budget=cap_ovd_budget,
        )
    )
    packed, ov_packed, counts = taxonomer_tail(
        s_qid, s_species, s_pos, s_dna, s_taxid, s_packed, cls_counts,
        dt, min_depth, rl,
        path_budget=path_budget, g_budget=g_budget, max_rows=max_rows,
        taxcnt_budget=taxcnt_budget, dna_shift=dna_shift, p_max=p_max,
        n_blocks=n_blocks, w=w, k=k, max_shift=max_shift,
        ov_budget=ov_budget, kmer_format=kmer_format,
        tie_budget=tie_budget,
    )
    if hit_budget and sovf_budget:
        # direct-search hit/overflow lists truncated: dropped candidate
        # rows make the results wrong — flag for the retry ladder (bit 6;
        # drain_fused folds the true counters into the hints first)
        s_ov = (
            (cls_counts[4] > hit_budget) | (cls_counts[5] > sovf_budget)
            | (cls_counts[6] > (resid_budget or (1 << 30)))
            | (cls_counts[7] > (cap_ovd_budget or (1 << 30)))
        ).astype(jnp.int32)
        counts = counts.at[2].set(counts[2] | (s_ov << 6))
    return packed, ov_packed, counts


def taxonomer_tail(
    s_qid, s_species, s_pos, s_dna, s_taxid, s_packed, cls_counts,
    dt, min_depth, rl, *,
    path_budget, g_budget, max_rows, taxcnt_budget, dna_shift, p_max,
    n_blocks, w, k, max_shift, ov_budget, kmer_format, tie_budget=0,
):
    """Sorted match columns -> (packed small tensors, counters).

    The device taxonomer blocks shared by the single-chip fused program
    and the sharded (mesh) fused program: chain DP -> path compaction ->
    combine -> group compaction -> quotient reduction -> taxcnt runs."""
    from .device_compact import compact_groups, compact_paths

    valid = s_qid != INT32_MAX
    s_frame = jnp.where(valid, s_packed & 7, 0)
    s_ham = jnp.where(valid, (s_packed >> 3) & 0xFF, 0)
    s_h16 = jnp.where(valid, (s_packed >> 11) & 0xFFFF, 0)

    chain_res = chain_matches(
        s_qid, s_species, s_frame, s_pos, s_ham, s_dna, s_h16, valid,
        min_depth, n_blocks=n_blocks, w=w, k=k, max_shift=max_shift,
        kmer_format=kmer_format,
    )
    flat = compact_paths(chain_res, budget=path_budget)
    comb = combine_paths(
        flat.read, flat.species, flat.start, flat.end, flat.score,
        flat.ham, flat.sh16, flat.eh16, flat.valid, rl,
        n_groups=g_budget, p_max=p_max, ov_budget=ov_budget,
    )
    groups = compact_groups(comb, budget=g_budget)
    qres = quotient_best(
        dt, s_qid, s_species, s_pos, s_ham, s_taxid, valid,
        dna_shift=dna_shift, max_rows=max_rows, tie_budget=tie_budget,
    )

    # aggregate quotient rows to (read, species, taxid, count) on device:
    # the host only ever needs per-taxid quotient counts (taxCnt,
    # `Taxonomer.cpp:160-171`), which is a far smaller tensor
    rr, rs, rt = jax.lax.sort(
        (qres.row_read, qres.row_species, qres.row_taxid), num_keys=3
    )
    vrow = rr != INT32_MAX
    new = jnp.ones(rr.shape, bool)
    new = new.at[1:].set(
        (rr[1:] != rr[:-1]) | (rs[1:] != rs[:-1]) | (rt[1:] != rt[:-1])
    )
    new = new & vrow
    R = rr.shape[0]
    n_taxcnt = jnp.sum(new.astype(jnp.int32))
    # run lengths via next-head positions (head compaction by partition
    # sort; nonzero/scatter lowerings cost ~10ns per source row)
    idx_r = jnp.arange(R, dtype=jnp.int32)
    firsts = jax.lax.sort(jnp.where(new, idx_r, jnp.int32(2**31 - 1)))
    if firsts.shape[0] < taxcnt_budget:
        firsts = jnp.pad(firsts, (0, taxcnt_budget - firsts.shape[0]),
                         constant_values=2**31 - 1)
    firsts = firsts[:taxcnt_budget]
    tpad = firsts == jnp.int32(2**31 - 1)
    tsafe = jnp.minimum(firsts, R - 1)
    # NB: jnp.sum promotes int32 -> int64 under x64; an int64 operand
    # would silently upcast the packed output concat and shift its layout
    n_valid_rows = jnp.sum(vrow.astype(jnp.int32)).astype(jnp.int32)
    next_head = jnp.concatenate(
        [firsts[1:], jnp.full(1, 2**31 - 1, jnp.int32)]
    )
    run_end = jnp.minimum(next_head, n_valid_rows)
    t_read = jnp.where(tpad, INT32_MAX, rr[tsafe])
    t_species = jnp.where(tpad, INT32_MAX, rs[tsafe])
    t_taxid = jnp.where(tpad, 0, rt[tsafe])
    t_count = jnp.where(tpad, 0, run_end - tsafe)

    # bit flags so the retry ladder can target the exhausted resource;
    # path-slot (p_max) overflow is NOT fatal — those groups' paths ship to
    # the host for an exact re-combine (bit 2 = the shipment overflowed)
    tax_overflow = (
        (chain_res.fallback.any()
         | (chain_res.n_real_blocks > n_blocks)).astype(jnp.int32)
        | ((flat.n_paths > path_budget).astype(jnp.int32) << 1)
        | ((comb.n_ov > ov_budget).astype(jnp.int32) << 2)
        | ((groups.n_groups > g_budget).astype(jnp.int32) << 3)
        | ((qres.n_rows > max_rows).astype(jnp.int32) << 4)
        | ((n_taxcnt > taxcnt_budget).astype(jnp.int32) << 5)
        # bit 6 is the direct-search budget flag (_fused_classify_tax)
        | (jnp.int32(tie_budget > 0)
           * (qres.n_ties > tie_budget).astype(jnp.int32) << 7)
    )
    counts = jnp.stack([
        groups.n_groups, n_taxcnt, tax_overflow,
        cls_counts[0], cls_counts[1], cls_counts[2], comb.n_ov,
        flat.n_paths, qres.n_rows, cls_counts[3],
        chain_res.n_real_blocks,
        cls_counts[4], cls_counts[5],   # direct-search hit / overflow
        qres.n_ties,
        cls_counts[6],                  # dmap2 double-collision residuals
        cls_counts[7],                  # deep-tier (aligned) overflow rows
    ])
    # ONE packed int32 output: every routinely-fetched tensor concatenated
    # at static offsets, so a drain is one small transfer instead of a
    # dozen slice+fetch ops. The p_max-overflow path rows ship as a
    # SEPARATE output fetched only when n_ov_paths > 0 — they are zero on
    # typical batches and would otherwise dominate the transfer volume.
    bc = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    packed = jnp.concatenate([
        groups.read, groups.species, bc(groups.score),
        t_read, t_species, t_taxid, t_count,
    ])
    ov_packed = jnp.concatenate([
        comb.ov_read, comb.ov_species, comb.ov_start, comb.ov_end,
        bc(comb.ov_score), comb.ov_ham, comb.ov_sh16, comb.ov_eh16,
    ])
    return packed, ov_packed, counts


class DeviceTaxonomer:
    """Batch taxonomer using the device blocks; host finishes per read."""

    def __init__(self, params: TaxonomerParams, taxonomy):
        self.p = params
        self.tax = taxonomy
        self.dt = device_taxonomy(taxonomy)
        self.hints: dict[str, int] = {}
        self._nt = None       # lazy NativeTaxonomer (shared taxonomy arrays)
        self._nt_tried = False
        # euk-aware min depth per species (dense internal ids)
        n = taxonomy.n_nodes()
        euk = np.zeros(n + 1, bool)
        if taxonomy.eukaryota_id:
            e = taxonomy.eukaryota_id
            for i in range(1, n + 1):
                euk[i] = taxonomy.is_ancestor(e, i)
        self.min_depth = np.where(
            euk, params.min_cons_cnt_euk, params.min_cons_cnt
        ).astype(np.int32)

    # ------------------------------------------------------------- fused path
    def fused_sizes(self, n_reads: int, max_matches: int,
                    max_read_len: int, p_max: int = 16,
                    scale: int = 1) -> dict:
        """Static grid sizes for the fused program. Without hints the sizes
        are conservative batch-shape bounds; after a warmup batch measured
        through the plain path (``set_hints``) every data-dependent grid is
        right-sized to observed statistics + headroom (every padded grid
        cell costs device memory and compute). ``scale`` widens the
        data-dependent grids on overflow retries."""
        h = self.hints

        def pow2(n, lo=1024, hi=1 << 23):
            """Quarter-pow2 quantization: {1, 1.25, 1.5, 1.75} x 2^k.
            Budgeted tensors (tier gathers, compaction sorts, chain grids)
            cost per padded cell, so plain pow2's up-to-2x slack was ~15%
            of the big-world batch; quarter steps cap the slack at 25%
            while still bounding the number of possible program variants."""
            n = min(max(n, lo), hi)
            v = lo
            while v * 2 < n:
                v *= 2
            for m in (4, 5, 6, 7, 8):
                c = v * m // 4
                if c >= n:
                    return min(c, hi)
            return min(v * 2, hi)

        # columns = position-quotient span of one (read, species, frame)
        # block; paired mates share a block, so max_read_len covers both
        # (span <= (read_len - 21) / 3, see Taxonomer.cpp:487-648 pos math)
        w = max(16, -(-(max(max_read_len - 21, 3) // 3 + 3) // 16) * 16)
        w = min(w, 2048)
        if h.get("nb"):
            n_blocks = pow2(int(h["nb"] * 1.3) * scale)
        else:
            n_blocks = pow2(min(16 * n_reads * scale, max(max_matches, 2),
                                1 << 21))
        if h.get("k"):
            k = max(2, int(h["k"])) * scale
        else:
            k = 4 * scale
        if h.get("paths"):
            path_budget = pow2(int(h["paths"] * 1.5) * scale)
        else:
            path_budget = pow2(min(max(max_matches, 2) * scale, 1 << 23))
        if h.get("groups"):
            g_budget = pow2(int(h["groups"] * 1.3) * scale)
        else:
            g_budget = pow2(8 * n_reads * scale)
        if h.get("rows"):
            max_rows = pow2(int(h["rows"] * 1.3) * scale)
        else:
            max_rows = pow2(max(max_matches, 2) * scale)
        if h.get("taxcnt"):
            taxcnt_budget = pow2(int(h["taxcnt"] * 1.5) * scale)
        else:
            taxcnt_budget = 4 * g_budget
        ov_budget = pow2(max(1024, int(h.get("ov", 0)) * 2) * scale,
                         lo=1024, hi=1 << 20) if h.get("ov") is not None \
            else 16384 * scale
        # direct-search budgets: 0 (classic full-width search) until a
        # warmup batch has seeded the hit-density hints
        if h.get("hits"):
            hit_budget = pow2(int(h["hits"] * 1.3) * scale)
            # "sovf" is drain-observed (margined 1.5x here); "sovf_bound"
            # is an analytic upper bound that already carries its margin
            # (bench seed_search_hints) — both must stay static across
            # batches, so take the max of the two sizings
            sovf_budget = pow2(
                max(8192, int(h.get("sovf", 0) * 1.5),
                    int(h.get("sovf_bound", 0))) * scale)
            # dmap2 double-collision residuals: a small tail of pass-2
            # ("sovf2" drain-observed; "sovf2_bound" analytic, pre-margined)
            resid_budget = pow2(
                max(4096, int(h.get("sovf2", 0) * 2),
                    int(h.get("sovf2_bound", 0))) * scale, lo=4096)
        else:
            hit_budget = sovf_budget = resid_budget = 0
        # tie rows needing a real LCA range query are a small fraction of
        # the quotient rows; compacting them caps the sparse-table gathers
        # (0 = no compaction: full-width LCA, always correct)
        if h.get("ties") is not None:
            tie_budget = pow2(max(8192, int(h["ties"] * 2)) * scale,
                              lo=8192, hi=1 << 22)
        else:
            tie_budget = 0
        return dict(
            path_budget=path_budget, g_budget=g_budget, max_rows=max_rows,
            taxcnt_budget=taxcnt_budget, dna_shift=self.p.dna_shift,
            p_max=p_max, n_blocks=n_blocks, w=w, k=k,
            max_shift=self.p.max_codon_shift, ov_budget=ov_budget,
            hit_budget=hit_budget, sovf_budget=sovf_budget,
            resid_budget=resid_budget, tie_budget=tie_budget,
        )

    def set_hints(self, m: dict, dna_shift: int) -> None:
        """Derive fused grid sizes from a warmup batch's host match dict
        (sorted reference order). Hints only grow (max-accumulate) so the
        compiled fused program is reused across batches."""
        q, sp, fr, pos = m["qid"], m["species"], m["frame"], m["pos"]
        n = len(q)
        if n == 0:
            return
        nb = np.ones(n, bool)
        nb[1:] = (q[1:] != q[:-1]) | (sp[1:] != sp[:-1]) | (fr[1:] != fr[:-1])
        n_blocks = int(nb.sum())
        bid = np.cumsum(nb) - 1
        cell = np.ones(n, bool)
        cell[1:] = nb[1:] | (pos[1:] != pos[:-1])
        ties = np.bincount(np.cumsum(cell) - 1)
        # quotient segments span frames: resort by (read, species, quot)
        # exactly like quotient_best before counting runs
        quot = pos // dna_shift
        qorder = np.lexsort((quot, sp, q))
        q2, sp2, quot2 = q[qorder], sp[qorder], quot[qorder]
        segs = np.ones(n, bool)
        segs[1:] = (q2[1:] != q2[:-1]) | (sp2[1:] != sp2[:-1]) | (
            quot2[1:] != quot2[:-1]
        )
        seg_sizes = np.bincount(np.cumsum(segs) - 1)
        # segments with >= 2 matches at the minimum hamming bound the
        # device tie-LCA compaction (superset: equal-taxid ties collapse
        # to a single Euler position on device and need no range query).
        # Callers without a hamming column (e.g. the distributed drain's
        # per-row sub-dicts) leave the tie hint unseeded: tie_budget then
        # stays 0 = full-width LCA, which is always correct.
        n_tie = None
        if "hamming" in m:
            ham = m["hamming"]
            horder = np.lexsort((ham, quot, sp, q))
            hq, hsp, hqt, hh = (q[horder], sp[horder], quot[horder],
                                ham[horder])
            hsegs = np.ones(n, bool)
            hsegs[1:] = (
                (hq[1:] != hq[:-1]) | (hsp[1:] != hsp[:-1])
                | (hqt[1:] != hqt[:-1])
            )
            hsegid = np.cumsum(hsegs) - 1
            head_ham = hh[np.flatnonzero(hsegs)][hsegid]
            cnt_min = np.bincount(hsegid[hh == head_ham])
            n_tie = int((cnt_min >= 2).sum())
        groups = np.ones(n, bool)
        groups[1:] = (q[1:] != q[:-1]) | (sp[1:] != sp[:-1])
        h = self.hints
        upd = {
            "nb": n_blocks,
            "k": int(ties.max()) if len(ties) else 1,
            # paths are bounded by blocks x path starts; observed data shows
            # ~1-2 per block (2x seed + fused_sizes' 1.5x + pow2 rounding
            # give >= 3x headroom; drain_fused folds in observed counts and
            # the overflow retry ladder recompiles if a batch still bursts)
            "paths": 2 * n_blocks,
            "rows": int(segs.sum()),
            "groups": int(groups.sum()),
            # distinct (read, species, taxid) triples aggregate far below
            # the quotient-row count; start near the group count and let
            # drain_fused's observed n_taxcnt correct it
            "taxcnt": 2 * int(groups.sum()),
            "ov": 1024,
            # pass-1 hit slots: kept matches are a lower bound on hits
            # (chance same-AA candidates can fail the Hamming cutoff), so
            # seed generously: these seeds should DOMINATE the typical
            # observed counters drain_fused folds back in, since a hint
            # growth mid-run compiles another fused-program variant
            # (ROADMAP Design 2 decides whether the margin still pays).
            "hits": int(1.25 * n),
            "sovf": max(8192, n // 8),
            # dmap2 double collisions run a few % of sovf; seed at a
            # quarter of the sovf seed so it dominates observed counts
            "sovf2": max(4096, n // 32),
        }
        if n_tie is not None:
            upd["ties"] = n_tie
        for key, val in upd.items():
            h[key] = max(h.get(key, 0), val)

    def dispatch_fused(self, index, d_species, codes, lens, pos_offsets,
                       qid_offsets, n_reads: int, max_read_len: int, *,
                       cap: int, max_matches: int, reduced: bool,
                       syncmer: bool, smer_len: int, kmer_format: int,
                       read_lens_by_qid: np.ndarray, p_max: int = 16,
                       scale: int = 1, cap2: int = 0,
                       cap_ov_budget: int = 0, codes_packed=None,
                       cap_ovd_budget: int = 0):
        """Launch the fused classify+taxonomer program (async).

        ``codes_packed=True`` marks ``codes`` as already nibble-packed
        (e.g. pre-staged on device with ``pipeline.pack_codes`` +
        ``jax.device_put``); None = pack host arrays automatically."""
        sizes = self.fused_sizes(n_reads, max_matches, max_read_len, p_max,
                                 scale)
        kw = dict(
            n_db=index.n, search_iters=index.search_iters, cap=cap,
            max_matches=max_matches, reduced=reduced, syncmer=syncmer,
            smer_len=smer_len, kmer_format=kmer_format,
            prefix_bits=index.prefix_bits, cap2=cap2,
            cap_ov_budget=cap_ov_budget,
            packed_search=index.packed_search,
            direct_bits=index.direct_bits,
            direct2_bits=index.direct2_bits, deep_w=index.deep_w,
            cap_ovd_budget=cap_ovd_budget, **sizes,
        )
        rl = np.zeros(max(n_reads, 1), np.int32)
        rl[: len(read_lens_by_qid)] = read_lens_by_qid
        # nibble-pack the read matrix: half the host->device volume
        from .pipeline import pack_codes

        if codes_packed is None:
            if isinstance(codes, np.ndarray):
                codes = pack_codes(codes)
                kw["codes_packed"] = True
        elif codes_packed:
            kw["codes_packed"] = True
        args = (
            index.db, d_species, self.dt, self.min_depth, rl,
            codes, lens, pos_offsets, qid_offsets,
        )
        packed, ov_packed, counts = _fused_classify_tax(*args, **kw)
        # the ov section transfers only on the rare p_max-overflow batches
        packed.copy_to_host_async()
        counts.copy_to_host_async()
        return (packed, ov_packed, counts, sizes)

    def drain_fused(self, handle, read_lens_by_qid: np.ndarray,
                    n_reads: int):
        """Fetch the small tensors; returns (results | None, info).

        results is None when the device grids overflowed (caller falls back
        to the host taxonomer); info carries the classify counters for the
        cap/budget retry logic (`Classifier.cpp:127-131`). Groups whose
        path count exceeded the device slot capacity arrive as raw path
        rows and are re-combined exactly on the host."""
        packed_dev, ov_dev, counts, sizes = handle
        counts = np.asarray(counts)
        info = {
            "n_groups": int(counts[0]),
            "n_taxcnt": int(counts[1]),
            "tax_overflow": int(counts[2]),
            "n_matches": int(counts[3]),
            "n_over_cap": int(counts[4]),
            "total_kmers": int(counts[5]),
            "n_ov_paths": int(counts[6]),
            "n_paths": int(counts[7]),
            "n_rows": int(counts[8]),
            "n_ov_cap": int(counts[9]),
            "n_real_blocks": int(counts[10]),
            "n_hits1": int(counts[11]) if counts.shape[0] > 11 else 0,
            "n_sovf": int(counts[12]) if counts.shape[0] > 12 else 0,
            "n_ties": int(counts[13]) if counts.shape[0] > 13 else 0,
            "n_sovf2": int(counts[14]) if counts.shape[0] > 14 else 0,
            "n_ovd": int(counts[15]) if counts.shape[0] > 15 else 0,
        }
        # observed stats feed the sticky hints so overflow retries (and
        # later batches) compile right-sized programs
        h = self.hints
        h["nb"] = max(h.get("nb", 0), info["n_real_blocks"])
        h["paths"] = max(h.get("paths", 0), info["n_paths"])
        h["rows"] = max(h.get("rows", 0), info["n_rows"])
        h["ov"] = max(h.get("ov", 0), info["n_ov_paths"])
        h["taxcnt"] = max(h.get("taxcnt", 0), info["n_taxcnt"])
        if info["n_ties"]:
            h["ties"] = max(h.get("ties", 0), info["n_ties"])
        if info["n_hits1"]:
            h["hits"] = max(h.get("hits", 0), info["n_hits1"])
            h["sovf"] = max(h.get("sovf", 0), info["n_sovf"])
            h["sovf2"] = max(h.get("sovf2", 0), info["n_sovf2"])
        if info["tax_overflow"]:
            return None, info
        results = [ReadClassification() for _ in range(n_reads)]
        n_g = info["n_groups"]
        if n_g == 0:
            return results, info
        # single transfer of the packed small-tensor block (sections at
        # static offsets; the async copy was started at dispatch time)
        packed = np.asarray(packed_dev)
        G = sizes["g_budget"]
        T = sizes["taxcnt_budget"]
        OV = sizes["ov_budget"]
        g_read = packed[:n_g]
        g_sp = packed[G : G + n_g]
        g_score = packed[2 * G : 2 * G + n_g].view(np.float32).copy()
        n_t = info["n_taxcnt"]
        base = 3 * G
        trows = [packed[base + i * T : base + i * T + n_t] for i in range(4)]
        if info["n_ov_paths"]:
            # rare p_max-overflow rows: fetch the separate ov output now
            ov_np = np.asarray(ov_dev)
            n_ov = min(info["n_ov_paths"], OV)
            ovp = [ov_np[i * OV : i * OV + n_ov] for i in range(8)]
            ovp[4] = ovp[4].view(np.float32)
            g_score = self._recombine_overflow_groups(
                ovp, info["n_ov_paths"], g_read, g_sp, g_score,
                read_lens_by_qid, n_reads,
            )
        results = self._finish(
            g_read, g_sp, g_score,
            trows[0], trows[1], trows[2], trows[3],
            read_lens_by_qid, n_reads, results,
        )
        return results, info

    def _recombine_overflow_groups(self, ovp, n_ov, g_read, g_sp,
                                   g_score, read_lens_by_qid, n_reads):
        """Exact host re-combine (combineMatchPaths,
        `Taxonomer.cpp:410-468`) for groups whose path count exceeded the
        device slot capacity; patches their scores in g_score."""
        F32 = np.float32
        n_ov = min(n_ov, len(ovp[0]))
        o_read, o_sp, o_start, o_end, o_score, o_ham, o_sh16, o_eh16 = ovp

        def part(h16, rng, from_right):
            s = F32(0)
            hd = 0
            for i in range(rng):
                h = (h16 >> (2 * i)) & 3 if from_right else \
                    (h16 >> (14 - 2 * i)) & 3
                s = F32(s + (F32(3.0) if h == 0
                             else F32(2.0) - F32(0.5) * F32(h)))
                hd += h
            return s, hd

        # paths arrive already in (read, species, score desc, ham, -start)
        # order (combine_paths sorts before compacting)
        new_scores: dict[tuple[int, int], np.float32] = {}
        i = 0
        while i < n_ov:
            j = i
            while (j < n_ov and o_read[j] == o_read[i]
                   and o_sp[j] == o_sp[i]):
                j += 1
            accepted: list[list[int]] = []  # [start, end]
            total = F32(0)
            for p_i in range(i, j):
                start, end = int(o_start[p_i]), int(o_end[p_i])
                score = F32(o_score[p_i])
                rejected = False
                for a_s, a_e in accepted:
                    if end < a_s or a_e < start:
                        continue
                    ov = min(end, a_e) - max(start, a_s) + 1
                    if ov == end - start + 1 or ov >= 24:
                        rejected = True
                        break
                    rng = min(max(ov // 3, 0), 8)
                    if start < a_s:  # trim right side
                        r_s, _ = part(int(o_eh16[p_i]), rng, True)
                        end = a_s - 1
                        score = F32(score - r_s - F32(ov % 3))
                    else:  # trim left side
                        l_s, _ = part(int(o_sh16[p_i]), rng, False)
                        start = a_e + 1
                        score = F32(score - l_s - F32(ov % 3))
                if not rejected:
                    accepted.append([start, end])
                    total = F32(total + score)
            rl = int(read_lens_by_qid[int(o_read[i])]) \
                if int(o_read[i]) < len(read_lens_by_qid) else 1
            new_scores[(int(o_read[i]), int(o_sp[i]))] = min(
                F32(total / F32(max(rl, 1))), F32(1.0))
            i = j

        for idx in range(len(g_read)):
            key = (int(g_read[idx]), int(g_sp[idx]))
            if key in new_scores:
                g_score[idx] = new_scores[key]
        return g_score

    # ---------------------------------------------------------- legacy path
    def assign_batch(self, m: dict, read_lens_by_qid: np.ndarray,
                     n_reads: int, valid=None,
                     n_blocks: int | None = None,
                     w: int | None = None) -> list[ReadClassification]:
        p = self.p
        M = int(m["qid"].shape[0])
        if M == 0:
            return [ReadClassification() for _ in range(n_reads)]
        if valid is None:
            valid = np.ones(M, bool)

        # --- device: chain DP. The grid is sized by BLOCK count
        # ((read, species, frame) runs) and read length, not match count;
        # overflow raises for the caller's host fallback.
        if w is None:
            max_q = int(np.max(read_lens_by_qid)) // 3 + 4
            w = 16
            while w < min(max_q, 2048):
                w *= 2
        if n_blocks is None:
            est = max(1024, 8 * n_reads)
            n_blocks = 1
            while n_blocks < min(est, M, 1 << 20):
                n_blocks *= 2
        # --- device: one fused program (chain DP -> compact -> combine ->
        # group compaction -> quotient reduction); only the compact
        # group/quotient tensors and overflow counters transfer.
        results = [ReadClassification() for _ in range(n_reads)]
        path_budget = 1024
        while path_budget < min(max(M, 2), 1 << 22):
            path_budget *= 2
        g_budget = 1024
        while g_budget < 8 * n_reads:
            g_budget *= 2
        max_rows = 1024
        while max_rows < max(M, 2):
            max_rows *= 2

        counts = None
        for p_max in (8, 64):  # retry with more path slots on overflow
            args = (
                self.dt, m["qid"], m["species"], m["frame"], m["pos"],
                m["hamming"], m["dna"], m["taxid"], m["h16"], valid,
                self.min_depth, read_lens_by_qid.astype(np.int32),
            )
            kw = dict(
                path_budget=path_budget, g_budget=g_budget, max_rows=max_rows,
                dna_shift=p.dna_shift, p_max=p_max, n_blocks=n_blocks, w=w,
                k=4, max_shift=p.max_codon_shift, kmer_format=p.kmer_format,
            )
            try:
                groups, qres, counts_dev = _full_program(*args, **kw)
            except ValueError as e:
                if "buffers" not in str(e):
                    raise
                # jax executable-cache aliasing mismatch (constant folding
                # differs between traces with identical signatures): retrace
                _full_program.clear_cache()
                groups, qres, counts_dev = _full_program(*args, **kw)
            counts = np.asarray(counts_dev)
            if not int(counts[2]):
                break
        if int(counts[2]):
            raise NotImplementedError(
                "device taxonomer overflow; host fallback required"
            )
        n_g = int(counts[0])
        if n_g == 0:
            return results
        g_read = np.asarray(groups.read[:_pow2(n_g, g_budget)])[:n_g]
        g_sp = np.asarray(groups.species[:_pow2(n_g, g_budget)])[:n_g]
        g_score = np.asarray(
            groups.score[:_pow2(n_g, g_budget)]
        )[:n_g].astype(np.float32)
        n_rows = int(counts[1])
        np_pad = _pow2(n_rows, max_rows)
        r_read = np.asarray(qres.row_read[:np_pad])[:n_rows]
        r_sp = np.asarray(qres.row_species[:np_pad])[:n_rows]
        r_tax = np.asarray(qres.row_taxid[:np_pad])[:n_rows]

        # aggregate quotient rows to (read, species, taxid, count) runs
        q_order = np.lexsort((r_tax, r_sp, r_read))
        rr, rs, rt = r_read[q_order], r_sp[q_order], r_tax[q_order]
        run_new = np.ones(len(rr), bool)
        run_new[1:] = (
            (rr[1:] != rr[:-1]) | (rs[1:] != rs[:-1]) | (rt[1:] != rt[:-1])
        )
        run_ids = np.cumsum(run_new) - 1
        run_cnt = np.bincount(run_ids) if len(rr) else np.zeros(0, np.int64)
        return self._finish(
            g_read, g_sp, g_score,
            rr[run_new], rs[run_new], rt[run_new], run_cnt,
            read_lens_by_qid, n_reads, results,
        )

    def _native_finish(self, g_read, g_sp, g_score, run_read, run_sp,
                       run_tax, run_cnt, read_lens_by_qid, n_reads, results):
        """OpenMP finish via the native library (None -> Python fallback)."""
        if not self._nt_tried:
            self._nt_tried = True
            try:
                from .native_taxonomer import NativeTaxonomer

                self._nt = NativeTaxonomer(self.p, self.tax)
            except (RuntimeError, OSError):
                self._nt = None
        if self._nt is None:
            return None
        import ctypes

        nt = self._nt
        p = self.p
        lib = nt.lib
        a32 = lambda x: np.ascontiguousarray(x, np.int32)
        out_taxid = np.zeros(n_reads, np.int32)
        out_score = np.zeros(n_reads, np.float32)
        out_cls = np.zeros(n_reads, np.uint8)
        map_cap = (10 * n_reads) if p.em else 1
        mp_read = np.zeros(map_cap, np.int64)
        mp_sp = np.zeros(map_cap, np.int32)
        mp_score = np.zeros(map_cap, np.float32)
        mp_used = ctypes.c_int64(0)
        tc_cap = max(1024, len(run_read) + n_reads)
        tc_read = np.zeros(tc_cap, np.int64)
        tc_tax = np.zeros(tc_cap, np.int32)
        tc_cnt = np.zeros(tc_cap, np.int32)
        tc_used = ctypes.c_int64(0)
        rl = np.zeros(n_reads, np.int32)
        rl[: len(read_lens_by_qid)] = read_lens_by_qid[:n_reads]
        rc = lib.taxonomer_finish(
            ctypes.c_int64(len(g_read)), a32(g_read).ctypes,
            a32(g_sp).ctypes,
            np.ascontiguousarray(g_score, np.float32).ctypes,
            ctypes.c_int64(len(run_read)), a32(run_read).ctypes,
            a32(run_sp).ctypes, a32(run_tax).ctypes, a32(run_cnt).ctypes,
            ctypes.c_int64(n_reads), rl.ctypes,
            ctypes.c_int32(self.tax.n_nodes()),
            nt._parent.ctypes, nt._euler_first.ctypes,
            nt._euler_node.ctypes, nt._sparse.ctypes,
            nt._euler_depth.ctypes,
            ctypes.c_int32(nt._sparse.shape[0]),
            ctypes.c_int64(nt._sparse.shape[1]),
            nt._tin.ctypes, nt._tout.ctypes, nt._species_of.ctypes,
            nt._leafish.ctypes, ctypes.c_int32(self.tax.eukaryota_id),
            ctypes.c_float(p.min_score), ctypes.c_float(p.min_sp_score),
            ctypes.c_float(p.tie_ratio), ctypes.c_int32(p.denominator),
            ctypes.c_int32(p.accession_level),
            ctypes.c_int32(1 if p.em else 0),
            ctypes.c_int32(0),
            out_taxid.ctypes, out_score.ctypes, out_cls.ctypes,
            ctypes.c_int64(tc_cap), tc_read.ctypes, tc_tax.ctypes,
            tc_cnt.ctypes, ctypes.byref(tc_used),
            ctypes.c_int64(map_cap), mp_read.ctypes, mp_sp.ctypes,
            mp_score.ctypes, ctypes.byref(mp_used),
        )
        if rc != 0:
            return None  # output buffer overflow: fall back to Python
        for i in range(n_reads):
            res = results[i]
            res.is_classified = bool(out_cls[i])
            res.taxid = int(out_taxid[i])
            res.score = float(out_score[i])
        for k in range(int(tc_used.value)):
            results[int(tc_read[k])].tax_counts[int(tc_tax[k])] = int(
                tc_cnt[k]
            )
        for k in range(int(mp_used.value)):
            res = results[int(mp_read[k])]
            res.species_scores.append((int(mp_sp[k]), float(mp_score[k])))
            if not res.top_species:
                res.top_species = int(mp_sp[k])
        return results

    def _finish(self, g_read, g_sp, g_score, run_read, run_sp, run_tax,
                run_cnt, read_lens_by_qid, n_reads, results):
        """Host finish: per-read species selection (ties -> LCA), min-score
        branches, below-species BFS — from the small group/taxcount tensors
        (`chooseBestTaxon`, `Taxonomer.cpp:130-202`)."""
        native = self._native_finish(
            g_read, g_sp, g_score, run_read, run_sp, run_tax, run_cnt,
            read_lens_by_qid, n_reads, results,
        )
        if native is not None:
            return native
        p = self.p  # pure-Python fallback below (native lib unavailable)
        # vectorized per-read selection, python only for the rare
        # tie/LCA and below-species BFS cases
        order = np.lexsort((g_sp, g_read))
        g_read, g_sp, g_score = g_read[order], g_sp[order], g_score[order]

        keep = g_score >= p.min_score
        gk_read = g_read[keep]
        gk_sp = g_sp[keep]
        gk_score = g_score[keep].astype(np.float32)

        from .taxonomer import F32, Taxonomer

        host = Taxonomer(p, self.tax)
        if len(gk_read) == 0:
            return results

        # per-read best score and tie counts (getBestSpeciesMatches `:388-407`)
        best_per_read = np.zeros(n_reads, np.float32)
        np.maximum.at(best_per_read, gk_read, gk_score)
        is_tied = gk_score >= best_per_read[gk_read] * np.float32(p.tie_ratio)
        n_tied = np.zeros(n_reads, np.int64)
        np.add.at(n_tied, gk_read[is_tied], 1)
        sum_tied = np.zeros(n_reads, np.float32)
        # reference accumulates in encounter (species-ascending) order
        for i in np.nonzero(is_tied)[0]:
            rid = gk_read[i]
            sum_tied[rid] = np.float32(sum_tied[rid] + gk_score[i])
        meaningful = np.zeros(n_reads, np.int64)
        np.add.at(meaningful, gk_read[gk_score > 0], 1)

        winner = np.zeros(n_reads, np.int64)
        single = n_tied == 1
        w_idx = is_tied & single[gk_read]
        winner[gk_read[w_idx]] = gk_sp[w_idx]

        # winner tax counts from the aggregated runs
        r_ok = (run_read < n_reads) & (
            run_sp == winner[np.clip(run_read, 0, n_reads - 1)]
        )
        tax_counts_per_read: list[dict] = [dict() for _ in range(n_reads)]
        for i in np.nonzero(r_ok)[0]:
            tax_counts_per_read[int(run_read[i])][int(run_tax[i])] = int(
                run_cnt[i]
            )

        em_lists = None
        if p.em:
            em_lists = [[] for _ in range(n_reads)]
            for i in range(len(gk_read)):
                em_lists[int(gk_read[i])].append(
                    (int(gk_sp[i]), F32(gk_score[i]))
                )

        for rid in np.nonzero(meaningful > 0)[0]:
            rid = int(rid)
            res_rc = results[rid]
            if p.em:
                ordered = sorted(em_lists[rid], key=lambda x: -x[1])
                res_rc.top_species = ordered[0][0]
                res_rc.species_scores = [
                    (sp, float(F32(sc) * F32(sc))) for sp, sc in ordered[:10]
                ]
            if n_tied[rid] > 1:
                tie_species = [
                    int(gk_sp[i]) for i in np.nonzero(
                        is_tied & (gk_read == rid)
                    )[0]
                ]
                score = F32(sum_tied[rid] / n_tied[rid])
                res_rc.score = float(score)
                if score == 0 or score < p.min_score:
                    continue
                res_rc.is_classified = True
                res_rc.taxid = self.tax.lca(tie_species)
                continue
            best = int(winner[rid])
            score = F32(sum_tied[rid])
            res_rc.score = float(score)
            if score == 0 or score < p.min_score:
                continue
            tax_cnt = tax_counts_per_read[rid]
            res_rc.tax_counts = tax_cnt
            res_rc.is_classified = True
            if score < p.min_sp_score:
                species = self.tax.species_of[best]
                res_rc.taxid = int(self.tax.parent[species])
            elif p.em:
                res_rc.taxid = best
            else:
                res_rc.taxid = host._lower_rank(
                    tax_cnt, best, int(read_lens_by_qid[rid])
                )
        return results
