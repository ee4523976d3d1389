"""Classification orchestrator: file -> batches -> device -> taxonomy -> reports.

Host-side equivalent of the reference's ``Classifier::startClassify``
(`/root/reference/src/commons/Classifier.cpp:44-164`): streams reads in
batches, runs the fused device pipeline, assigns taxonomy per read, and
writes classifications/report/Krona. Overflow of the candidate cap or the
match budget retries with a larger setting (`Classifier.cpp:127-131`).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import jax
import numpy as np

from ..db.index import MetamerIndex
from ..io import fasta
from ..io.report import Reporter
from ..ops.genetic_code import encode_seqs_padded
from ..params import ClassifyParams
from .pipeline import classify_batch_indexed, matches_to_host
from .taxonomer import ReadClassification, Taxonomer, TaxonomerParams


def _used_len(length: int) -> int:
    return max(0, 3 * ((length - 2) // 3))


def _pow2_round(n: int) -> int:
    v = 1024
    while v < n:
        v *= 2
    return v


def _bucket_len(length: int) -> int:
    """Pad lengths to coarse buckets to bound the number of jit compiles."""
    if length <= 64:
        return 64
    if length <= 160:
        return 160
    if length <= 320:
        return 320
    step = 512
    return ((length + step - 1) // step) * step


CPU_MEMORY_BYTES = 4 << 30  # the CPU backend reports no limit: stay modest


def device_memory_bytes(dev) -> int:
    """Bytes a batch may plan against on ``dev``: the allocator's
    ``bytes_limit`` where the device reports ``memory_stats`` (GPUs do),
    a modest fixed figure on the CPU backend, and an error elsewhere."""
    stats = dev.memory_stats() or {}
    if stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return CPU_MEMORY_BYTES
    raise RuntimeError(
        f"device {dev.device_kind!r} (platform {dev.platform}) reports no "
        "memory limit; set --batch-reads explicitly")


def auto_batch_reads(dev, index_rows: int, fused: bool) -> int:
    """Reads per batch from device memory — the device analogue of the
    reference's byte-budget planning (`QueryIndexer.cpp:24-28`,
    availableRam / (bytesPerKmer*kmerCnt + 200/read)).

    The per-read footprint covers the match tensors plus (for the fused
    taxonomer) the chain grids; half of what the index leaves free is
    planned for."""
    from .chunked import BYTES_PER_ENTRY

    limit = device_memory_bytes(dev)
    avail = max(limit - index_rows * BYTES_PER_ENTRY - (1 << 30), 1 << 28)
    # footprints at L=160: ~300 KB/read fused (chain grids dominate),
    # ~120 KB/read match-only
    per_read = 300_000 if fused else 120_000
    b = 512
    while b * 2 * per_read <= avail // 2 and b < 16384:
        b *= 2
    return b


@dataclass
class QueryMeta:
    name: str
    read_len: int  # usedLen(mate1) + usedLen(mate2)


class Classifier:
    def __init__(self, db_dir: str, params: ClassifyParams):
        self.par = params
        self.index = MetamerIndex.load(db_dir)
        dbp = self.index.params
        # db.parameters override user flags (`common.cpp:88-133`)
        params.syncmer = dbp.syncmer
        params.smer_len = dbp.smer_len
        params.kmer_format = dbp.kmer_format
        params.reduced_aa = dbp.reduced_aa
        params.skip_redundancy = dbp.skip_redundancy
        if dbp.accession_level == 0 and params.accession_level == 1:
            params.accession_level = 0

        self.taxonomy = self.index.taxonomy
        tp = TaxonomerParams(
            min_score=params.min_score,
            min_sp_score=params.min_sp_score,
            min_cons_cnt=params.min_cons_cnt,
            min_cons_cnt_euk=params.min_cons_cnt_euk,
            tie_ratio=params.tie_ratio,
            syncmer=bool(params.syncmer),
            smer_len=params.smer_len,
            seq_mode=params.seq_mode,
            accession_level=params.accession_level,
            em=bool(params.em),
            reduced_aa=bool(params.reduced_aa),
            kmer_format=params.kmer_format,
            print_log=bool(params.print_log),
        )
        self.taxonomer = Taxonomer(tp, self.taxonomy)
        # --print-log dumps per-species match paths during combination
        # (Taxonomer.cpp:346-353); only the annotated Python taxonomer
        # prints them, so force the host path through it (locally — the
        # caller's params object must not be mutated)
        skip_native = bool(params.print_log)
        use_device_tax = params.device_tax and not params.print_log
        self.device_taxonomer = None
        if use_device_tax and not params.reduced_aa:
            # the device chain kernels assume the 3-bit/24-bit codon layout
            from .device_taxonomer import DeviceTaxonomer

            self.device_taxonomer = DeviceTaxonomer(tp, self.taxonomy)
        self.native_taxonomer = None
        if not skip_native:
            try:
                from .native_taxonomer import NativeTaxonomer

                self.native_taxonomer = NativeTaxonomer(
                    tp, self.taxonomy, threads=params.threads
                )
            except (RuntimeError, OSError):
                pass
        if self.device_taxonomer is not None:
            # share the prepared taxonomy arrays with the fused host finish
            self.device_taxonomer._nt = self.native_taxonomer
            self.device_taxonomer._nt_tried = True
        self.reporter = Reporter(self.taxonomy, bool(params.print_lineage))

        # device arrays (32-bit split representation + prefix buckets);
        # DBs larger than the device budget stream through in AA-aligned
        # chunks (the --max-ram analogue, see classify/chunked.py)
        from .chunked import BYTES_PER_ENTRY, ChunkedIndex
        from .pipeline import build_dev_index

        # Reference quirk replicated for bit-identity: the merge-join loops
        # guard on `diffIdxPos != numOfDiffIdx` BEFORE consuming the decoded
        # k-mer (`KmerMatcher.cpp:363-406`, same in matchMetamers :979-:993),
        # so the LAST k-mer of the database can never become a candidate.
        # Verified against the compiled reference
        # (tests/test_reference_differential.py): a query hitting the final
        # DB entry matches here but not in the reference. Exclude that row
        # from the searchable table (it stays in the on-disk DB for
        # updateDB/validate purposes).
        search_values = self.index.values[:-1]
        search_taxids = self.index.taxids[:-1]

        hbm_budget = int(params.max_ram) << 30
        if len(self.index.values) * BYTES_PER_ENTRY > hbm_budget:
            self.chunked_index = ChunkedIndex(
                search_values, search_taxids.astype(np.int32),
                kmer_format=params.kmer_format, hbm_budget_bytes=hbm_budget,
                reduced=bool(params.reduced_aa),
            )
            self.dev_index = None
        else:
            self.chunked_index = None
            self.dev_index = build_dev_index(
                search_values, search_taxids.astype(np.int32),
                kmer_format=params.kmer_format,
                reduced=bool(params.reduced_aa),
            )
        self._species_np = self.index.species_table().astype(np.int32)
        self.d_species = jax.device_put(self._species_np)
        if params.batch_reads == 0:
            params.batch_reads = self._auto_batch_reads()
        # host-taxonomer path: skip the device-wide match sort (the native
        # taxonomer sorts per read, reads are independent) and use the
        # 4-word packed transfer (hamming re-derived from h16 on the host;
        # only exact for the standard-alphabet XOR hamming path)
        self._sort_device = not (
            self.native_taxonomer is not None
            and self.device_taxonomer is None
        )
        self._pack4 = (
            not params.reduced_aa and params.batch_reads <= 16384
            and self.device_taxonomer is None
        )
        # cap = the DB's true max AA-group size (no silent drop possible);
        # clamped by --max-cap for pathological low-complexity groups.
        # Two-tier: every query gathers a small tier-1 window (--small-cap);
        # queries in larger AA groups re-gather at the full cap, so skewed
        # real databases don't multiply every query's gather volume.
        self.cap = int(min(max(1, self.index.max_group), params.max_cap))
        self.cap1 = int(min(self.cap, max(1, params.small_cap)))
        self._ov_rows: int | None = None
        self._ov_budget_used = 0
        # deep-tier (aligned-group) routing list, active when the device
        # index aligned deep groups (DevIndex.deep_w)
        self._ovd_rows: int | None = None
        self._ovd_budget_used = 0
        # retries = device relaunches after a cap/budget/grid overflow;
        # fused_batches = batches run by the fused device taxonomer, of
        # which host_fallbacks were redone through the host taxonomer
        self.stats = {"matches": 0, "kmers": 0, "reads": 0, "device_s": 0.0,
                      "tax_s": 0.0, "retries": 0, "fused_batches": 0,
                      "host_fallbacks": 0}
        # sticky fused-taxonomer grid escalation (applies to later batches)
        self._fused_pmax = 16
        self._fused_scale = 1
        # sticky matches-per-kmer density for tight transfer budgets
        self._obs_ratio: float | None = None

    def _auto_batch_reads(self) -> int:
        return auto_batch_reads(
            jax.config.jax_default_device or jax.devices()[0],
            len(self.index.values), self.device_taxonomer is not None)

    # ---------------------------------------------------------------- batches
    def _iter_batches(self, q1: str, q2: str | None, skip: int = 0):
        """Yield (metas, rows) where rows = list of (seq, qid_local, pos_offset).
        ``skip`` drops the first N reads (restart-friendly resume, the
        analogue of the reference's processedReadCnt skip-ahead,
        `Classifier.cpp:76-79`)."""
        par = self.par
        batch_reads = par.batch_reads
        metas: list[QueryMeta] = []
        rows: list[tuple[bytes, int, int]] = []
        it1 = fasta.read_records(q1)
        it2 = fasta.read_records(q2) if q2 else None
        for _ in range(skip):
            next(it1, None)
            if it2 is not None:
                next(it2, None)
        while True:
            rec1 = next(it1, None)
            if rec1 is None:
                break
            qid = len(metas)
            if it2 is not None:
                rec2 = next(it2, None)
                if rec2 is None:
                    raise ValueError(
                        "paired-end files have different read counts"
                    )
                ul1, ul2 = _used_len(len(rec1.seq)), _used_len(len(rec2.seq))
                metas.append(QueryMeta(rec1.name, ul1 + ul2))
                rows.append((rec1.seq, qid, 0))
                rows.append((rec2.seq, qid, ul1 + 3))
            else:
                metas.append(QueryMeta(rec1.name, _used_len(len(rec1.seq))))
                rows.append((rec1.seq, qid, 0))
            if len(metas) >= batch_reads:
                yield metas, rows
                metas, rows = [], []
        if metas:
            yield metas, rows

    # ----------------------------------------------------------------- device
    def _dispatch_device(self, rows):
        """Launch the device program asynchronously; returns drain context."""
        par = self.par
        max_len = max((len(r[0]) for r in rows), default=0)
        L = _bucket_len(max_len)
        codes, lens = encode_seqs_padded([r[0] for r in rows], max_len=L)
        if par.mask_mode:
            from ..ops.mask import mask_codes

            for r_i, row in enumerate(rows):
                n = len(row[0])
                codes[r_i, :n] = mask_codes(codes[r_i, :n], par.mask_prob)
        pos_offsets = np.array([r[2] for r in rows], np.int32)
        qid_offsets = np.array([r[1] for r in rows], np.int32)

        # match budget: kmer capacity * matchPerKmer (QueryIndexer.h:72-74)
        # as the first-batch prior; after that a sticky pow2 budget sized to
        # the observed match density (the whole compaction buffer is what
        # leaves the device, so a tight budget is the transfer volume)
        n_windows = len(rows) * 6 * max(0, (L - 2) // 3 - 7)
        budget = max(1024, n_windows * par.match_per_kmer)
        if self._obs_ratio is not None:
            budget = min(
                budget, int(n_windows * self._obs_ratio * 1.3) + 4096
            )
        budget = _pow2_round(budget)
        args = (codes, lens, pos_offsets, qid_offsets)
        if self.chunked_index is not None:
            return ("chunked", args, None, budget)  # runs at drain time
        if self.device_taxonomer is not None and self.device_taxonomer.hints:
            # fused classify+taxonomer program: matches stay on the device.
            # (The FIRST batch runs through the plain path instead: its host
            # match dict seeds the fused grid sizes — see set_hints — so the
            # fused program compiles right-sized rather than worst-case.)
            n_reads = int(qid_offsets.max()) + 1 if len(rows) else 0
            read_lens = np.zeros(max(n_reads, 1), np.int32)
            for seq, qid, _ in rows:
                read_lens[qid] += _used_len(len(seq))
            # paired mates share a (read, frame) block; columns span both
            max_read_len = int(read_lens.max()) if n_reads else L
            handle = self._launch_fused(
                args, self.cap, budget, n_reads, max_read_len, read_lens,
                p_max=self._fused_pmax, scale=self._fused_scale,
            )
            return ("fused", args, handle, budget,
                    n_reads, max_read_len, read_lens)
        bm = self._launch(args, self.cap, budget)
        from .pipeline import prefetch_counts

        # only the counters prefetch at dispatch; the data buffer is sliced
        # to the real match count and fetched async by _start_fetch
        prefetch_counts(bm)
        return ("plain", args, bm, budget)

    def _launch(self, args, cap, budget):
        par = self.par
        cap2, ov_budget = 0, 0
        if cap > self.cap1:
            cap2 = cap
            cap = self.cap1
            n_windows = args[0].shape[0] * 6 * max(
                0, (args[0].shape[1] - 2) // 3 - 7
            )
            ov_budget = _pow2_round(
                self._ov_rows if self._ov_rows is not None
                else max(1024, n_windows // 32)
            )
        ovd_budget = 0
        if cap2 and getattr(self.dev_index, "deep_w", 0):
            ovd_budget = _pow2_round(
                self._ovd_rows if self._ovd_rows is not None
                else max(1024, n_windows // 32)
            )
        self._ov_budget_used = ov_budget
        self._ovd_budget_used = ovd_budget
        return classify_batch_indexed(
            self.dev_index, self.d_species, *args,
            cap=cap, max_matches=budget,
            reduced=bool(par.reduced_aa),
            syncmer=bool(par.syncmer),
            smer_len=par.smer_len,
            kmer_format=par.kmer_format,
            sort_device=self._sort_device,
            pack4=self._pack4,
            cap2=cap2, ov_budget=ov_budget, ovd_budget=ovd_budget,
        )

    def _launch_fused(self, args, cap, budget, n_reads, max_read_len,
                      read_lens, p_max=16, scale=1):
        par = self.par
        cap2, ov_budget = 0, 0
        if cap > self.cap1:
            cap2 = cap
            cap = self.cap1
            n_windows = args[0].shape[0] * 6 * max(
                0, (args[0].shape[1] - 2) // 3 - 7
            )
            ov_budget = _pow2_round(
                self._ov_rows if self._ov_rows is not None
                else max(1024, n_windows // 32)
            )
        ovd_budget = 0
        if cap2 and getattr(self.dev_index, "deep_w", 0):
            ovd_budget = _pow2_round(
                self._ovd_rows if self._ovd_rows is not None
                else max(1024, n_windows // 32)
            )
        self._ov_budget_used = ov_budget
        self._ovd_budget_used = ovd_budget
        return self.device_taxonomer.dispatch_fused(
            self.dev_index, self.d_species, *args,
            n_reads=n_reads, max_read_len=max_read_len,
            cap=cap, max_matches=budget,
            reduced=bool(par.reduced_aa), syncmer=bool(par.syncmer),
            smer_len=par.smer_len, kmer_format=par.kmer_format,
            read_lens_by_qid=read_lens, p_max=p_max, scale=scale,
            cap2=cap2, cap_ov_budget=ov_budget,
            cap_ovd_budget=ovd_budget,
        )

    def _drain_fused(self, ctx):
        """Drain the fused program; returns (results, info) with the same
        cap/budget retry semantics as the match path. results is None when
        the taxonomer grids overflowed after the retry ladder (host
        fallback)."""
        _, args, handle, budget, n_reads, max_read_len, read_lens = ctx
        t0 = time.time()
        results, info = self.device_taxonomer.drain_fused(
            handle, read_lens, n_reads
        )
        p_max, scale = self._fused_pmax, self._fused_scale
        hint_retries = 0
        while True:
            if info.get("n_ov_cap", 0) > self._ov_budget_used > 0:
                # tier-2 routing list overflowed: retry with a bigger one
                self._ov_rows = int(info["n_ov_cap"] * 1.3) + 1024
            elif info.get("n_ovd", 0) > self._ovd_budget_used > 0:
                self._ovd_rows = int(info["n_ovd"] * 1.3) + 1024
            elif info["n_over_cap"] > 0 and self.cap < self.index.max_group:
                self.cap = min(self.index.max_group, self.cap * 4)
            elif info["n_matches"] > budget:
                budget = int(info["n_matches"] * 1.2) + 1024
            elif results is None and (
                info["tax_overflow"] & 0b11010111  # blocks/paths/rows/ov
                # + direct-search lists (bit 6) + LCA tie list (bit 7)
            ) and hint_retries < 2:
                # drain_fused already folded the TRUE observed sizes into
                # the hints; a plain relaunch compiles big enough
                hint_retries += 1
            elif results is None and scale < 4:
                # chain-grid / group / taxcnt overflow: widen every grid
                # (path-heavy groups already re-combine on the host, so no
                # p_max escalation is needed)
                scale = 4
            else:
                break
            self.stats["retries"] += 1
            handle = self._launch_fused(
                args, self.cap, budget, n_reads, max_read_len, read_lens,
                p_max=p_max, scale=scale,
            )
            results, info = self.device_taxonomer.drain_fused(
                handle, read_lens, n_reads
            )
        if results is not None:
            self._fused_pmax, self._fused_scale = p_max, scale
        self.stats["device_s"] += time.time() - t0
        self.stats["kmers"] += info["total_kmers"]
        self.stats["matches"] += info["n_matches"]
        return results, (args, budget)

    def _start_fetch(self, ctx):
        """Resolve the plain path's overflow retries from the (prefetched)
        counters alone, then start the async sliced D2H transfer of the
        real match rows. Returns a ``MatchFetch`` handle for
        ``_finish_fetch``; the caller overlaps the transfer with the
        previous batch's host taxonomer."""
        from .pipeline import prefetch_counts, start_fetch

        _, args, bm, budget = ctx[:4]
        t0 = time.time()
        while True:
            counts = np.asarray(bm.counts)
            n_matches, n_over_cap = int(counts[0]), int(counts[1])
            n_ov = int(counts[3]) if counts.shape[0] > 3 else 0
            n_ovd = int(counts[7]) if counts.shape[0] > 7 else 0
            if n_ov > self._ov_budget_used > 0:
                # tier-2 routing list overflowed: retry with a bigger one
                self._ov_rows = int(n_ov * 1.3) + 1024
            elif n_ovd > self._ovd_budget_used > 0:
                self._ovd_rows = int(n_ovd * 1.3) + 1024
            elif n_over_cap > 0 and self.cap < self.index.max_group:
                self.cap = min(self.index.max_group, self.cap * 4)
            elif n_matches > budget:
                budget = int(n_matches * 1.2) + 1024
            else:
                break
            self.stats["retries"] += 1
            bm = self._launch(args, self.cap, budget)
            prefetch_counts(bm)
        fetch = start_fetch(bm)
        self.stats["device_s"] += time.time() - t0
        self.stats["kmers"] += int(counts[2])
        self.stats["matches"] += n_matches
        ratio = n_matches / max(int(counts[2]), 1)
        self._obs_ratio = max(self._obs_ratio or 0.0, ratio)
        if self._ov_budget_used:
            self._ov_rows = max(self._ov_rows or 0, n_ov)
        if self._ovd_budget_used:
            self._ovd_rows = max(self._ovd_rows or 0, n_ovd)
        return fetch

    def _finish_fetch(self, fetch):
        """Wait for a ``_start_fetch`` transfer and build the match dict."""
        from .pipeline import fetched_to_host

        t0 = time.time()
        m = fetched_to_host(fetch, self._species_np,
                            sorted_rows=self._sort_device)
        self.stats["device_s"] += time.time() - t0
        return m

    def _drain_device(self, ctx):
        """Fetch results; retry with larger cap/budget on overflow
        (`Classifier.cpp:127-131`)."""
        _, args, bm, budget = ctx[:4]
        t0 = time.time()
        if self.chunked_index is not None:
            from .chunked import classify_batch_chunked

            par = self.par
            m = classify_batch_chunked(
                self.chunked_index, self.d_species, self._species_np, *args,
                cap=self.cap, max_matches=budget,
                reduced=bool(par.reduced_aa), syncmer=bool(par.syncmer),
                smer_len=par.smer_len, kmer_format=par.kmer_format,
            )
        else:
            m = matches_to_host(bm, self._species_np,
                                sorted_rows=self._sort_device,
                                prefetched=True)
        while True:
            if m.get("n_ov", 0) > self._ov_budget_used > 0:
                # tier-2 routing list overflowed: retry with a bigger one
                self._ov_rows = int(m["n_ov"] * 1.3) + 1024
            elif m.get("n_ovd", 0) > self._ovd_budget_used > 0:
                self._ovd_rows = int(m["n_ovd"] * 1.3) + 1024
            elif m["n_over_cap"] > 0 and self.cap < self.index.max_group:
                self.cap = min(self.index.max_group, self.cap * 4)
            elif m["n_matches"] > budget:
                budget = int(m["n_matches"] * 1.2) + 1024
            else:
                break
            self.stats["retries"] += 1
            if self.chunked_index is not None:
                from .chunked import classify_batch_chunked

                par = self.par
                m = classify_batch_chunked(
                    self.chunked_index, self.d_species, self._species_np,
                    *args, cap=self.cap, max_matches=budget,
                    reduced=bool(par.reduced_aa), syncmer=bool(par.syncmer),
                    smer_len=par.smer_len, kmer_format=par.kmer_format,
                )
            else:
                bm = self._launch(args, self.cap, budget)
                m = matches_to_host(bm, self._species_np,
                                    sorted_rows=self._sort_device)
                # retry path: no prefetch needed (we block right here)
        self.stats["device_s"] += time.time() - t0
        self.stats["kmers"] += m["total_kmers"]
        self.stats["matches"] += m["n_matches"]
        ratio = m["n_matches"] / max(m["total_kmers"], 1)
        self._obs_ratio = max(self._obs_ratio or 0.0, ratio)
        if self._ov_budget_used:
            self._ov_rows = max(self._ov_rows or 0, int(m.get("n_ov", 0)))
        if self._ovd_budget_used:
            self._ovd_rows = max(self._ovd_rows or 0,
                                 int(m.get("n_ovd", 0)))
        return m

    # --------------------------------------------------------------- taxonomy
    def _assign_batch(self, metas, m, force_host=False) -> list[ReadClassification]:
        t0 = time.time()
        qid = m["qid"]
        if m.get("sorted", True):
            starts = np.searchsorted(qid, np.arange(len(metas)), side="left")
            ends = np.searchsorted(qid, np.arange(len(metas)), side="right")
        else:
            # unsorted rows may not even be read-major (two-tier cap appends
            # its re-gathered rows at the tail): bin sizes via bincount
            counts_r = np.bincount(
                qid, minlength=len(metas)
            ) if len(qid) else np.zeros(len(metas), np.int64)
            ends = np.cumsum(counts_r)
            starts = ends - counts_r
        read_lens = np.array([meta.read_len for meta in metas], np.int32)
        if self.device_taxonomer is not None and not force_host:
            # only reachable on the chunked-index path: the single-index
            # path runs the fused program instead
            try:
                out = self.device_taxonomer.assign_batch(
                    m, read_lens, len(metas)
                )
                self.stats["tax_s"] += time.time() - t0
                return out
            except NotImplementedError:
                pass  # grid overflow: fall through to the host taxonomer
        if self.native_taxonomer is not None:
            out, _ = self.native_taxonomer.assign_batch(m, starts, ends, read_lens)
            self.stats["tax_s"] += time.time() - t0
            return out
        from .pipeline import FIELDS

        if not m.get("sorted", True):
            # pure-Python fallback needs the reference match order
            order = np.lexsort((
                m["dna"].view(np.uint32), m["hamming"], m["pos"],
                m["frame"], m["species"], m["qid"],
            ))
            for k in FIELDS:
                m[k] = m[k][order]
            m["sorted"] = True
        out: list[ReadClassification] = []
        for i, meta in enumerate(metas):
            lo, hi = int(starts[i]), int(ends[i])
            if lo == hi:
                out.append(ReadClassification(score=0.0))
                continue
            sub = {k: m[k][lo:hi] for k in FIELDS}
            out.append(self.taxonomer.choose_best_taxon(sub, meta.read_len))
        self.stats["tax_s"] += time.time() - t0
        return out

    def _emit_batch(self, fh, metas, results, tax_counts, total_reads,
                    first, mappings, all_results):
        """Write one batch's classifications + accumulate clade counts/EM."""
        self.stats["reads"] += len(metas)
        rows_out = [
            (meta.name, rc, meta.read_len)
            for meta, rc in zip(metas, results)
        ]
        self.reporter.write_classifications(fh, rows_out, first=first)
        for rc in results:
            tax_counts[rc.taxid if rc.is_classified else 0] = (
                tax_counts.get(rc.taxid if rc.is_classified else 0, 0) + 1
            )
        if self.par.em:
            base = total_reads
            for i, rc in enumerate(results):
                for sp, sc in rc.species_scores:
                    mappings.append((base + i, sp, sc))
            all_results.extend(
                (meta.name, rc, meta.read_len)
                for meta, rc in zip(metas, results)
            )
        return total_reads + len(metas), False

    # ------------------------------------------------------------------- main
    def classify_file(
        self,
        q1: str,
        q2: str | None,
        out_dir: str,
        job_id: str,
        resume: bool = False,
    ) -> dict:
        os.makedirs(out_dir, exist_ok=True)
        cls_path = os.path.join(out_dir, f"{job_id}_classifications.tsv")
        report_path = os.path.join(out_dir, f"{job_id}_report.tsv")
        krona_path = os.path.join(out_dir, f"{job_id}_krona.html")

        tax_counts: dict[int, int] = {}
        total_reads = 0
        first = True
        skip = 0
        if resume and os.path.exists(cls_path):
            # rebuild clade counts from the existing rows, append the rest
            with open(cls_path) as fh:
                for line in fh:
                    if line.startswith("#"):
                        continue
                    cols = line.rstrip("\n").split("\t")
                    if len(cols) < 3:
                        continue
                    t = self.taxonomy.to_internal(int(cols[2])) if cols[0] == "1" else 0
                    tax_counts[max(t, 0)] = tax_counts.get(max(t, 0), 0) + 1
                    skip += 1
            total_reads = skip
            first = False
        mappings = [] if self.par.em else None
        all_results = [] if self.par.em else None
        with open(cls_path, "a" if skip else "w") as fh:
            # depth-2 software pipeline: while batch i's device program runs
            # and batch i-1's sliced match transfer flows D2H, batch i-2's
            # host taxonomer executes (results are written in order)
            pending = None  # (metas, dev_ctx): device program in flight
            infly = None    # (metas, drain ctx): D2H transfer in flight
            batch_iter = self._iter_batches(q1, q2, skip=skip)
            done = False
            while not done or pending is not None or infly is not None:
                nxt_ctx = None
                if not done:
                    nxt = next(batch_iter, None)
                    if nxt is None:
                        done = True
                    else:
                        nxt_ctx = (nxt[0], self._dispatch_device(nxt[1]))
                new_infly = None
                warmup = None
                if pending is not None:
                    p_metas, dev_ctx = pending
                    if dev_ctx[0] == "plain":
                        fetch = self._start_fetch(dev_ctx)
                        if (self.device_taxonomer is not None
                                and not self.device_taxonomer.hints):
                            # warmup batch: drain synchronously so its match
                            # dict seeds the fused grid sizes before the
                            # NEXT dispatch (infly is empty here — every
                            # batch goes synchronous until hints exist)
                            warmup = (p_metas, self._finish_fetch(fetch))
                        else:
                            # counts-driven retries + async sliced transfer
                            new_infly = (p_metas, ("plainfetch", fetch))
                    else:
                        # fused/chunked contexts drain when processed below
                        new_infly = (p_metas, dev_ctx)
                # process the transfer-in-flight batch (oldest first: infly
                # predates warmup, so emission order == batch order)
                if infly is not None:
                    metas, dev_ctx = infly
                    if dev_ctx[0] == "plainfetch":
                        m = self._finish_fetch(dev_ctx[1])
                        if self.device_taxonomer is not None:
                            # keep growing the fused grid-size hints
                            self.device_taxonomer.set_hints(
                                m, self.taxonomer.p.dna_shift
                            )
                        results = self._assign_batch(metas, m,
                                                     force_host=True)
                    elif dev_ctx[0] == "fused":
                        self.stats["fused_batches"] += 1
                        results, fallback = self._drain_fused(dev_ctx)
                        if results is None:
                            # taxonomer grid overflow: host fallback through
                            # the match path (rare; pathological density)
                            f_args, f_budget = fallback
                            self.stats["host_fallbacks"] += 1
                            t0 = time.time()
                            bm = self._launch(f_args, self.cap, f_budget)
                            m = matches_to_host(bm, self._species_np)
                            self.stats["device_s"] += time.time() - t0
                            results = self._assign_batch(
                                metas, m, force_host=True
                            )
                    else:
                        m = self._drain_device(dev_ctx)
                        if self.device_taxonomer is not None:
                            self.device_taxonomer.set_hints(
                                m, self.taxonomer.p.dna_shift
                            )
                        results = self._assign_batch(metas, m,
                                                     force_host=True)
                    total_reads, first = self._emit_batch(
                        fh, metas, results, tax_counts, total_reads, first,
                        mappings, all_results,
                    )
                if warmup is not None:
                    metas, m = warmup
                    self.device_taxonomer.set_hints(
                        m, self.taxonomer.p.dna_shift
                    )
                    results = self._assign_batch(metas, m, force_host=True)
                    total_reads, first = self._emit_batch(
                        fh, metas, results, tax_counts, total_reads, first,
                        mappings, all_results,
                    )
                infly = new_infly
                pending = nxt_ctx

        with open(report_path, "w") as fh:
            self.reporter.write_report(fh, tax_counts, total_reads)
        with open(krona_path, "w") as fh:
            prelude = None
            if getattr(self.par, "krona_prelude", ""):
                with open(self.par.krona_prelude) as pf:
                    prelude = pf.read()
            self.reporter.write_krona(fh, tax_counts, total_reads,
                                      prelude=prelude)

        summary = {
            "reads": total_reads - skip,
            "classified": total_reads - tax_counts.get(0, 0),
            **self.stats,
        }
        if self.par.em and total_reads:
            from .em import run_em_reassignment

            run_em_reassignment(
                self, mappings, all_results, out_dir, job_id, total_reads
            )
        return summary
