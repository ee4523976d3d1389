"""Out-of-core classification: stream the database through the device in
AA-aligned chunks.

The reference bounds RAM by streaming the k-mer files through a fixed
buffer during the merge-join (`/root/reference/src/commons/KmerMatcher.cpp:212-265`)
and splitting queries to fit ``--max-ram``
(`QueryIndexer.cpp:30-147`). The device analogue:
when the decompressed table exceeds the device budget, it is split into
AA-aligned chunks; each read batch runs against every chunk and the per-
chunk match tensors are merged (each AA group lives in exactly one chunk, so
cutoffs need no cross-chunk reduction — same invariant as mesh sharding).
"""

from __future__ import annotations

import numpy as np

from .pipeline import build_dev_index, classify_batch_indexed, matches_to_host

BYTES_PER_ENTRY = 20  # rest + lo32 + d48lo + d48hi + taxid (+ prefix table)


def chunk_bounds(
    values: np.ndarray, n_chunks: int, reduced: bool = False
) -> list[tuple[int, int]]:
    n = len(values)
    aa = values >> np.uint64(32 if reduced else 24)
    bounds = [0]
    for s in range(1, n_chunks):
        target = s * n // n_chunks
        while 0 < target < n and aa[target] == aa[target - 1]:
            target += 1
        bounds.append(min(target, n))
    bounds.append(n)
    return list(zip(bounds[:-1], bounds[1:]))


class ChunkedIndex:
    """Sequence of DevIndex chunks built lazily (host memory holds the
    numpy table; chunks are device_put per pass)."""

    def __init__(
        self,
        values: np.ndarray,
        taxids: np.ndarray,
        kmer_format: int = 2,
        hbm_budget_bytes: int = 8 << 30,
        reduced: bool = False,
    ):
        need = len(values) * BYTES_PER_ENTRY
        self.n_chunks = max(1, -(-need // max(1, hbm_budget_bytes)))
        self.bounds = chunk_bounds(values, self.n_chunks, reduced)
        self.values = values
        self.taxids = taxids
        self.kmer_format = kmer_format
        self.reduced = reduced
        self._cache = {}

    def chunk(self, i: int):
        if i not in self._cache:
            a, b = self.bounds[i]
            self._cache[i] = build_dev_index(
                self.values[a:b], self.taxids[a:b], self.kmer_format,
                reduced=self.reduced,
            )
            if self.n_chunks > 1:
                # keep at most one chunk resident
                for k in list(self._cache):
                    if k != i:
                        del self._cache[k]
        return self._cache[i]


def classify_batch_chunked(
    chunked: ChunkedIndex,
    tax2species,
    species_np: np.ndarray,
    codes, lens, pos_offsets, qid_offsets,
    *,
    cap: int,
    max_matches: int,
    **kw,
) -> dict:
    """Run one read batch against every DB chunk; merge match dicts in the
    reference match order."""
    parts = []
    for i in range(chunked.n_chunks):
        bm = classify_batch_indexed(
            chunked.chunk(i), tax2species, codes, lens, pos_offsets,
            qid_offsets, cap=cap, max_matches=max_matches, **kw,
        )
        parts.append(matches_to_host(bm, species_np))
    if len(parts) == 1:
        return parts[0]
    fields = ("qid", "species", "frame", "pos", "hamming", "dna", "taxid", "h16")
    merged = {k: np.concatenate([p[k] for p in parts]) for k in fields}
    # dna compared unsigned (reduced mode uses the full 32 bits)
    order = np.lexsort((
        merged["dna"].view(np.uint32), merged["hamming"], merged["pos"],
        merged["frame"], merged["species"], merged["qid"],
    ))
    for k in fields:
        merged[k] = merged[k][order]
    merged["n_matches"] = sum(p["n_matches"] for p in parts)
    merged["n_over_cap"] = sum(p["n_over_cap"] for p in parts)
    merged["total_kmers"] = parts[0]["total_kmers"]
    return merged
