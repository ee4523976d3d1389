"""Read grouping: overlap graph from shared metamers + label propagation.

Re-provides the capability of the reference's experimental read-group module
(`/root/reference/src/read-group/GroupGenerator.{h,cpp}`, `grouping`
workflow): reads sharing enough k-mers are joined in a union-find
(`GroupGenerator.h:73-109`); classification labels then propagate from
classified members to unclassified members of each group.

Shape: metamer extraction runs on device; the overlap join is a
sort of (kmer, read) pairs; union-find and label propagation are host-side
(numpy + path compression).
"""

from __future__ import annotations

import os

import numpy as np

from ..io import fasta
from ..ops import encode
from ..ops.genetic_code import encode_seqs_padded


class DisjointSet:
    """Union-find with path halving (`GroupGenerator.h:73-109`)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return int(x)

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)

    def labels(self) -> np.ndarray:
        return np.array([self.find(i) for i in range(len(self.parent))])


def suppress_common_kmers(
    kmers: np.ndarray,
    rids: np.ndarray,
    poss: np.ndarray,
    common_values: np.ndarray,
    neighbor_kmers: int,
) -> np.ndarray:
    """Keep-mask replicating ``GroupGenerator::filterCommonKmers2``
    (`/root/reference/src/read-group/GroupGenerator.cpp:349-534`,
    oracle-gated by tests/test_readgroup.py): query k-mers whose VALUE
    occurs in the common-k-mer DB become matches at their (read, pos),
    and every query k-mer of the same read within ``neighbor_kmers``
    bases of a match position is dropped (including the match itself).
    The reference's merge walk over (id, pos)-sorted streams is exactly
    an interval union, so the vectorized form checks each k-mer's nearest
    match position."""
    if len(common_values) == 0 or len(kmers) == 0:
        return np.ones(len(kmers), bool)
    cv = np.asarray(common_values, np.uint64)
    idx = np.searchsorted(cv, kmers)
    matched = (idx < len(cv)) & (cv[np.minimum(idx, len(cv) - 1)] == kmers)
    if not matched.any():
        return np.ones(len(kmers), bool)
    BIG = np.int64(1) << 32
    mkey = np.sort(rids[matched] * BIG + poss[matched])
    lo = rids * BIG + (poss - neighbor_kmers)
    hi = rids * BIG + (poss + neighbor_kmers)
    # any match key in [lo, hi] (same read by construction: the window is
    # far smaller than the read-id stride)
    has = np.searchsorted(mkey, hi, "right") > np.searchsorted(mkey, lo,
                                                               "left")
    return ~has


def build_read_groups(
    reads: list[bytes],
    min_shared_kmers: int = 2,
    max_kmer_degree: int = 64,
    batch: int = 2048,
    neighbor_kmers: int = 0,
    common_values: np.ndarray | None = None,
) -> np.ndarray:
    """Group labels per read: reads sharing >= min_shared_kmers metamers
    join one group (edge weights count distinct shared k-mer values per
    read PAIR, all pairs per k-mer, `GroupGenerator.cpp:585-594`).

    ``common_values``/``neighbor_kmers`` run the reference's common-k-mer
    suppression (`GroupGenerator.cpp:349-534`) before pair counting: query
    k-mers within the window of a common-DB match are dropped. K-mers
    hitting more than ``max_kmer_degree`` reads are treated as repeats and
    skipped — a repo extension guarding the pair blow-up when no common-DB
    prefilter is supplied (the reference bounds it only by its relation
    buffer flushes)."""
    pairs_k: list[np.ndarray] = []
    pairs_r: list[np.ndarray] = []
    pairs_p: list[np.ndarray] = []
    for i in range(0, len(reads), batch):
        chunk = reads[i : i + batch]
        max_len = max((len(r) for r in chunk), default=0)
        bucket = 64
        while bucket < max_len:
            bucket *= 2
        codes, lens = encode_seqs_padded(chunk, bucket)
        mm = encode.extract_metamers(codes, lens)
        v = np.asarray(mm.value)
        ok = np.asarray(mm.valid)
        pos = np.asarray(mm.pos)
        b, f, w = np.nonzero(ok)
        pairs_k.append(v[b, f, w])
        pairs_r.append((b + i).astype(np.int64))
        pairs_p.append(pos[b, f, w].astype(np.int64))
    if not pairs_k:
        return np.zeros(0, np.int64)
    kmers = np.concatenate(pairs_k)
    rids = np.concatenate(pairs_r)
    poss = np.concatenate(pairs_p)
    if common_values is not None:
        keep = suppress_common_kmers(kmers, rids, poss, common_values,
                                   neighbor_kmers)
        kmers, rids, poss = kmers[keep], rids[keep], poss[keep]
    # dedup (kmer, read) then sort by kmer — matches the reference's
    # per-value sort+unique of query ids (`GroupGenerator.cpp:585-587`)
    order = np.lexsort((rids, kmers))
    kmers, rids = kmers[order], rids[order]
    uniq = np.ones(len(kmers), bool)
    uniq[1:] = (kmers[1:] != kmers[:-1]) | (rids[1:] != rids[:-1])
    kmers, rids = kmers[uniq], rids[uniq]

    # edge weight per read pair = number of distinct shared k-mer values,
    # ALL pairs (i < j in read-id order) per k-mer group
    # (`GroupGenerator.cpp:588-594`)
    new_group = np.ones(len(kmers), bool)
    new_group[1:] = kmers[1:] != kmers[:-1]
    starts = np.nonzero(new_group)[0]
    ends = np.append(starts[1:], len(kmers))
    pair_counts: dict[tuple[int, int], int] = {}
    for a, b in zip(starts, ends):
        size = b - a
        if size < 2 or size > max_kmer_degree:
            continue
        members = rids[a:b]
        for i in range(size - 1):
            x = int(members[i])
            for j in range(i + 1, size):
                key = (x, int(members[j]))
                pair_counts[key] = pair_counts.get(key, 0) + 1

    ds = DisjointSet(len(reads))
    for (x, y), cnt in pair_counts.items():
        if cnt >= min_shared_kmers:
            ds.union(x, y)
    return ds.labels()


def weighted_majority_lca(
    votes: list[tuple[int, float]], taxonomy, majority_thr: float = 0.5
) -> int:
    """Weighted-majority LCA over (internal taxid, weight) votes: weights
    accumulate along each vote's ancestor chain; the deepest node whose
    accumulated weight reaches ``majority_thr`` of the total wins
    (NcbiTaxonomy::weightedMajorityLCA semantics, used by
    `GroupGenerator.cpp:1012`)."""
    if not votes:
        return 0
    acc: dict[int, float] = {}
    depth_of: dict[int, int] = {}
    total = 0.0
    for tax, w in votes:
        total += w
        node, d = int(tax), 0
        chain = []
        while node > 0:
            chain.append(node)
            parent = int(taxonomy.parent[node])
            if parent == node:
                break
            node = parent
        for i, n in enumerate(chain):
            acc[n] = acc.get(n, 0.0) + w
            depth_of.setdefault(n, len(chain) - i)
    # strictly greater: an even split falls through to the common ancestor
    need = majority_thr * total
    best, best_key = 0, (-1, -1.0)
    for n, w in acc.items():
        if w > need:
            key = (depth_of[n], w)
            if key > best_key:
                best_key, best = key, n
    return best


def propagate_labels(
    group_labels: np.ndarray,
    classifications: list[int],
    scores: list[float] | None = None,
    weight_mode: int = 0,
    min_vote_score: float = 0.0,
    taxonomy=None,
    majority_thr: float = 0.5,
) -> list[int]:
    """Assign each unclassified read its group's representative label.

    weight_mode (`GroupGenerator.cpp:995-1010`): 0 = uniform votes,
    1 = score-weighted, 2 = score²-weighted; modes 1/2 drop votes whose
    score is below ``min_vote_score``. With a taxonomy the representative
    is the weighted-majority LCA; without one, a plain weighted argmax."""
    votes: dict[int, list[tuple[int, float]]] = {}
    for rid, g in enumerate(group_labels):
        t = classifications[rid]
        if t <= 0:
            continue
        if weight_mode == 0:
            w = 1.0
        else:
            s = scores[rid] if scores else 0.0
            if s < min_vote_score:
                continue
            w = s if weight_mode == 1 else s * s
        votes.setdefault(int(g), []).append((t, w))
    rep: dict[int, int] = {}
    for g, vs in votes.items():
        if taxonomy is not None:
            rep[g] = weighted_majority_lca(vs, taxonomy, majority_thr)
        else:
            agg: dict[int, float] = {}
            for t, w in vs:
                agg[t] = agg.get(t, 0.0) + w
            rep[g] = max(agg.items(), key=lambda kv: kv[1])[0]
    out = list(classifications)
    for rid, g in enumerate(group_labels):
        if out[rid] == 0:
            out[rid] = rep.get(int(g), 0)
    return out


def group_reads_file(
    query_path: str,
    classifications_path: str,
    out_dir: str,
    min_shared_kmers: int = 2,
    weight_mode: int = 0,
    min_vote_score: float = 0.0,
    score_col: int = 5,
    taxonomy=None,
    majority_thr: float = 0.5,
    neighbor_kmers: int = 0,
    common_kmer_db: str = "",
) -> dict:
    """`grouping` workflow: read groups + propagated classifications.
    ``min_shared_kmers`` is the reference's --min-edge (edge weight =
    shared-k-mer count); ``score_col`` is 1-based like --score-col;
    ``common_kmer_db`` is the reference's common-k-mer DB positional
    (diffIdx/info dir) enabling the pre-grouping suppression filter."""
    os.makedirs(out_dir, exist_ok=True)
    reads = []
    names = []
    for rec in fasta.read_records(query_path):
        reads.append(rec.seq)
        names.append(rec.name)
    common_values = None
    if common_kmer_db:
        from ..db.formats import read_db_values

        common_values, _ = read_db_values(common_kmer_db)
    labels = build_read_groups(reads, min_shared_kmers,
                               neighbor_kmers=neighbor_kmers,
                               common_values=common_values)

    cls = [0] * len(reads)
    scores = [0.0] * len(reads)
    rows = []
    with open(classifications_path) as fh:
        idx = 0
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if idx < len(cls) and len(cols) >= 3:
                cls[idx] = int(cols[2]) if cols[0] == "1" else 0
                if len(cols) >= score_col:
                    try:
                        scores[idx] = float(cols[score_col - 1])
                    except ValueError:
                        pass
                rows.append(cols)
            idx += 1
    if taxonomy is not None:
        internal = [taxonomy.to_internal(t) if t > 0 else 0 for t in cls]
        prop_int = propagate_labels(
            labels, internal, scores, weight_mode, min_vote_score,
            taxonomy, majority_thr)
        propagated = [
            taxonomy.to_original(t) if t > 0 else 0 for t in prop_int
        ]
    else:
        propagated = propagate_labels(
            labels, cls, scores, weight_mode, min_vote_score)

    groups_path = os.path.join(out_dir, "read_groups.tsv")
    with open(groups_path, "w") as fh:
        fh.write("#read\tgroup\ttaxID\tpropagated_taxID\n")
        for i, name in enumerate(names):
            fh.write(f"{name}\t{int(labels[i])}\t{cls[i]}\t{propagated[i]}\n")
    rescued = sum(1 for a, b in zip(cls, propagated) if a == 0 and b != 0)
    return {
        "reads": len(reads),
        "groups": int(len(np.unique(labels))),
        "rescued": rescued,
        "out": groups_path,
    }
