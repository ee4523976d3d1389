"""NCBI-style taxonomy with dense internal IDs and O(1) vectorized LCA.

Re-provides the capabilities of the reference's ``TaxonomyWrapper`` /
MMseqs2 ``NcbiTaxonomy`` (`/root/reference/src/commons/TaxonomyWrapper.{h,cpp}`):

  * parse taxonkit-compatible ``names.dmp`` / ``nodes.dmp`` / ``merged.dmp``;
  * remap original taxids to a dense internal space 1..N
    (`TaxonomyWrapper.h:70-145`) — dense IDs let device code index
    taxid-keyed tables directly;
  * LCA / IsAncestor / rank queries / lineage strings;
  * Kraken2-style clade counting for reports;
  * binary round-trip (npz) and ``*.dmp`` re-export (the ``taxdump``
    command, `/root/reference/src/util/taxdump.cpp`).

Design notes: LCA uses an Euler tour + sparse-table RMQ, built
once in numpy, so batched LCA over match arrays is fully vectorized; the
per-node species/genus ancestors are precomputed top-down so classification
never walks the tree at query time.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

# MMseqs2 NcbiRanks ordering used by rank-walking queries
# (`TaxonomyWrapper.cpp:479-498`); unknown ranks (incl. "no rank") get -1.
NCBI_RANKS = [
    "forma", "varietas", "subspecies", "species", "species subgroup",
    "species group", "subgenus", "genus", "subtribe", "tribe", "subfamily",
    "family", "superfamily", "parvorder", "infraorder", "suborder", "order",
    "superorder", "infraclass", "subclass", "class", "superclass",
    "subphylum", "phylum", "superphylum", "subkingdom", "kingdom",
    "superkingdom",
]
_RANK_INDEX = {r: i for i, r in enumerate(NCBI_RANKS)}
_RANK_INDEX["domain"] = _RANK_INDEX["superkingdom"]  # GTDB taxonomies

# Short-rank prefixes for lineage strings (`TaxonomyWrapper.h:9-26`).
SHORT_RANKS = {
    "subspecies": "ss", "species": "s", "subgenus": "sg", "genus": "g",
    "subfamily": "sf", "family": "f", "suborder": "so", "order": "o",
    "subclass": "sc", "class": "c", "subphylum": "sp", "phylum": "p",
    "subkingdom": "sk", "kingdom": "k", "superkingdom": "d", "domain": "d",
    "realm": "r",
}


def rank_index(rank: str) -> int:
    return _RANK_INDEX.get(rank, -1)


@dataclass
class Taxonomy:
    """Dense-ID taxonomy. Node 0 is a sentinel ("unclassified")."""

    parent: np.ndarray          # [N+1] int32 internal parent id (root -> itself)
    rank_id: np.ndarray         # [N+1] int32 index into ranks list
    name_id: np.ndarray         # [N+1] int32 index into names list
    ranks: list[str]            # rank strings
    names: list[str]            # name strings
    internal2org: np.ndarray    # [N+1] int64 original taxid per internal id
    use_internal: bool = True

    # Derived (built in __post_init__)
    org2internal: dict = field(default_factory=dict, repr=False)
    depth: np.ndarray = None
    tin: np.ndarray = None
    tout: np.ndarray = None
    euler_first: np.ndarray = None
    euler_node: np.ndarray = None
    sparse: np.ndarray = None
    species_of: np.ndarray = None
    genus_of: np.ndarray = None
    eukaryota_id: int = 0

    def __post_init__(self):
        self._build_structures()

    # ------------------------------------------------------------------ build
    @classmethod
    def from_dmp(
        cls,
        names_file: str,
        nodes_file: str,
        merged_file: str | None = None,
        use_internal: bool = True,
    ) -> "Taxonomy":
        """Parse nodes/names/merged dmp files (taxonkit-compatible).

        Internal IDs are assigned exactly like the reference's
        `TaxonomyWrapper::loadNodes` (`TaxonomyWrapper.cpp:148-195`): walking
        nodes.dmp line by line, the line's taxid gets the next unused
        internal ID if unseen, THEN its parent taxid gets the next one if
        unseen. (Row-order-only assignment diverges whenever a parent is
        referenced before its own definition line, which would change every
        internal taxid stored in the DB from that point on.)
        """
        org_ids: list[int] = []
        org_parent: list[int] = []
        org_rank: list[str] = []
        with open(nodes_file) as fh:
            for line in fh:
                parts = [p.strip() for p in line.rstrip("\n").split("|")]
                cols = [p for p in (x.strip("\t") for x in parts)]
                if len(cols) < 3:
                    continue
                org_ids.append(int(cols[0]))
                org_parent.append(int(cols[1]))
                org_rank.append(cols[2])

        org2int: dict[int, int] = {}
        next_id = 0
        for taxid, p_org in zip(org_ids, org_parent):
            if taxid not in org2int:
                next_id += 1
                org2int[taxid] = next_id
            if p_org not in org2int:
                next_id += 1
                org2int[p_org] = next_id
        n = next_id

        # merged.dmp: old -> new taxid aliases
        merged = {}
        if merged_file and os.path.exists(merged_file):
            with open(merged_file) as fh:
                for line in fh:
                    cols = [p.strip() for p in line.replace("|", "\t").split("\t") if p.strip()]
                    if len(cols) >= 2:
                        merged[int(cols[0])] = int(cols[1])

        # scientific names
        name_of: dict[int, str] = {}
        with open(names_file) as fh:
            for line in fh:
                parts = [p.strip() for p in line.rstrip("\n").split("|")]
                if len(parts) >= 4 and parts[3] == "scientific name":
                    name_of[int(parts[0])] = parts[1]
                elif len(parts) >= 2 and int(parts[0]) not in name_of:
                    name_of.setdefault(int(parts[0]), parts[1])

        ranks: list[str] = []
        rank_idx_of: dict[str, int] = {}
        names: list[str] = []
        name_idx_of: dict[str, int] = {}

        def intern(s: str, pool: list, idx: dict) -> int:
            if s not in idx:
                idx[s] = len(pool)
                pool.append(s)
            return idx[s]

        parent = np.arange(n + 1, dtype=np.int32)  # defaults: self-parent
        rank_id = np.zeros(n + 1, np.int32)
        name_id = np.zeros(n + 1, np.int32)
        internal2org = np.zeros(n + 1, np.int64)
        intern("", ranks, rank_idx_of)
        intern("unclassified", names, name_idx_of)
        for org, iid in org2int.items():
            internal2org[iid] = org
            name_id[iid] = intern(name_of.get(org, str(org)), names, name_idx_of)
        for i in range(len(org_ids)):
            iid = org2int[org_ids[i]]
            p_org = org_parent[i]
            # every parent taxid got an internal id in the first pass, so
            # no merged-alias resolution happens here (nor in the
            # reference: TaxonomyWrapper::loadNodes never consults
            # merged.dmp for parents)
            assert p_org in org2int
            parent[iid] = org2int[p_org]
            rank_id[iid] = intern(org_rank[i], ranks, rank_idx_of)

        tax = cls(
            parent=parent,
            rank_id=rank_id,
            name_id=name_id,
            ranks=ranks,
            names=names,
            internal2org=internal2org,
            use_internal=use_internal,
        )
        for old, new in merged.items():
            if new in org2int:
                tax.org2internal.setdefault(old, org2int[new])
        return tax

    def _build_structures(self):
        n = len(self.parent) - 1
        self.org2internal = {int(o): i for i, o in enumerate(self.internal2org) if i > 0}
        parent = self.parent
        depth = np.zeros(n + 1, np.int32)
        # iterative DFS from roots using children adjacency
        kids_start, kids = self._children_adjacency()
        roots = np.nonzero(parent[1:] == np.arange(1, n + 1, dtype=np.int32))[0] + 1
        tin = np.zeros(n + 1, np.int64)
        tout = np.zeros(n + 1, np.int64)
        euler_node = np.zeros(2 * n + 1, np.int32)
        euler_first = np.zeros(n + 1, np.int64)
        timer = 0
        epos = 0
        visited = np.zeros(n + 1, bool)
        for root in roots:
            if visited[root]:
                continue
            # explicit stack DFS emitting Euler tour
            stack = [(int(root), 0)]
            depth[root] = 0
            while stack:
                node, ci = stack[-1]
                if ci == 0:
                    visited[node] = True
                    tin[node] = timer
                    timer += 1
                    euler_first[node] = epos
                    euler_node[epos] = node
                    epos += 1
                s, e = kids_start[node], kids_start[node + 1]
                if ci < e - s:
                    child = int(kids[s + ci])
                    stack[-1] = (node, ci + 1)
                    if child != node and not visited[child]:
                        depth[child] = depth[node] + 1
                        stack.append((child, 0))
                else:
                    tout[node] = timer
                    timer += 1
                    stack.pop()
                    if stack:
                        pnode = stack[-1][0]
                        euler_node[epos] = pnode
                        epos += 1
        self.depth = depth
        self.tin = tin
        self.tout = tout
        euler_node = euler_node[:epos]
        self.euler_node = euler_node
        self.euler_first = euler_first
        # sparse table over euler depths for RMQ -> O(1) LCA
        m = len(euler_node)
        levels = max(1, int(np.floor(np.log2(max(1, m)))) + 1)
        sparse = np.zeros((levels, m), np.int64)
        sparse[0] = np.arange(m)
        d = depth[euler_node].astype(np.int64)
        for k in range(1, levels):
            span = 1 << k
            prev = sparse[k - 1]
            half = 1 << (k - 1)
            a = prev[: m - span + 1]
            b = prev[half : m - span + 1 + half]
            take_b = d[b] < d[a]
            sparse[k, : m - span + 1] = np.where(take_b, b, a)
        self.sparse = sparse
        self._euler_depth = d
        # species / genus ancestors, precomputed by rank-walk semantics
        self.species_of = self._at_rank_all("species")
        self.genus_of = self._at_rank_all("genus")
        euk = np.nonzero(np.array([self.names[i] for i in self.name_id]) == "Eukaryota")[0]
        self.eukaryota_id = int(euk[0]) if len(euk) else 0

    def _children_adjacency(self):
        n = len(self.parent) - 1
        parent = self.parent
        node_ids = np.arange(1, n + 1, dtype=np.int32)
        non_root = parent[1:] != node_ids
        childs = node_ids[non_root]
        pars = parent[1:][non_root].astype(np.int64)
        order = np.argsort(pars, kind="stable")
        kids = childs[order]
        counts = np.bincount(pars, minlength=n + 1)
        kids_start = np.zeros(n + 2, np.int64)
        kids_start[1:] = np.cumsum(counts)
        return kids_start, kids

    def _at_rank_all(self, rank: str) -> np.ndarray:
        """Vector of getTaxIdAtRank(i, rank) for every node, computed top-down
        following `TaxonomyWrapper.cpp:479-498`: walk up while the current
        node's rank index is < target; cap ~30 steps -> self."""
        target = rank_index(rank)
        n = len(self.parent) - 1
        rank_ord = np.array([rank_index(r) for r in self.ranks], np.int32)
        node_rank = rank_ord[self.rank_id]
        out = np.zeros(n + 1, np.int32)
        # `fallback` marks nodes whose whole ancestor chain has rank < target;
        # the reference's 30-step cap then returns the queried taxid itself
        # (`TaxonomyWrapper.cpp:484-496`), which top-down means: out = self.
        fallback = np.zeros(n + 1, bool)
        order = np.argsort(self.tin[1:], kind="stable") + 1  # parents first
        for i in order:
            p = self.parent[i]
            if node_rank[i] >= target:
                out[i] = i
            elif p != i and not fallback[p]:
                out[i] = out[p]
            else:
                out[i] = i
                fallback[i] = True
        return out

    # ------------------------------------------------------------------ query
    def n_nodes(self) -> int:
        return len(self.parent) - 1

    def lca_pairwise(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Vectorized LCA of two internal-id arrays (0 propagates)."""
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        fa = self.euler_first[a]
        fb = self.euler_first[b]
        lo = np.minimum(fa, fb)
        hi = np.maximum(fa, fb)
        length = hi - lo + 1
        k = (np.floor(np.log2(length))).astype(np.int64)
        left = self.sparse[k, lo]
        right = self.sparse[k, hi - (1 << k) + 1]
        d = self._euler_depth
        pick_right = d[right] < d[left]
        idx = np.where(pick_right, right, left)
        res = self.euler_node[idx]
        res = np.where((a == 0) | (b == 0), np.maximum(a, b), res)
        return res.astype(np.int32)

    def lca(self, ids) -> int:
        ids = [int(i) for i in ids if int(i) != 0]
        if not ids:
            return 0
        acc = np.array([ids[0]], np.int64)
        for i in ids[1:]:
            acc = self.lca_pairwise(acc, np.array([i], np.int64))
        return int(acc[0])

    def lca_segments(self, ids: np.ndarray, seg: np.ndarray) -> np.ndarray:
        """LCA reduced over segments: returns per-segment LCA.

        ``seg`` must be sorted, non-negative segment labels; result array has
        size seg.max()+1 (0 where segment empty).
        """
        if len(ids) == 0:
            return np.zeros(0, np.int32)
        acc = ids.astype(np.int64).copy()
        cur_seg = seg.astype(np.int64).copy()
        # iterative pairwise folding within equal-seg runs: O(log run) rounds
        while True:
            same_next = np.zeros(len(acc), bool)
            same_next[:-1] = cur_seg[:-1] == cur_seg[1:]
            if not same_next.any():
                break
            start = np.ones(len(acc), bool)
            start[1:] = cur_seg[1:] != cur_seg[:-1]
            run_start = np.maximum.accumulate(
                np.where(start, np.arange(len(acc)), -1)
            )
            pos = np.arange(len(acc)) - run_start
            left_idx = np.nonzero((pos % 2 == 0) & same_next)[0]
            acc[left_idx] = self.lca_pairwise(acc[left_idx], acc[left_idx + 1])
            keep = np.ones(len(acc), bool)
            keep[left_idx + 1] = False
            acc = acc[keep]
            cur_seg = cur_seg[keep]
        out = np.zeros(int(seg.max()) + 1 if len(seg) else 0, np.int32)
        out[cur_seg] = acc
        return out

    def is_ancestor(self, anc: int, child: int) -> bool:
        if anc == 0 or child == 0:
            return False
        return bool(
            (self.tin[anc] <= self.tin[child]) & (self.tout[child] <= self.tout[anc])
        )

    def at_rank(self, taxid: int, rank: str) -> int:
        if rank == "species":
            return int(self.species_of[taxid])
        if rank == "genus":
            return int(self.genus_of[taxid])
        return int(self._at_rank_all(rank)[taxid])

    def rank_of(self, taxid: int) -> str:
        return self.ranks[self.rank_id[taxid]]

    def name_of(self, taxid: int) -> str:
        return self.names[self.name_id[taxid]]

    def to_original(self, internal: int) -> int:
        if not self.use_internal:
            return int(internal)
        return int(self.internal2org[internal]) if internal > 0 else 0

    def to_internal(self, original: int) -> int:
        if not self.use_internal:
            return int(original)
        return self.org2internal.get(int(original), -1)

    def lineage(self, taxid: int) -> str:
        """Semicolon lineage with short-rank prefixes (taxLineage2,
        `TaxonomyWrapper.cpp:431-458`)."""
        chain = []
        node = int(taxid)
        while node > 0:
            chain.append(node)
            p = int(self.parent[node])
            if p == node:
                break
            node = p
        parts = []
        for nd in reversed(chain):
            rank = self.rank_of(nd)
            short = SHORT_RANKS.get(rank, "")
            if not short:
                continue
            parts.append(f"{short}_{self.name_of(nd)}")
        return ";".join(parts)

    # ------------------------------------------------------------- reporting
    def clade_counts(self, tax_counts: dict[int, int]) -> dict[int, dict]:
        """Kraken2-style clade aggregation (NcbiTaxonomy::getCladeCounts)."""
        out: dict[int, dict] = {}
        for taxid, cnt in tax_counts.items():
            if taxid <= 0:
                continue
            node = int(taxid)
            entry = out.setdefault(node, {"taxCount": 0, "cladeCount": 0, "children": []})
            entry["taxCount"] += cnt
            entry["cladeCount"] += cnt
            child = node
            p = int(self.parent[node])
            while p != child:
                pe = out.setdefault(p, {"taxCount": 0, "cladeCount": 0, "children": []})
                if child not in pe["children"]:
                    pe["children"].append(child)
                pe["cladeCount"] += cnt
                child = p
                p = int(self.parent[p])
        return out

    # ---------------------------------------------------------------- persist
    def save(self, path: str):
        np.savez_compressed(
            path,
            parent=self.parent,
            rank_id=self.rank_id,
            name_id=self.name_id,
            ranks=np.array(self.ranks, dtype=object),
            names=np.array(self.names, dtype=object),
            internal2org=self.internal2org,
            use_internal=np.array([self.use_internal]),
        )

    @classmethod
    def load(cls, path: str) -> "Taxonomy":
        if not path.endswith(".npz"):
            path = path + ".npz"
        z = np.load(path, allow_pickle=True)
        return cls(
            parent=z["parent"],
            rank_id=z["rank_id"],
            name_id=z["name_id"],
            ranks=list(z["ranks"]),
            names=list(z["names"]),
            internal2org=z["internal2org"],
            use_internal=bool(z["use_internal"][0]),
        )

    # -------------------------------------------------------------- dmp dump
    def write_dmp(self, out_dir: str):
        """Re-export names/nodes/merged dmp files (taxdump command parity,
        `/root/reference/src/util/taxdump.cpp`)."""
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "nodes.dmp"), "w") as fh:
            for i in range(1, self.n_nodes() + 1):
                fh.write(
                    f"{self.to_original(i)}\t|\t{self.to_original(int(self.parent[i]))}"
                    f"\t|\t{self.rank_of(i)}\t|\n"
                )
        with open(os.path.join(out_dir, "names.dmp"), "w") as fh:
            for i in range(1, self.n_nodes() + 1):
                fh.write(
                    f"{self.to_original(i)}\t|\t{self.name_of(i)}\t|\t\t|\tscientific name\t|\n"
                )
        with open(os.path.join(out_dir, "merged.dmp"), "w") as fh:
            for old, new in sorted(self.org2internal.items()):
                if self.internal2org[new] != old:
                    fh.write(f"{old}\t|\t{self.to_original(new)}\t|\n")
