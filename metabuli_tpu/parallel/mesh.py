"""Multi-device scaling: index sharding over a device mesh.

Device-mesh replacement for the reference's single-node OpenMP parallelism
(`SURVEY.md` §2.8): a 2-D ``jax.sharding.Mesh`` with axes

  data -- read batches sharded across devices (data parallelism),
  db   -- the sorted metamer table range-partitioned by amino-acid prefix
          (the scaled-out generalization of the reference's 4096-entry
          ``split`` file, `/root/reference/src/commons/IndexCreator.cpp:844-858`).

Shard boundaries always fall on amino-acid group boundaries, so every query
metamer's equal-AA candidate range lives in exactly one shard and the
min-hamming cutoff (`KmerMatcher.cpp:1117-1146`) needs no cross-shard
reduction; a device's matches are complete for the AA ranges it owns.
Per-read results from different db shards are disjoint row sets merged by a
final per-read sort.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..classify.pipeline import (
    PREFIX_BITS,
    _classify_batch_impl,
    aa_permute,
    expand_db_dna48,
)


def make_mesh(devices=None, n_db: int | None = None) -> Mesh:
    """Factor devices into a (data, db) mesh; db axis defaults to 2 when
    there are >= 4 devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_db is None:
        n_db = 2 if n % 2 == 0 and n >= 4 else 1
    if n % n_db != 0:
        raise ValueError(f"{n} devices not divisible by db={n_db}")
    arr = np.array(devices).reshape(n // n_db, n_db)
    return Mesh(arr, ("data", "db"))


def shard_index_aa_aligned(
    values: np.ndarray, taxids: np.ndarray, n_shards: int, kmer_format: int = 2,
    reduced: bool = False,
):
    """Split the sorted table into AA-aligned, equal-padded shards in the
    packed device layout used by the pipeline (see pipeline.DevIndex).

    Returns (db, n_pad, search_iters) where ``db`` is the tuple of
    [S, ...]-shaped shard arrays. Group padding uses an impossible
    all-ones rest with zero-width row ranges; the prefix table only
    covers real groups, so searches never reach padding.
    """
    from ..classify.pipeline import aa_permute, pick_prefix_bits, rest_bits

    n = len(values)
    aa_shift = 32 if reduced else 24
    aa_bits = 32 if reduced else 40
    aa = values >> np.uint64(aa_shift)
    bounds = [0]
    for s in range(1, n_shards):
        target = s * n // n_shards
        while 0 < target < n and aa[target] == aa[target - 1]:
            target += 1
        bounds.append(min(target, n))
    bounds.append(n)
    chunks = [(values[a:b], taxids[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    pad = max(max((len(c[0]) for c in chunks), default=1), 1)

    shard_starts = []
    for v, _ in chunks:
        if len(v):
            saa = v >> np.uint64(aa_shift)
            ng = np.ones(len(v), bool)
            ng[1:] = saa[1:] != saa[:-1]
            shard_starts.append(np.nonzero(ng)[0])
        else:
            shard_starts.append(np.zeros(0, np.int64))
    g_pad = max(max((len(s) for s in shard_starts), default=1), 1)
    pb = pick_prefix_bits(g_pad)
    rb = rest_bits(reduced, pb)

    out_grest = np.full((n_shards, g_pad), -1, np.int32)
    out_gstart = np.zeros((n_shards, g_pad), np.int32)
    out_gend = np.zeros((n_shards, g_pad), np.int32)
    if reduced:
        out_lo = np.full((n_shards, pad), -1, np.int32)
        out_t = np.zeros((n_shards, pad), np.int32)
    else:
        out_taxdna = np.full(
            (n_shards, pad), np.uint64(0xFFFFFFFF) << np.uint64(32),
            np.uint64)
        out_d48 = np.zeros((n_shards, pad), np.uint64)
    prefix = np.zeros((n_shards, (1 << pb) + 1), np.int32)
    iters = 1
    for i, (v, t) in enumerate(chunks):
        starts = shard_starts[i]
        g = len(starts)
        if g:
            pi = aa_permute(v[starts] >> np.uint64(aa_shift), aa_bits)
            order = np.argsort(pi, kind="stable")
            pi_s = pi[order]
            out_grest[i, :g] = (pi_s & np.uint64((1 << rb) - 1)).astype(
                np.int32)
            out_gstart[i, :g] = starts[order].astype(np.int32)
            out_gend[i, :g] = np.append(starts[1:], len(v))[order].astype(
                np.int32)
            # prefix over REAL groups only: searches never reach padding
            counts = np.bincount(
                (pi_s >> np.uint64(rb)).astype(np.int64), minlength=1 << pb)
            np.cumsum(counts, out=prefix[i, 1:])
            iters = max(iters, int(np.ceil(np.log2(max(2, counts.max() + 1)))))
        if reduced:
            out_lo[i, : len(v)] = (
                v & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
            out_t[i, : len(t)] = t.astype(np.int32)
        else:
            tu = np.ascontiguousarray(t, np.int32).view(np.uint32)
            out_taxdna[i, : len(v)] = (
                (v & np.uint64(0xFFFFFFFF)) << np.uint64(32)) | tu
            out_d48[i, : len(v)] = expand_db_dna48(v, kmer_format)
    if reduced:
        db = (out_grest, out_gstart, out_gend, out_lo, out_t, prefix)
    else:
        db = (out_grest, out_gstart, out_gend, out_taxdna, out_d48, prefix)
    return db, pad, iters


def build_sharded_classify(
    mesh: Mesh,
    *,
    n_pad: int,
    search_iters: int,
    cap: int,
    max_matches: int,
    reduced: bool = False,
    syncmer: bool = False,
    smer_len: int = 5,
    kmer_format: int = 2,
):
    """shard_map'd classify step over (data, db)."""

    def local_step(db, t2s, codes, lens, pos_off, qid_off):
        # prefix width is encoded in the (static) table shape
        pb = (db[-1].shape[-1] - 1).bit_length() - 1
        bm = _classify_batch_impl(
            tuple(a[0] for a in db), t2s,
            codes, lens, pos_off, qid_off,
            n_db=n_pad, search_iters=search_iters, cap=cap,
            max_matches=max_matches, reduced=reduced, syncmer=syncmer,
            smer_len=smer_len, kmer_format=kmer_format,
            prefix_bits=pb,
        )
        # replicate matches across the db axis (all_gather): every
        # device in a data row then holds the row's COMPLETE matches, so
        # the host drain works for any process<->mesh topology (a data
        # row's db shards need not share a process) and no host-level
        # cross-shard routing is needed.
        data = jax.lax.all_gather(bm.data, "db")      # [n_db, 5|4, M]
        cnts = jax.lax.all_gather(bm.counts, "db")    # [n_db, 3]
        return data[None], cnts[None]

    # the first spec is a pytree prefix covering every leaf of the db tuple
    in_specs = (
        P("db", None), P(),
        P("data", None), P("data"), P("data"), P("data"),
    )
    out_specs = (P("data"), P("data"))
    fn = jax.shard_map(
        local_step, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def merge_shard_matches(stacked, n_reads: int, species_table=None):
    """Merge per-(data, db) match tensors into host match arrays.

    ``stacked`` = (data [n_data, n_db, 5, M], counts [n_data, n_db, 3]) in
    the transfer-packed layout (see pipeline.matches_to_host). Padding rows
    (qid == INT32_MAX) are dropped; rows re-sorted in the reference match
    order.
    """
    data, counts = (np.asarray(x) for x in stacked)
    flat = data.transpose(2, 0, 1, 3).reshape(5, -1)
    valid = flat[0] != np.int32(2147483647)
    flat = flat[:, valid]
    packed = flat[4]
    out = {
        "qid": flat[0],
        "pos": flat[1],
        "dna": flat[2],
        "taxid": flat[3],
        "frame": packed & 7,
        "hamming": (packed >> 3) & 0xFF,
        "h16": (packed >> 11) & 0xFFFF,
    }
    if species_table is not None:
        out["species"] = np.asarray(species_table, np.int32)[out["taxid"]]
    else:
        out["species"] = np.zeros(len(flat[0]), np.int32)
    order = np.lexsort(
        (out["dna"].view(np.uint32), out["hamming"], out["pos"], out["frame"],
         out["species"], out["qid"])
    )
    for k in ("qid", "species", "frame", "pos", "hamming", "dna", "taxid", "h16"):
        out[k] = out[k][order]
    out["n_matches"] = int(counts[:, :, 0].sum())
    out["n_over_cap"] = int(counts[:, :, 1].sum())
    return out


def build_sharded_fused(
    mesh: Mesh,
    *,
    n_pad: int,
    search_iters: int,
    cap: int,
    max_matches: int,
    sizes: dict,
    reduced: bool = False,
    syncmer: bool = False,
    smer_len: int = 5,
    kmer_format: int = 2,
    route: str = "alltoall",
    a2a_budget: int = 0,
):
    """shard_map'd FUSED classify+taxonomer over a (data, db) mesh.

    Each (data, db) device matches its read slice against its index shard
    (`pipeline._classify_core`); the db axis then merges matches and runs
    the device-taxonomer tail (`device_taxonomer.taxonomer_tail`) — as on
    a single chip, only the small packed group/taxcount tensors ever
    leave the devices. Two routing modes:

    route="alltoall" (default): READS are range-partitioned across the db
    axis for the tail. Each shard's matches are already qid-sorted, so
    the per-destination segments are contiguous — n_db static dynamic
    slices of ``a2a_budget`` rows each feed ONE all_to_all, each
    rank merge-sorts only its subset's n_db * a2a_budget rows and runs
    the tail on |reads|/n_db reads. vs all_gather this moves each match
    byte once instead of n_db times and cuts the merge sort + tail work
    per rank by ~n_db. Outputs vary along db (out spec ("data", "db"));
    a segment overflowing ``a2a_budget`` sets counts bit 8 of
    tax_overflow for the caller's retry ladder.

    route="gather": the db axis all_gathers the per-shard sorted columns,
    every rank merge-sorts the full n_db * max_matches rows and runs an
    identical (replicated) tail — outputs are db-invariant, shaped
    [n_data, ...].

    Call as fn(db, t2s, dt, min_depth, rl, codes, lens, pos_off, qid_off)
    with reads partitioned contiguously across the data axis (local qids
    per row).
    """
    import jax.numpy as jnp

    from ..classify.device_taxonomer import taxonomer_tail
    from ..classify.pipeline import _classify_core

    tail_kw = dict(
        path_budget=sizes["path_budget"], g_budget=sizes["g_budget"],
        max_rows=sizes["max_rows"], taxcnt_budget=sizes["taxcnt_budget"],
        dna_shift=sizes["dna_shift"], p_max=sizes["p_max"],
        n_blocks=sizes["n_blocks"], w=sizes["w"], k=sizes["k"],
        max_shift=sizes["max_shift"], ov_budget=sizes["ov_budget"],
        kmer_format=kmer_format, tie_budget=sizes.get("tie_budget", 0),
    )
    n_db = mesh.shape["db"]
    if route == "alltoall" and not a2a_budget:
        # default: even split + 2x skew headroom, 1024-row floor
        a2a_budget = max(1024, 2 * max_matches // max(n_db, 1))

    def merge_and_tail(g, tot_counts, dt_l, min_depth_l, rl, extra_ov):
        INT32_MAX = jnp.int32(2**31 - 1)
        is_pad = g[0] == INT32_MAX
        ham = (g[5] >> 3) & 0xFF
        frame = jnp.where(is_pad, INT32_MAX, g[5] & 7)
        if reduced:
            k_dna = jnp.where(is_pad, INT32_MAX, g[3] ^ jnp.int32(-(2**31)))
            keys = (g[0], g[1], frame, g[2],
                    jnp.where(is_pad, INT32_MAX, ham), k_dna)
        else:
            keys = (g[0], g[1], frame, g[2],
                    jnp.where(is_pad, INT32_MAX, (ham << 24) | g[3]))
        merged = jax.lax.sort(
            keys + (g[2], g[3], g[4], g[5]), num_keys=len(keys)
        )
        m_qid, m_species = merged[0], merged[1]
        off = len(keys)
        m_pos, m_dna, m_taxid, m_packed = merged[off:off + 4]
        packed, ov_packed, counts = taxonomer_tail(
            m_qid, m_species, m_pos, m_dna, m_taxid, m_packed, tot_counts,
            dt_l, min_depth_l, rl, **tail_kw,
        )
        counts = counts.at[2].set(counts[2] | (extra_ov << 8))
        return packed, ov_packed, counts

    def local_step(db, t2s, dt_l, min_depth_l, rl, codes, lens, pos_off,
                   qid_off):
        # non-packed index layout only: its prefix table has 2^pb + 1
        # entries (a packed_search index is a 5-tuple whose prefix array
        # has 2^pb and would mis-derive pb here)
        if len(db) != 6:
            raise ValueError(
                f"build_sharded_fused expects the 6-array non-packed index "
                f"layout, got a {len(db)}-tuple (packed_search indexes are "
                f"not supported on the sharded path)"
            )
        pb = (db[-1].shape[-1] - 1).bit_length() - 1
        s_cols = _classify_core(
            tuple(a[0] for a in db), t2s,
            codes, lens, pos_off, qid_off,
            n_db=n_pad, search_iters=search_iters, cap=cap,
            max_matches=max_matches, reduced=reduced, syncmer=syncmer,
            smer_len=smer_len, kmer_format=kmer_format, prefix_bits=pb,
        )
        s_qid, s_species, s_pos, s_dna, s_taxid, s_packed, cls_counts = s_cols
        INT32_MAX = jnp.int32(2**31 - 1)
        gc = jax.lax.all_gather(cls_counts, "db")  # [n_db, 7]
        # total_kmers is per data ROW (every db shard saw the same reads)
        tot_counts = jnp.stack([
            gc[:, 0].sum(), gc[:, 1].sum(), gc[0, 2], gc[:, 3].sum(),
            gc[:, 4].sum(), gc[:, 5].sum(), gc[:, 6].sum(),
        ]).astype(jnp.int32)
        cols = (s_qid, s_species, s_pos, s_dna, s_taxid, s_packed)
        if route == "gather":
            g = [jax.lax.all_gather(c, "db").reshape(-1) for c in cols]
            packed, ov_packed, counts = merge_and_tail(
                g, tot_counts, dt_l, min_depth_l, rl, jnp.int32(0))
            return packed[None], ov_packed[None], counts[None]

        # ---- all_to_all routing: reads are range-partitioned across the
        # db axis; each shard's qid-sorted match columns are cut at the
        # subset boundaries (contiguous segments -> n_db static dynamic
        # slices), one all_to_all delivers every shard's segment for THIS
        # rank's read subset.
        R = codes.shape[0]
        stride = -(-R // n_db)
        cut = jnp.searchsorted(
            s_qid, stride * jnp.arange(n_db + 1, dtype=jnp.int32),
            side="left").astype(jnp.int32)
        seg_len = cut[1:] - cut[:-1]
        b2_ov = jnp.any(seg_len > a2a_budget).astype(jnp.int32)
        stacked = jnp.stack(cols, axis=-1)                 # [M, 6]
        pad_row = jnp.full((a2a_budget, 6), INT32_MAX, jnp.int32)
        padded = jnp.concatenate(
            [stacked, jnp.full((a2a_budget, 6), INT32_MAX, jnp.int32)])
        del pad_row
        blocks = []
        idx = jnp.arange(a2a_budget, dtype=jnp.int32)
        for j in range(n_db):
            blk = jax.lax.dynamic_slice_in_dim(padded, cut[j], a2a_budget)
            blk = jnp.where((idx < seg_len[j])[:, None], blk, INT32_MAX)
            blocks.append(blk)
        outbound = jnp.stack(blocks)                       # [n_db, B2, 6]
        inbound = jax.lax.all_to_all(
            outbound, "db", split_axis=0, concat_axis=0, tiled=False)
        rows = inbound.reshape(n_db * a2a_budget, 6)
        g = [rows[:, i] for i in range(6)]
        # this rank's n_matches = its received subset rows (the summed
        # per-shard counter covers the whole data row)
        tot_counts = tot_counts.at[0].set(
            jnp.sum((g[0] != INT32_MAX).astype(jnp.int32)))
        packed, ov_packed, counts = merge_and_tail(
            g, tot_counts, dt_l, min_depth_l, rl, b2_ov)
        return packed[None, None], ov_packed[None, None], counts[None, None]

    out_spec = P("data") if route == "gather" else P("data", "db")
    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P("db", None),   # db tuple (pytree prefix)
            P(), P(), P(),   # t2s, dt (pytree prefix), min_depth
            P("data"),       # read lens (contiguous rows per data slice)
            P("data", None), P("data"), P("data"), P("data"),
        ),
        out_specs=(out_spec, out_spec, out_spec),
        check_vma=False,
    )
    return jax.jit(fn)
