"""Benchmark: classification throughput on one GPU.

Four configurations, each run in its own child process; the parent never
touches JAX, so exactly one process holds the card at a time. The primary
number is the "skew" world:

  skew (PRIMARY)  - 2 genera x 192 near-identical species: each species
      genome = a 6 kb clade "core" diverged mostly at third-codon
      ("wobble") positions + 94 kb unique sequence (38.4 Mbp total,
      gene-predicted build). Conserved cores make AA groups go up to 72
      deep (`KmerMatcher.cpp:362-406` walks such per-group candidate lists
      on real DBs), so every deep-group device mechanism (two-tier gather,
      pass-2 overflow, big match budgets) is exercised; reads hitting a
      core emit tens of hamming-0 matches each, like reads from conserved
      operons do.
  uniform         - 8 distinct 200 kb genomes, near-zero AA fan-out (cap 2).
  syncmer         - the skew world built and queried with closed
      syncmers (the reference's own headline: half DB, 2x speed,
      `README.md:35`).
  longread        - seq-mode 3: 3 kb reads at ~1% error vs the uniform
      world (`Taxonomer.cpp:44-48` long-read constants).

Every DB is padded with uniform-AA decoy rows to 60M rows (30M for the
halved syncmer DB); decoys never match, so search structures carry a
realistic load while matches stay exact.

Reads are classified through the fused device pipeline (search + Hamming
+ sort + device taxonomer in ONE XLA program) with the native host
drain. Inputs are nibble-packed and staged on the device before timing,
so this is the device layer's rate, not the CLI's (ROADMAP Speed 2). D2H
of the packed result tensors stays inside the timed loop. The timed loop
runs PASSES times and the best pass is reported (ROADMAP Speed 1 replaces
it with the median and spread).

Baseline: ``vs_baseline`` divides by the compiled reference classifier's
rate on the primary world and read set, measured with all cores of a
2-vCPU host (``all_cores_reads_per_s`` in ``BASELINE_MEASURED.json``,
written by tools_profiling/bench_cpu_baseline.py).

The bench fails unless JAX's default device is a GPU. Prints ONE JSON
line: {"metric", "value", "unit", "vs_baseline", "device", "gpu", ...}
with the secondary configurations' reads/s in a "secondary" object.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# built tables are cached here between bench runs (listed in .gitignore);
# bump BENCH_DB_VERSION when build_db / world generation / decoys / seeds
# change, so a stale table cannot skew numbers
BENCH_CACHE = os.path.join(ROOT, ".bench_cache")
BENCH_DB_VERSION = 3

TARGET_ROWS = int(os.environ.get("METABULI_BENCH_ROWS", 60_000_000))

WORLDS = {
    # independent random genomes, cap ~2
    "uniform": dict(clades=4, per_clade=2, core_len=0, unique_len=200_000,
                    divergence=0.0, wobble=0.0),
    # adversarial AA-group skew: 192 species per clade share a conserved
    # 6kb core whose divergence is dominated by third-codon-position
    # ("wobble") substitutions — mostly synonymous, like real conserved
    # genes — so AA groups go deep while DNA windows vary;
    # a light uniform substitution rate adds nonsynonymous realism
    "skew": dict(clades=2, per_clade=192, core_len=6_000, unique_len=94_000,
                 divergence=0.002, wobble=0.2),
}

CONFIGS = {
    "primary": dict(world="skew", syncmer=False, seq_mode=2,
                    n_reads=65_536, read_len=150, batch=8_192, passes=3,
                    warm_mpr=1024, rows=TARGET_ROWS),
    "uniform": dict(world="uniform", syncmer=False, seq_mode=2,
                    n_reads=32_768, read_len=150, batch=16_384, passes=3,
                    warm_mpr=230, rows=TARGET_ROWS),
    "syncmer": dict(world="skew", syncmer=True, seq_mode=2,
                    n_reads=32_768, read_len=150, batch=8_192, passes=2,
                    warm_mpr=512, rows=TARGET_ROWS // 2),
    "longread": dict(world="uniform", syncmer=False, seq_mode=3,
                     n_reads=8_192, read_len=3_000, batch=1_024, passes=2,
                     warm_mpr=2048, rows=TARGET_ROWS),
}


def gpu_name_power() -> str:
    """The card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()


def require_gpu() -> dict:
    """{platform, kind, count} of JAX's devices; raises unless JAX's
    default device is a GPU (no fallback to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"needs a GPU: JAX's default device is {devs[0].platform} "
            f"({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def measured_baseline():
    """(divisor, provenance dict) for vs_baseline: the reference binary's
    all-cores rate on the primary world and read set."""
    with open(os.path.join(ROOT, "BASELINE_MEASURED.json")) as fh:
        m = json.load(fh)
    return float(m["all_cores_reads_per_s"]), {
        "all_cores_reads_per_s": m["all_cores_reads_per_s"],
        "host_cores": m["host"]["cpus"],
        "host_model": m["host"]["model"],
        "world": m["config"],
    }


def adaptive_budget(n_matches: int) -> int:
    """Pow2 match budget from an observed count (+30% headroom).

    Every post-compaction tensor (taxdna gathers, chain-grid scatters, the
    final multi-key sort, quotient reduction) is sized by the match budget,
    so a conservative static budget multiplies their cost; the classifier
    CLI path sizes it from observed density the same way (classifier.py
    `_obs_ratio`), with the overflow counter driving a retry."""
    need = int(n_matches * 1.3) + 1024
    b = 4096
    while b * 2 < need:
        b *= 2
    for m in (4, 5, 6, 7, 8):
        if b * m // 4 >= need:
            return b * m // 4
    return b * 2


def quarter_pow2(need: int) -> int:
    """Smallest quarter-pow2 grid size >= need (matches fused_sizes)."""
    b = 1024
    while b * 2 < need:
        b *= 2
    for m in (4, 5, 6, 7, 8):
        if b * m // 4 >= need:
            return b * m // 4
    return b * 2


def log(msg):
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def _substitute(out: np.ndarray, pos: np.ndarray, rng) -> None:
    """In-place: substitute `pos` with a random DIFFERENT base."""
    if not len(pos):
        return
    # shift by 1-3 positions in ACGT order => always a different base
    base_idx = np.searchsorted(np.array(list(b"ACGT"), np.uint8), out[pos])
    out[pos] = np.array(list(b"ACGT"), np.uint8)[
        (base_idx + rng.integers(1, 4, size=len(pos))) % 4]


def _mutate(seq: np.ndarray, rate: float, wobble: float, rng) -> np.ndarray:
    """A diverged copy: `wobble` of third-codon positions substituted
    (mostly synonymous under the real genetic code, preserving the AA
    word) plus `rate` of all positions substituted uniformly."""
    n = len(seq)
    out = seq.copy()
    wpos = np.arange(2, n, 3)
    if wobble:
        _substitute(out, wpos[rng.random(len(wpos)) < wobble], rng)
    if rate:
        _substitute(out, rng.choice(n, size=int(n * rate), replace=False),
                    rng)
    return out


def build_world(tmp, world: str = "uniform"):
    """(taxonomy, [(genome_bytes, species_taxid)], rng) for a world."""
    import pathlib

    spec = WORLDS[world]
    rng = np.random.default_rng(0)
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom")]
    names = {1: "root", 2: "Bacteria"}
    tid = 3
    species = []
    for g in range(spec["clades"]):
        gid = tid
        nodes.append((tid, 2, "genus")); names[tid] = f"G{g}"; tid += 1
        for s in range(spec["per_clade"]):
            nodes.append((tid, gid, "species")); names[tid] = f"S{g}_{s}"
            species.append((tid, g)); tid += 1
    d = pathlib.Path(tmp)
    (d / "nodes.dmp").write_text(
        "".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes))
    (d / "names.dmp").write_text(
        "".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                for t, n in names.items()))
    (d / "merged.dmp").write_text("")

    from metabuli_tpu.db.taxonomy import Taxonomy

    tax = Taxonomy.from_dmp(
        str(d / "names.dmp"), str(d / "nodes.dmp"), str(d / "merged.dmp"))
    acgt = np.array(list(b"ACGT"), np.uint8)
    cores = [rng.choice(acgt, spec["core_len"]) for _ in
             range(spec["clades"])] if spec["core_len"] else None
    genomes = []
    for sp, clade in species:
        uniq = rng.choice(acgt, spec["unique_len"])
        if cores is not None:
            core = _mutate(cores[clade], spec["divergence"],
                           spec["wobble"], rng)
            genomes.append((bytes(np.concatenate([core, uniq])), sp))
        else:
            genomes.append((bytes(uniq), sp))
    return tax, genomes, rng


def build_db(tax, genomes, syncmer: bool = False):
    from metabuli_tpu.db.build import (IndexBuilder, SeqTask,
                                       predict_gene_blocks)
    from metabuli_tpu.params import BuildParams

    builder = IndexBuilder(
        BuildParams(batch_bases=4_000_000, syncmer=int(syncmer)), tax)
    tasks = [
        SeqTask(g, tax.to_internal(sp), int(tax.species_of[tax.to_internal(sp)]))
        for g, sp in genomes
    ]
    # reference DBs are always gene-predicted (IndexCreator.cpp:1128-1218
    # runs Prodigal unconditionally): one coding frame per block, not a
    # 6-frame superset — the bench DB mirrors that pipeline shape
    tasks = predict_gene_blocks(tasks, tax)
    builder.add_sequences(tasks)
    values = np.concatenate(builder._values)
    taxids = np.concatenate(builder._taxids)
    species = np.concatenate(builder._species)
    order = np.lexsort((taxids, species, values))
    values, taxids, species = values[order], taxids[order], species[order]
    ng = np.ones(len(values), bool)
    ng[1:] = (values[1:] != values[:-1]) | (species[1:] != species[:-1])
    gid = np.cumsum(ng) - 1
    lca = tax.lca_segments(taxids.astype(np.int64), gid)
    values = values[ng]
    taxids = lca.astype(np.int32)
    aa = values >> np.uint64(24)
    change = np.nonzero(aa[1:] != aa[:-1])[0]
    bounds = np.concatenate([[-1], change, [len(aa) - 1]])
    cap = int(np.diff(bounds).max()) if len(values) else 1
    return values, taxids, cap


def pad_with_decoys(values, taxids, species_internal, rng, n_decoys):
    """Pad the table with uniform-AA decoy rows that can never match.

    Colliding AA keys are dropped so every genome-derived group (and
    therefore every match, cutoff and classification) stays bit-identical;
    what changes is the scale of the search structures the device walks."""
    if n_decoys <= 0:
        return values, taxids
    aa = rng.integers(0, 1 << 40, size=n_decoys, dtype=np.uint64)
    keep = ~np.isin(aa, np.unique(values >> np.uint64(24)))
    aa = aa[keep]
    dna = rng.integers(0, 1 << 24, size=len(aa), dtype=np.uint64)
    dv = (aa << np.uint64(24)) | dna
    dtax = rng.choice(species_internal, size=len(dv)).astype(np.int32)
    v = np.concatenate([values, dv])
    t = np.concatenate([taxids, dtax])
    o = np.argsort(v, kind="stable")
    return v[o], t[o]


def get_db(world: str, syncmer: bool, target_rows: int, tax, genomes,
           cache_dir: str | None = None):
    """Build the decoy-padded table; with ``cache_dir``, load it from (or
    save it to) an npz there."""
    import hashlib

    spec_tag = hashlib.sha1(
        repr(sorted(WORLDS[world].items())).encode()).hexdigest()[:8]
    cache = cache_dir and os.path.join(
        cache_dir, f"db_v{BENCH_DB_VERSION}_{world}_{spec_tag}"
                   f"{'_sync' if syncmer else ''}_{target_rows}.npz")
    if cache and os.path.exists(cache):
        z = np.load(cache)
        return z["values"], z["taxids"], int(z["cap"]), int(z["n_real"])
    t0 = time.time()
    values, taxids, cap = build_db(tax, genomes, syncmer=syncmer)
    n_real = len(values)
    species_internal = np.unique(
        tax.species_of[np.asarray(taxids, np.int64)]).astype(np.int32)
    # decoys draw from their OWN seeded stream so the cached and
    # uncached paths leave the read-sampling rng identical
    values, taxids = pad_with_decoys(
        values, taxids, species_internal,
        np.random.default_rng(12345), max(0, target_rows - n_real))
    log(f"db[{world}{'/sync' if syncmer else ''}]: built in "
        f"{time.time()-t0:.1f}s")
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(cache, values=values, taxids=taxids, cap=cap,
                 n_real=n_real)
    return values, taxids, cap, n_real


def sample_reads(genomes, rng, n_reads: int, read_len: int, max_mut: int):
    acgt = np.array(list(b"ACGT"), np.uint8)
    reads = []
    for i in range(n_reads):
        if i % 10 == 9:
            reads.append(bytes(rng.choice(acgt, read_len)))
            continue
        g, _ = genomes[i % len(genomes)]
        st = int(rng.integers(0, len(g) - read_len))
        read = bytearray(g[st : st + read_len])
        for _ in range(int(rng.integers(0, max_mut + 1))):
            p = int(rng.integers(0, read_len))
            read[p] = b"ACGT"[int(rng.integers(0, 4))]
        if rng.integers(0, 2):
            read = bytearray(
                bytes(read).translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
            )
        reads.append(bytes(read))
    return reads


def prepare_world(config: str, cache_dir: str | None = None):
    """(tax, genomes, values, taxids, cap, n_real, reads) for a config.

    Shared with tools_profiling/bench_cpu_baseline.py and chip_smoke.py so
    every caller works on the exact same table and read set."""
    import tempfile

    c = CONFIGS[config]
    with tempfile.TemporaryDirectory() as tmp:
        tax, genomes, rng = build_world(tmp, c["world"])
    values, taxids, cap, n_real = get_db(
        c["world"], c["syncmer"], c["rows"], tax, genomes, cache_dir)
    max_mut = 2 if c["read_len"] <= 300 else c["read_len"] // 100
    reads = sample_reads(genomes, rng, c["n_reads"], c["read_len"], max_mut)
    return tax, genomes, values, taxids, cap, n_real, reads


def seed_search_hints(dtx, index, values, n_queries):
    """Host-exact upper bounds for the direct-search grid budgets.

    Sized so the fused program compiles right-sized the FIRST time and no
    second variant compiles inside the timed window (ROADMAP Design 2
    decides whether this still pays): the pass-2 overflow list is bounded
    from the direct-map load histogram (uniform queries land in a
    multi-group slot with probability n_multi / slots; genome-derived hits
    with the measured real-group multi-slot share)."""
    from metabuli_tpu.classify.pipeline import AA_PERM_MULT, AA_PERM_MULT2

    if not index.direct_bits:
        return
    mask40 = np.uint64((1 << 40) - 1)
    aa = np.unique(values >> np.uint64(24))
    pi = (aa * np.uint64(AA_PERM_MULT)) & mask40
    slots = (pi >> np.uint64(40 - index.direct_bits)).astype(np.int64)
    load = np.bincount(slots, minlength=1 << index.direct_bits)
    multi = load >= 2
    frac_uniform = multi.sum() / len(load)
    rg_multi = float(multi[slots].mean())
    hits = dtx.hints.get("hits", n_queries // 4)
    bound = int(1.5 * (n_queries * frac_uniform + hits * rg_multi)) + 8192
    # already margined 1.5x above: sized via the absolute-bound hint so
    # fused_sizes does not margin it again (a doubled margin put ~450 of
    # 956 ms/batch into the pass-2 machinery on the 60M-row world)
    dtx.hints["sovf_bound"] = max(dtx.hints.get("sovf_bound", 0), bound)
    log(f"sovf seed: {bound} (multi-slot frac {frac_uniform:.4f}, "
        f"real-group share {rg_multi:.4f})")
    if index.direct2_bits:
        # dmap2 residual bound, mirroring build_dev_index's construction:
        # pass-2 queries needing the binary search are those whose dmap2
        # slot holds >= 2 overflow groups (uniform misses) or whose own
        # group is not its dmap2 slot's first entry (real hits)
        order = np.argsort(pi, kind="stable")
        first = np.ones(len(aa), bool)
        first[1:] = slots[order][1:] != slots[order][:-1]
        ovf_aa = aa[order][~first]
        pi2 = (ovf_aa * np.uint64(AA_PERM_MULT2)) & mask40
        slots2 = np.sort(
            (pi2 >> np.uint64(40 - index.direct2_bits)).astype(np.int64))
        dup2 = slots2[1:] == slots2[:-1]
        multi2_slots = len(np.unique(slots2[1:][dup2]))
        frac2_uniform = frac_uniform * multi2_slots / (
            1 << index.direct2_bits)
        nonfirst2_share = float(dup2.sum()) / max(len(aa), 1)
        bound2 = int(
            2.0 * (n_queries * frac2_uniform + hits * nonfirst2_share)
        ) + 4096
        dtx.hints["sovf2_bound"] = max(dtx.hints.get("sovf2_bound", 0),
                                       bound2)
        log(f"sovf2 seed: {bound2} (multi2 slots {multi2_slots}, "
            f"non-first2 share {nonfirst2_share:.5f})")


def run_config(config: str) -> dict:
    import jax

    from metabuli_tpu.classify.device_taxonomer import DeviceTaxonomer
    from metabuli_tpu.classify.pipeline import (
        build_dev_index,
        classify_batch_indexed,
        matches_to_host,
        pack_codes,
    )
    from metabuli_tpu.classify.taxonomer import TaxonomerParams
    from metabuli_tpu.ops import encode
    from metabuli_tpu.ops.genetic_code import encode_seqs_padded

    device = require_gpu()
    c = CONFIGS[config]
    n_reads, batch, passes = c["n_reads"], c["batch"], c["passes"]
    t0 = time.time()
    tax, genomes, values, taxids, cap, n_real, reads = prepare_world(
        config, BENCH_CACHE)
    log(f"[{config}] db: {len(values)} rows ({n_real} genome-derived, "
        f"{len(values) - n_real} decoys), cap {cap}, "
        f"ready in {time.time()-t0:.1f}s")
    t2s = tax.species_of.astype(np.int32)
    t0 = time.time()
    index = build_dev_index(values, taxids)
    d_t2s = jax.device_put(t2s)
    log(f"[{config}] device index: {index.n} rows, direct_bits "
        f"{index.direct_bits}, staged in {time.time()-t0:.1f}s")

    # pad to the tightest even codon bucket: every padded window costs
    # probe/sort time
    pad_len = c["read_len"] + (2 - c["read_len"] % 2) % 2 + 2
    read_len = 3 * ((c["read_len"] - 2) // 3)
    tp = TaxonomerParams(seq_mode=c["seq_mode"], syncmer=c["syncmer"],
                         smer_len=5)
    dtx = DeviceTaxonomer(tp, tax)

    batches = []
    for i in range(0, n_reads, batch):
        chunk = reads[i : i + batch]
        codes, lens = encode_seqs_padded(chunk, pad_len)
        batches.append((
            jax.device_put(pack_codes(codes)),
            jax.device_put(lens),
            jax.device_put(np.zeros(len(chunk), np.int32)),
            jax.device_put(np.arange(len(chunk), dtype=np.int32)),
            len(chunk),
        ))
    jax.block_until_ready([b[0] for b in batches])
    n_win = encode.max_codons(pad_len) - 7
    n_queries = batch * 6 * n_win

    # two-tier candidate cap: depth-1 groups (decoys + unique regions)
    # gather a single candidate; deep conserved-core groups re-gather at
    # the full cap through the compacted overflow list
    cap1 = 1 if cap > 1 else max(1, cap)
    cap2 = max(1, cap) if cap > 1 else 0
    max_matches = batch * c["warm_mpr"]
    # host-estimated warmup overflow budget (fraction of query k-mers in
    # depth>1 groups, with margin; the skew world's conserved cores are
    # ~6% of genome bases); the fused program re-sizes from the exact
    # observed counter afterwards
    ovb_warm = quarter_pow2(int(n_queries * 0.15) + 32768) if cap2 else 0

    rl = np.full(batch, read_len, np.int32)

    # warmup: one plain batch seeds the fused grid-size hints
    t0 = time.time()
    bm = classify_batch_indexed(
        index, d_t2s, *batches[0][:4],
        cap=cap1, cap2=cap2, ov_budget=ovb_warm, ovd_budget=ovb_warm,
        max_matches=max_matches, codes_packed=True,
        syncmer=c["syncmer"],
    )
    m = matches_to_host(bm, t2s)
    dtx.set_hints(m, tp.dna_shift)
    seed_search_hints(dtx, index, values, n_queries)
    max_matches = adaptive_budget(m["n_matches"])
    ovb = quarter_pow2(int(m["n_ov"] * 1.3) + 8192) if cap2 else 0
    ovdb = (quarter_pow2(int(m["n_ovd"] * 1.3) + 4096)
            if cap2 and index.deep_w else 0)
    log(f"[{config}] warmup: n_matches {m['n_matches']}, n_ov {m['n_ov']},"
        f" n_ovd {m['n_ovd']}, budgets: matches {max_matches}, ov {ovb},"
        f" ovd {ovdb} (deep_w {index.deep_w})")

    def dispatch(b):
        codes, lens, offs, qids, n_chunk = b
        h = dtx.dispatch_fused(
            index, d_t2s, codes, lens, offs, qids,
            n_reads=n_chunk, max_read_len=read_len,
            cap=cap1, max_matches=max_matches,
            reduced=False, syncmer=c["syncmer"], smer_len=5, kmer_format=2,
            read_lens_by_qid=rl[:n_chunk],
            cap2=cap2, cap_ov_budget=ovb, cap_ovd_budget=ovdb,
            codes_packed=True,
        )
        return h, b

    def drain(h, b):
        nonlocal max_matches, ovb, ovdb
        n_chunk = b[4]
        results, info = dtx.drain_fused(h, rl[:n_chunk], n_chunk)
        # relaunch on grid overflow (hints already folded in the
        # observed sizes) or match-budget overflow (budget regrows
        # from the true count)
        while results is None or info["n_matches"] > max_matches or (
                ovb and info["n_ov_cap"] > ovb) or (
                ovdb and info["n_ovd"] > ovdb):
            log(f"overflow retry: {info}")
            if info["n_matches"] > max_matches:
                max_matches = adaptive_budget(info["n_matches"])
            if ovb and info["n_ov_cap"] > ovb:
                ovb = quarter_pow2(int(info["n_ov_cap"] * 1.3) + 8192)
            if ovdb and info["n_ovd"] > ovdb:
                ovdb = quarter_pow2(int(info["n_ovd"] * 1.3) + 4096)
            h, _ = dispatch(b)
            results, info = dtx.drain_fused(h, rl[:n_chunk], n_chunk)
        assert info["n_over_cap"] == 0, "cap retry needed"
        return sum(r.is_classified for r in results)

    drain(*dispatch(batches[0]))
    # the fused drain may fold larger observed counters into the hints;
    # dispatch once more so a resized program compiles HERE, not inside
    # pass 0 (longread's first pass once paid a 400 s mid-loop compile)
    drain(*dispatch(batches[0]))
    log(f"[{config}] warmup (compile): {time.time()-t0:.1f}s")

    best = None
    classified = 0
    for p in range(passes):
        t0 = time.time()
        classified = 0
        pending = dispatch(batches[0])
        for b in batches[1:]:
            nxt = dispatch(b)
            classified += drain(*pending)
            pending = nxt
        classified += drain(*pending)
        dt = time.time() - t0
        log(f"[{config}] pass {p}: {n_reads} reads in {dt:.2f}s "
            f"({n_reads/dt:.0f} reads/s)")
        best = dt if best is None else min(best, dt)
    value = n_reads / best
    log(f"[{config}] best pass: {n_reads} reads in {best:.2f}s; classified "
        f"{classified} ({100*classified/n_reads:.1f}%)")
    return {
        "config": config,
        "reads_per_s": round(value, 1),
        "n_reads": n_reads,
        "classified": classified,
        "db_rows": int(len(values)),
        "cap": cap,
        "device": device,
    }


def main():
    sub = os.environ.get("METABULI_BENCH_CONFIG")
    if sub:
        print(json.dumps(run_config(sub)))
        return

    names = os.environ.get(
        "METABULI_BENCH_CONFIGS", "primary,uniform,syncmer,longread"
    ).split(",")
    results = {}
    for name in names:
        env = dict(os.environ, METABULI_BENCH_CONFIG=name)
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            env=env, capture_output=True, text=True, timeout=3600)
        sys.stderr.write(res.stderr)
        if res.returncode != 0:
            log(f"[{name}] FAILED rc={res.returncode}")
            if name == "primary":
                raise SystemExit(f"primary bench config failed:\n"
                                 f"{res.stderr[-2000:]}")
            continue
        results[name] = json.loads(res.stdout.strip().splitlines()[-1])
        log(f"[{name}] done in {time.time()-t0:.0f}s: "
            f"{results[name]['reads_per_s']} reads/s")

    divisor, prov = measured_baseline()
    value = results["primary"]["reads_per_s"]
    out = {
        "metric": "classification_throughput",
        "value": value,
        "unit": "reads/s",
        "vs_baseline": round(value / divisor, 3),
        "baseline": prov,
        "device": results["primary"]["device"],
        "gpu": gpu_name_power(),
        "secondary": {
            f"{n}_reads_per_s": r["reads_per_s"]
            for n, r in results.items() if n != "primary"
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
