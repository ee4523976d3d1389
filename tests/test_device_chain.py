"""Device chain DP vs the annotated Python getMatchPaths."""

import numpy as np
import pytest

from metabuli_tpu.classify.device_chain import chain_matches
from metabuli_tpu.classify.taxonomer import Taxonomer, TaxonomerParams
from metabuli_tpu.db.taxonomy import Taxonomy


def _taxonomy(tmp_path):
    nodes = [(1, 1, "no rank"), (2, 1, "genus")]
    names = {1: "root", 2: "G"}
    for sp in range(3, 9):
        nodes.append((sp, 2, "species")); names[sp] = f"S{sp}"
    (tmp_path / "nodes.dmp").write_text(
        "".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes))
    (tmp_path / "names.dmp").write_text(
        "".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n" for t, n in names.items()))
    (tmp_path / "merged.dmp").write_text("")
    return Taxonomy.from_dmp(str(tmp_path / "names.dmp"),
                             str(tmp_path / "nodes.dmp"),
                             str(tmp_path / "merged.dmp"))


def _synthetic_matches(rng, n_reads=24, max_shift=1):
    """Random sorted match arrays with realistic chain structure."""
    rows = []
    for qid in range(n_reads):
        for sp in sorted(rng.choice(range(3, 9), rng.integers(1, 3), replace=False)):
            for fr in sorted(rng.choice(range(6), rng.integers(1, 3), replace=False)):
                base = int(rng.integers(0, 3)) + (fr % 3)
                dna_chain = int(rng.integers(0, 1 << 24))
                pos = base
                n_groups = int(rng.integers(1, 10))
                for g in range(n_groups):
                    # occasionally skip ahead to break chains
                    gap = 3 * int(rng.integers(1, 4)) if rng.random() < 0.2 else 3
                    if g:
                        pos += gap
                    shift_codons = gap // 3
                    # chain-consistent dna: shift by 3 bits per codon step
                    dna_chain = ((dna_chain << (3 * shift_codons))
                                 | int(rng.integers(0, 1 << (3 * shift_codons)))) & 0xFFFFFF
                    n_ties = 1 if rng.random() < 0.8 else int(rng.integers(2, 4))
                    tie_dnas = {dna_chain}
                    for t in range(n_ties):
                        if t == 0 and rng.random() < 0.9:
                            d = dna_chain  # consistent chain member
                        else:
                            d = int(rng.integers(0, 1 << 24))  # breaker
                            while d in tie_dnas:
                                d = int(rng.integers(0, 1 << 24))
                        tie_dnas.add(d)
                        h16 = int(rng.integers(0, 1 << 16)) if rng.random() < 0.3 else 0
                        ham = bin(h16).count("1")  # arbitrary consistent-ish
                        rows.append((qid, sp, fr, pos, ham, d, 50 + sp, h16))
    rows.sort(key=lambda r: (r[0], r[1], r[2], r[3], r[4], r[5]))
    arr = np.array(rows, np.int32)
    return {
        "qid": arr[:, 0], "species": arr[:, 1], "frame": arr[:, 2],
        "pos": arr[:, 3], "hamming": arr[:, 4], "dna": arr[:, 5],
        "taxid": arr[:, 6], "h16": arr[:, 7],
    }


@pytest.mark.parametrize("seed,max_shift", [(0, 1), (1, 1), (2, 3), (3, 3)])
def test_device_chain_matches_python(tmp_path, seed, max_shift):
    tax = _taxonomy(tmp_path)
    rng = np.random.default_rng(seed)
    m = _synthetic_matches(rng, max_shift=max_shift)
    n = len(m["qid"])

    tp = TaxonomerParams(syncmer=max_shift > 1, smer_len=8 - max_shift)
    assert tp.max_codon_shift == max_shift
    py = Taxonomer(tp, tax)

    # python oracle: collect paths per (read, species, frame) run
    want = []
    i = 0
    while i < n:
        j = i
        while (j < n and m["qid"][j] == m["qid"][i]
               and m["species"][j] == m["species"][i]
               and m["frame"][j] == m["frame"][i]):
            j += 1
        if j - i > 1:
            paths = []
            py._get_match_paths(m, i, j, paths, int(m["species"][i]))
            for path in paths:
                want.append((int(m["qid"][i]), int(m["species"][i]),
                             path.start, path.end, round(float(path.score), 3),
                             path.hamming, path.depth))
        i = j

    min_depth = np.full(16, tp.min_cons_cnt, np.int32)
    res = chain_matches(
        m["qid"], m["species"], m["frame"], m["pos"], m["hamming"],
        m["dna"], m["h16"], np.ones(n, bool), min_depth,
        n_blocks=512, w=64, k=4, max_shift=max_shift,
    )
    assert not np.asarray(res.fallback).any()
    em = np.asarray(res.emit_mask)
    got = []
    starts = np.asarray(res.start); ends = np.asarray(res.end)
    scores = np.asarray(res.score); hams = np.asarray(res.hamming)
    depths = np.asarray(res.depth)
    b_read = np.asarray(res.block_read); b_sp = np.asarray(res.block_species)
    # emission grids are [W+1, K, NB] (block axis minor)
    for (w_i, s, b) in zip(*np.nonzero(em)):
        got.append((int(b_read[b]), int(b_sp[b]), int(starts[w_i, s, b]),
                    int(ends[w_i, s, b]), round(float(scores[w_i, s, b]), 3),
                    int(hams[w_i, s, b]), int(depths[w_i, s, b])))
    assert sorted(got) == sorted(want)
