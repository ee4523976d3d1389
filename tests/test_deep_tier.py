"""Aligned deep-group tier == scattered two-tier gather, byte for byte.

Groups deeper than DEEP_T are padded/aligned at index build
(`DevIndex.deep_w`) so the deep tier fetches a query's whole candidate
window with ONE row fetch. Match output must be identical to the
scattered cap2 gather (`ovd_budget=0` disables the deep tier on the same
padded index), and padding must be invisible to the classic bucketed
flow too.
"""

import numpy as np
import pytest

from metabuli_tpu.classify.pipeline import (
    DEEP_T,
    build_dev_index,
    classify_batch_indexed,
    matches_to_host,
)
from metabuli_tpu.ops import encode
from metabuli_tpu.ops.genetic_code import encode_seqs_padded


@pytest.fixture(scope="module")
def deep_world():
    """30 wobble-diverged copies of one genome -> AA groups up to ~30 deep."""
    rng = np.random.default_rng(11)
    acgt = np.array(list(b"ACGT"), np.uint8)
    core = rng.choice(acgt, 3000)
    seqs = []
    for _ in range(30):
        c = core.copy()
        w = np.arange(2, 3000, 3)
        m = w[rng.random(len(w)) < 0.15]
        c[m] = acgt[(np.searchsorted(acgt, c[m])
                     + rng.integers(1, 4, len(m))) % 4]
        seqs.append(bytes(c))
    all_v, all_t = [], []
    for si, s in enumerate(seqs):
        codes_g, lens_g = encode_seqs_padded([s])
        mm = encode.extract_metamers(codes_g, lens_g)
        v = np.unique(np.asarray(mm.value)[np.asarray(mm.valid)])
        all_v.append(v)
        all_t.append(np.full(len(v), si + 2, np.int32))
    values = np.concatenate(all_v)
    taxids = np.concatenate(all_t)
    o = np.argsort(values, kind="stable")
    return seqs, values[o], taxids[o]


def _reads(seqs):
    reads = [seqs[i % 30][j * 200:j * 200 + 150]
             for i in range(16) for j in (1, 5)]
    codes, lens = encode_seqs_padded(reads, 152)
    n = len(reads)
    return (codes, lens, np.zeros(n, np.int32),
            np.arange(n, dtype=np.int32))


def test_index_aligns_deep_groups(deep_world):
    _, values, taxids = deep_world
    index = build_dev_index(values, taxids)
    assert index.deep_w > DEEP_T  # world has groups deeper than DEEP_T
    assert index.n % index.deep_w == 0
    # padded rows exist but every group's (start, cnt) excludes them
    assert index.n > len(values)


def test_deep_tier_matches_scattered(deep_world):
    seqs, values, taxids = deep_world
    index = build_dev_index(values, taxids)
    t2s = np.arange(64, dtype=np.int32)
    args = _reads(seqs)
    kw = dict(cap=1, cap2=64, max_matches=1 << 17, hit_budget=16384,
              sovf_budget=8192, resid_budget=4096, ov_budget=8192)
    a = matches_to_host(
        classify_batch_indexed(index, t2s, *args, ovd_budget=8192, **kw),
        t2s)
    b = matches_to_host(
        classify_batch_indexed(index, t2s, *args, ovd_budget=0, **kw),
        t2s)
    assert a["n_matches"] == b["n_matches"] > 0
    assert a["n_ovd"] > 0  # the deep tier actually ran
    assert b["n_ovd"] == 0
    # deep routing shrinks the medium list by exactly the deep rows
    assert a["n_ov"] + a["n_ovd"] == b["n_ov"]
    for k in ("qid", "pos", "dna", "taxid", "hamming", "h16", "frame"):
        assert np.array_equal(a[k], b[k]), k


def test_padded_index_transparent_to_unpadded(deep_world):
    """The SAME world classified through a padding-disabled index must
    produce identical matches (padding rows are structurally invisible)."""
    import os

    seqs, values, taxids = deep_world
    t2s = np.arange(64, dtype=np.int32)
    args = _reads(seqs)
    kw = dict(cap=1, cap2=64, max_matches=1 << 17, hit_budget=16384,
              sovf_budget=8192, resid_budget=4096, ov_budget=8192)
    index = build_dev_index(values, taxids)
    a = matches_to_host(
        classify_batch_indexed(index, t2s, *args, ovd_budget=8192, **kw),
        t2s)
    os.environ["METABULI_TPU_NO_DEEP_ALIGN"] = "1"
    try:
        plain = build_dev_index(values, taxids)
    finally:
        del os.environ["METABULI_TPU_NO_DEEP_ALIGN"]
    assert plain.deep_w == 0 and plain.n == len(values)
    c = matches_to_host(
        classify_batch_indexed(plain, t2s, *args, **kw), t2s)
    assert a["n_matches"] == c["n_matches"]
    for k in ("qid", "pos", "dna", "taxid", "hamming", "h16", "frame"):
        assert np.array_equal(a[k], c[k]), k


def test_cli_classifier_on_deep_world(tmp_path):
    """Full Classifier path (fused device taxonomer, ovd retry wiring) on
    a DB with deep groups: device-tax and host-tax outputs must match."""
    import os

    from metabuli_tpu.classify.classifier import Classifier
    from metabuli_tpu.db.build import build_database
    from metabuli_tpu.params import BuildParams, ClassifyParams

    rng = np.random.default_rng(5)
    acgt = np.array(list(b"ACGT"), np.uint8)
    core = rng.choice(acgt, 3000)
    n_sp = 24
    nodes = [(1, 1, "no rank"), (2, 1, "genus")]
    names = {1: "root", 2: "G"}
    taxdir = tmp_path / "taxonomy"
    taxdir.mkdir()
    fasta_dir = tmp_path / "fasta"
    fasta_dir.mkdir()
    paths, acc_rows = [], []
    for s in range(n_sp):
        t = 3 + s
        nodes.append((t, 2, "species")); names[t] = f"S{s}"
        c = core.copy()
        w = np.arange(2, 3000, 3)
        m = w[rng.random(len(w)) < 0.15]
        c[m] = acgt[(np.searchsorted(acgt, c[m])
                     + rng.integers(1, 4, len(m))) % 4]
        uniq = rng.choice(acgt, 2000)
        seq = np.concatenate([c, uniq])
        acc = f"DP_{s}.1"
        p = fasta_dir / f"{acc}.fna"
        p.write_text(f">{acc}\n{bytes(seq).decode()}\n")
        paths.append(str(p))
        acc_rows.append(f"{acc.split('.')[0]}\t{acc}\t{t}\t0\n")
    (taxdir / "nodes.dmp").write_text(
        "".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes))
    (taxdir / "names.dmp").write_text(
        "".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                for t, n in names.items()))
    (taxdir / "merged.dmp").write_text("")
    (tmp_path / "library.txt").write_text("\n".join(paths) + "\n")
    (tmp_path / "acc2taxid.map").write_text(
        "accession\taccession.version\ttaxid\tgi\n" + "".join(acc_rows))
    db = str(tmp_path / "db")
    build_database(db, str(tmp_path / "library.txt"),
                   str(tmp_path / "acc2taxid.map"), str(taxdir),
                   BuildParams(gene_prediction=0, batch_bases=200_000))

    # reads: half from cores (deep groups), half from unique tails
    reads = []
    for i in range(48):
        s = i % n_sp
        g = open(paths[s]).read().splitlines()[1].encode()
        st = int(rng.integers(0, 2800)) if i % 2 else int(
            rng.integers(3100, 4800))
        reads.append(g[st:st + 150])
    q = tmp_path / "reads.fna"
    q.write_text("".join(
        f">r{i}\n{r.decode()}\n" for i, r in enumerate(reads)))

    outs = {}
    for devtax in (1, 0):
        par = ClassifyParams(seq_mode=1, batch_reads=64, device_tax=devtax)
        clf = Classifier(db, par)
        assert clf.dev_index.deep_w > 0  # the deep tier is actually active
        out = str(tmp_path / f"out{devtax}")
        summary = clf.classify_file(str(q), None, out, "dp")
        assert summary["classified"] >= 0.9 * len(reads)
        outs[devtax] = open(
            os.path.join(out, "dp_classifications.tsv")).read()
    assert outs[0] == outs[1]
