"""Seeded self-checks shared by the test suite and ``chip_smoke.py``.

* ``golden_world`` / ``golden_outputs``: the golden regression world
  (three 6 kb genomes, a subspecies, canned clean/mutated/reverse/N reads)
  and the files the golden suite locks under ``tests/golden``;
* ``jit_eager_mismatches``: compiled vs op-by-op metamer extraction at the
  shapes where an XLA miscompile of the extraction once appeared;
* ``skill_world``: the two-genome world of the CLI verify recipe, built
  through the CLI.

Every world is generated from fixed seeds; nothing is read from outside
the package.
"""

from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np

ACGT = np.array(list(b"ACGT"), np.uint8)


def _write_taxonomy(taxdir: pathlib.Path, nodes, names) -> None:
    taxdir.mkdir(parents=True, exist_ok=True)
    (taxdir / "nodes.dmp").write_text(
        "".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes))
    (taxdir / "names.dmp").write_text(
        "".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                for t, n in names.items()))
    (taxdir / "merged.dmp").write_text("")


def golden_world(root) -> tuple[str, str]:
    """Write the golden world under ``root``; returns (root, reads path).

    ``root`` gets ``taxonomy/``, ``fasta/``, ``library.txt`` and
    ``acc2taxid.map`` (build inputs) and ``reads.fna`` (27 queries)."""
    root = pathlib.Path(root)
    rng = np.random.default_rng(20260817)
    genomes = {
        "GLD_A.1": (bytes(rng.choice(ACGT, 6000)), 4),
        "GLD_B.1": (bytes(rng.choice(ACGT, 6000)), 5),
        "GLD_C.1": (bytes(rng.choice(ACGT, 6000)), 8),
    }
    nodes = [
        (1, 1, "no rank"), (2, 1, "superkingdom"), (3, 2, "genus"),
        (4, 3, "species"), (5, 3, "species"), (6, 4, "subspecies"),
        (7, 2, "genus"), (8, 7, "species"),
    ]
    names = {1: "root", 2: "Bacteria", 3: "GenusA", 4: "SpA1", 5: "SpA2",
             6: "SpA1sub", 7: "GenusB", 8: "SpB1"}
    _write_taxonomy(root / "taxonomy", nodes, names)
    fdir = root / "fasta"
    fdir.mkdir()
    paths = []
    for acc, (seq, _) in genomes.items():
        p = fdir / f"{acc}.fna"
        p.write_text(f">{acc}\n{seq.decode()}\n")
        paths.append(str(p))
    (root / "library.txt").write_text("\n".join(paths) + "\n")
    (root / "acc2taxid.map").write_text(
        "accession\taccession.version\ttaxid\tgi\n"
        + "".join(f"{a.split('.')[0]}\t{a}\t{t}\t0\n"
                  for a, (_, t) in genomes.items())
    )
    # canned reads: clean, mutated, reverse-complemented, noisy, N-containing
    reads = []
    for gi, (acc, (g, _)) in enumerate(genomes.items()):
        for i in range(6):
            start = 137 * (i + 1) + 311 * gi
            read = bytearray(g[start : start + 150])
            if i % 3 == 1:
                read[40] = ord("A") if read[40] != ord("A") else ord("C")
                read[90] = ord("G") if read[90] != ord("G") else ord("T")
            if i % 2 == 1:
                read = bytearray(
                    bytes(read).translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
                )
            if i == 5:
                read[70:75] = b"NNNNN"
            reads.append(bytes(read))
    noise = np.random.default_rng(7).choice(ACGT, (3, 150))
    reads += [bytes(r) for r in noise]
    q = root / "reads.fna"
    q.write_text("".join(f">g{i}\n{r.decode()}\n" for i, r in enumerate(reads)))
    return str(root), str(q)


def golden_outputs(root, syncmer: int) -> dict[str, str]:
    """Build and classify the golden world under ``root`` on JAX's default
    device; returns {fixture file name: produced text} for the files in
    ``tests/golden``."""
    from .classify.classifier import Classifier
    from .db.build import build_database
    from .params import BuildParams, ClassifyParams

    root, q = golden_world(root)
    db = os.path.join(root, f"db_s{syncmer}")
    stats = build_database(
        db, os.path.join(root, "library.txt"),
        os.path.join(root, "acc2taxid.map"),
        os.path.join(root, "taxonomy"),
        BuildParams(gene_prediction=0, syncmer=syncmer, mask_mode=1),
    )
    tag = f"s{syncmer}"
    # diffIdx/info content locked via digest (binary fixtures stay small)
    digest = hashlib.sha256()
    for fname in ("diffIdx", "info", "taxID_list"):
        with open(os.path.join(db, fname), "rb") as fh:
            digest.update(fh.read())
    out = os.path.join(root, f"out_{tag}")
    clf = Classifier(db, ClassifyParams(seq_mode=1, batch_reads=8))
    clf.classify_file(q, None, out, "gold")
    produced = {
        f"build_stats_{tag}.txt":
            f"total={stats['total_kmers']} unique={stats['unique_kmers']}\n",
        f"db_digest_{tag}.txt": digest.hexdigest() + "\n",
    }
    for kind in ("classifications", "report"):
        with open(os.path.join(out, f"gold_{kind}.tsv")) as fh:
            produced[f"{kind}_{tag}.tsv"] = fh.read()
    return produced


def random_dna(rng: np.random.Generator, length: int,
               n_prob: float = 0.02) -> bytes:
    """Uniform ACGT with N at rate ``n_prob`` (same draws as the test
    suite's scalar reference helpers)."""
    letters = np.array(list(b"ACGTN"), dtype=np.uint8)
    probs = np.array([0.25, 0.25, 0.25, 0.25, 0.0]) * (1 - n_prob)
    probs[4] = n_prob
    probs /= probs.sum()
    return bytes(rng.choice(letters, size=length, p=probs))


# (read length, padded length, batch): 150 bp reads in 152-wide buckets,
# 16-read batches, the 36 bp minimal-repro shape, and unpadded 150 bp
JIT_EAGER_SHAPES = ((150, 152, 16), (36, 36, 4), (150, 150, 8))


def jit_eager_mismatches() -> list[tuple[int, int, str]]:
    """Compiled vs op-by-op ``extract_metamers`` on JAX's default device.

    An XLA build once miscompiled the mirrored per-step window slices of
    the reverse frames (jit output had the codon order un-reversed, eager
    was right). The fault was shape-dependent, so this runs the shapes the
    byte-parity suites do not cover. Returns the (length, pad, field)
    triples that differ; empty means compiled == eager."""
    import jax.numpy as jnp

    from .ops import encode
    from .ops.genetic_code import encode_seqs_padded

    bad = []
    for length, pad, n in JIT_EAGER_SHAPES:
        rng = np.random.default_rng(9 + length + pad)
        seqs = [random_dna(rng, length) for _ in range(n)]
        codes, lens = encode_seqs_padded(seqs, pad)
        got = encode.extract_metamers(codes, lens)
        want = encode.extract_metamers.__wrapped__(
            jnp.asarray(codes), jnp.asarray(lens))
        if not bool(jnp.all(got.valid == want.valid)):
            bad.append((length, pad, "valid"))
        for field in ("value", "pos"):
            g = jnp.where(got.valid, getattr(got, field), 0)
            w = jnp.where(want.valid, getattr(want, field), 0)
            if not bool(jnp.all(g == w)):
                bad.append((length, pad, field))
    return bad


def skill_world(root) -> tuple[str, str, int]:
    """The verify recipe's world: two 20 kb genomes (species 4 and 8 of a
    4-node taxonomy), a DB built through ``cli build``, and 120 reads of
    150 bp (60 per genome) as FASTQ. Returns (db dir, reads path, reads)."""
    from . import cli

    root = pathlib.Path(root)
    rng = np.random.default_rng(3)
    _write_taxonomy(
        root / "taxonomy",
        [(1, 1, "no rank"), (2, 1, "genus"), (4, 2, "species"),
         (8, 2, "species")],
        {t: f"Name{t}" for t in (1, 2, 4, 8)})
    g1 = bytes(rng.choice(ACGT, 20000))
    g2 = bytes(rng.choice(ACGT, 20000))
    (root / "a.fna").write_text(f">E2E_A.1\n{g1.decode()}\n")
    (root / "b.fna").write_text(f">E2E_B.1\n{g2.decode()}\n")
    (root / "lib.txt").write_text(f"{root / 'a.fna'}\n{root / 'b.fna'}\n")
    (root / "map.tsv").write_text("E2E_A.1\t4\nE2E_B.1\t8\n")
    reads = ([g1[i * 160 : i * 160 + 150] for i in range(60)]
             + [g2[i * 160 : i * 160 + 150] for i in range(60)])
    fq = root / "reads.fq"
    write_fastq(fq, reads)
    db = root / "db"
    rc = cli.main(["build", str(db), str(root / "lib.txt"),
                   str(root / "map.tsv"), "--taxonomy-path",
                   str(root / "taxonomy"), "--verbosity", "0"])
    if rc != 0:
        raise RuntimeError(f"cli build exited {rc}")
    return str(db), str(fq), len(reads)


def write_fastq(path, reads, start: int = 0) -> None:
    """Reads as FASTQ named r{start}, r{start+1}, ... with flat qualities."""
    with open(path, "w") as fh:
        for i, r in enumerate(reads, start):
            fh.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
