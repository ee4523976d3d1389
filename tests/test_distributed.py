"""Distributed helpers (single-process degenerate mode on the CPU mesh)."""

import numpy as np
import jax

from metabuli_tpu.parallel import distributed as dist
from metabuli_tpu.parallel.mesh import build_sharded_classify, merge_shard_matches


def test_global_mesh_and_explicit_placement():
    dist.initialize()  # single-process no-op
    mesh = dist.global_mesh(n_db=2)
    assert mesh.shape["data"] == 4 and mesh.shape["db"] == 2

    rng = np.random.default_rng(0)
    n = 4096
    aa = np.sort(rng.choice(1 << 28, size=n, replace=False).astype(np.uint64))
    values = np.sort((aa << np.uint64(24)) | rng.integers(0, 1 << 24, n).astype(np.uint64))
    taxids = rng.integers(1, 64, n).astype(np.int32)
    t2s = (np.arange(64, dtype=np.int32) % 16) + 1

    db_arrays = dist.distribute_index(values, taxids, mesh)
    *db_global, n_pad, iters = db_arrays
    B = 8
    codes = rng.integers(0, 4, size=(B, 120)).astype(np.uint8)
    lens = np.full(B, 120, np.int32)
    reads = dist.distribute_reads(
        codes, lens, np.zeros(B, np.int32), np.arange(B, dtype=np.int32), mesh
    )
    step = build_sharded_classify(mesh, n_pad=n_pad, search_iters=iters,
                                  cap=8, max_matches=4096)
    out = step(*db_global, t2s, *reads)
    merged = merge_shard_matches(out, B, t2s)
    assert merged["n_matches"] >= 0  # executes end-to-end with explicit shardings


def test_two_process_distributed_run():
    """Real multi-process jax.distributed execution of the sharded classify
    step (2 processes x 2 CPU devices = 4-device global mesh)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "helpers", "dist_worker.py")
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", f"localhost:{port}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i}: OK" in out
        assert "global=4" in out


def test_distributed_classify_matches_single(tmp_path):
    """CLI classify with --db-shards (sharded mesh path) produces
    byte-identical classifications to the single-device path."""
    import os

    from metabuli_tpu import cli
    from metabuli_tpu.db.build import build_database
    from metabuli_tpu.params import BuildParams

    rng = np.random.default_rng(12)
    genomes = {
        "DS_A.1": (bytes(rng.choice(np.array(list(b"ACGT"), np.uint8), 4000)), 4),
        "DS_B.1": (bytes(rng.choice(np.array(list(b"ACGT"), np.uint8), 4000)), 8),
    }
    taxdir = tmp_path / "taxonomy"
    taxdir.mkdir()
    (taxdir / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tgenus\t|\n"
        "4\t|\t2\t|\tspecies\t|\n8\t|\t2\t|\tspecies\t|\n")
    (taxdir / "names.dmp").write_text(
        "".join(f"{t}\t|\tN{t}\t|\t\t|\tscientific name\t|\n"
                for t in (1, 2, 4, 8)))
    (taxdir / "merged.dmp").write_text("")
    paths = []
    for acc, (seq, _) in genomes.items():
        fp = tmp_path / f"{acc}.fna"
        fp.write_text(f">{acc}\n{seq.decode()}\n")
        paths.append(str(fp))
    (tmp_path / "lib.txt").write_text("\n".join(paths) + "\n")
    (tmp_path / "map.tsv").write_text(
        "".join(f"{a}\t{t}\n" for a, (_, t) in genomes.items()))
    db = str(tmp_path / "db")
    build_database(db, str(tmp_path / "lib.txt"), str(tmp_path / "map.tsv"),
                   str(taxdir), BuildParams(gene_prediction=0, mask_mode=0))

    reads = []
    for acc, (g, _) in genomes.items():
        for i in range(20):
            r = bytearray(g[i * 190 : i * 190 + 150])
            r[70] = ord("G") if r[70] != ord("G") else ord("C")
            reads.append(bytes(r))
    q = tmp_path / "r.fna"
    q.write_text("".join(f">r{i}\n{r.decode()}\n" for i, r in enumerate(reads)))

    o1 = str(tmp_path / "out1")
    assert cli.main(["classify", str(q), db, o1, "j",
                     "--seq-mode", "1", "--batch-reads", "16"]) == 0
    o2 = str(tmp_path / "out2")
    assert cli.main(["classify", str(q), db, o2, "j",
                     "--seq-mode", "1", "--batch-reads", "16",
                     "--db-shards", "2"]) == 0
    a = open(os.path.join(o1, "j_classifications.tsv")).read()
    b = open(os.path.join(o2, "j_classifications.tsv")).read()
    assert a == b
    ra = open(os.path.join(o1, "j_report.tsv")).read()
    rb = open(os.path.join(o2, "j_report.tsv")).read()
    assert ra == rb


def test_two_process_cli_classify(tmp_path):
    """Full CLI classify across 2 jax.distributed processes (2x2 CPU mesh)
    merges to the same classifications as a single-process run."""
    import os
    import socket
    import subprocess
    import sys

    from metabuli_tpu import cli
    from metabuli_tpu.db.build import build_database
    from metabuli_tpu.params import BuildParams

    rng = np.random.default_rng(21)
    genomes = {
        "TP_A.1": (bytes(rng.choice(np.array(list(b"ACGT"), np.uint8), 4000)), 4),
        "TP_B.1": (bytes(rng.choice(np.array(list(b"ACGT"), np.uint8), 4000)), 8),
    }
    taxdir = tmp_path / "taxonomy"
    taxdir.mkdir()
    (taxdir / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tgenus\t|\n"
        "4\t|\t2\t|\tspecies\t|\n8\t|\t2\t|\tspecies\t|\n")
    (taxdir / "names.dmp").write_text(
        "".join(f"{t}\t|\tN{t}\t|\t\t|\tscientific name\t|\n"
                for t in (1, 2, 4, 8)))
    (taxdir / "merged.dmp").write_text("")
    paths = []
    for acc, (seq, _) in genomes.items():
        fp = tmp_path / f"{acc}.fna"
        fp.write_text(f">{acc}\n{seq.decode()}\n")
        paths.append(str(fp))
    (tmp_path / "lib.txt").write_text("\n".join(paths) + "\n")
    (tmp_path / "map.tsv").write_text(
        "".join(f"{a}\t{t}\n" for a, (_, t) in genomes.items()))
    db = str(tmp_path / "db")
    build_database(db, str(tmp_path / "lib.txt"), str(tmp_path / "map.tsv"),
                   str(taxdir), BuildParams(gene_prediction=0, mask_mode=0))
    reads = []
    for acc, (g, _) in genomes.items():
        for i in range(12):
            reads.append(g[i * 300 : i * 300 + 150])
    q = tmp_path / "r.fna"
    q.write_text("".join(f">r{i}\n{r.decode()}\n" for i, r in enumerate(reads)))

    o1 = str(tmp_path / "out1")
    assert cli.main(["classify", str(q), db, o1, "dj",
                     "--seq-mode", "1", "--batch-reads", "16"]) == 0

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "helpers",
                          "dist_cli_worker.py")
    o2 = str(tmp_path / "out2")
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", f"localhost:{port}",
             str(q), db, o2],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
    a = open(os.path.join(o1, "dj_classifications.tsv")).read()
    b = open(os.path.join(o2, "dj_classifications.tsv")).read()
    assert a == b
