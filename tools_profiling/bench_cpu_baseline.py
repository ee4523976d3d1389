"""Measure the COMPILED REFERENCE classifier's throughput on the bench world.

Gives bench.py a *measured* `vs_baseline` divisor: this script writes
the exact bench DB of a bench.py
configuration (default: the PRIMARY adversarial "skew" world, 60M rows)
in reference on-disk format (diffIdx/info/split via the
byte-parity-tested writers in db/formats.py), samples the exact bench
reads, and times tests/ref_oracle/classify_oracle (the reference's own
Classifier stack, OpenMP) on them.

DB load time is excluded the same way bench.py excludes device staging:
each thread count runs the oracle twice — once on the full read set, once
on a small prefix — and reports the marginal rate
(T_full - T_small) / (N_full - N_small), which cancels the constant
DB-load + startup cost.

The per-core rate is also scaled to a nominal 32-core socket assuming
PERFECT linear scaling (context only; bench.py divides by the measured
all-cores rate). Needs the reference source tree that
tests/helpers/ref_oracle.py compiles.

Writes BASELINE_MEASURED.json at the repo root, which bench.py reads for
`vs_baseline`.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import bench  # noqa: E402
from helpers import ref_oracle  # noqa: E402

N_SMALL = 4096
NOMINAL_SOCKET_CORES = 32
CONFIG = os.environ.get("METABULI_BASELINE_CONFIG", "primary")


def log(msg):
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def write_reference_db(tmp, tax, values, taxids_internal):
    from metabuli_tpu.db.formats import (DbParameters, write_db_files,
                                         write_taxid_list)

    db = pathlib.Path(tmp) / "refdb"
    taxdir = db / "taxonomy"
    taxdir.mkdir(parents=True)
    # info holds EXTERNAL taxids in the reference layout
    ext = tax.internal2org[np.asarray(taxids_internal, np.int64)].astype(
        np.uint32)
    t0 = time.time()
    write_db_files(str(db), values, ext, 4096)
    write_taxid_list(str(db / "taxID_list"), np.unique(ext))
    DbParameters(db_name="bench", creation_date="2026-08-21",
                 kmer_format=2).write(str(db / "db.parameters"))
    # NCBI dmp with the terminating column splitByDelimiter expects
    nodes, names = [], []
    for i in range(1, tax.n_nodes() + 1):
        nodes.append(f"{tax.to_original(i)}\t|\t"
                     f"{tax.to_original(int(tax.parent[i]))}\t|\t"
                     f"{tax.rank_of(i)}\t|\t\t|\n")
        names.append(f"{tax.to_original(i)}\t|\t{tax.name_of(i)}\t|\t\t|\t"
                     f"scientific name\t|\n")
    (taxdir / "nodes.dmp").write_text("".join(nodes))
    (taxdir / "names.dmp").write_text("".join(names))
    (taxdir / "merged.dmp").write_text("")
    log(f"reference DB written in {time.time()-t0:.1f}s "
        f"({len(values)} rows)")
    return str(db)


def run_oracle(binary, q, db, out, job, threads):
    # the reference Reporter fopen()s into `out` unchecked and segfaults
    # if the directory is absent (the CLI's FileUtil wrapper creates it)
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    t0 = time.time()
    res = subprocess.run(
        [binary, q, db, out, job, "seq-mode=1", f"threads={threads}",
         "kmer-format=2", "ram-usage=32"],
        capture_output=True, text=True, timeout=7200, env=env)
    dt = time.time() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"rc={res.returncode}\nSTDERR: {res.stderr[-2000:]}\n"
            f"STDOUT: {res.stdout[-2000:]}")
    cls_file = pathlib.Path(out) / f"{job}_classifications.tsv"
    n_classified = 0
    with open(cls_file) as fh:
        for line in fh:
            n_classified += line.startswith("1\t")
    return dt, n_classified


def main():
    binary = ref_oracle.build("classify_oracle")
    # persistent workdir: the 60M-row reference DB write costs ~1 min and
    # is bit-deterministic; reruns skip it
    tmp = os.path.join(bench.BENCH_CACHE,
                       f"baseline_{CONFIG}_v{bench.BENCH_DB_VERSION}")
    os.makedirs(tmp, exist_ok=True)
    tax, genomes, values, taxids, cap, n_real, reads = bench.prepare_world(
        CONFIG, bench.BENCH_CACHE)
    if os.path.exists(os.path.join(tmp, "refdb", "diffIdx")):
        db = os.path.join(tmp, "refdb")
    else:
        db = write_reference_db(tmp, tax, values, taxids)
    qdir = pathlib.Path(tmp)
    q_full = qdir / "reads_full.fna"
    q_small = qdir / "reads_small.fna"
    q_full.write_text("".join(
        f">r{i}\n{r.decode()}\n" for i, r in enumerate(reads)))
    q_small.write_text("".join(
        f">r{i}\n{r.decode()}\n" for i, r in enumerate(reads[:N_SMALL])))

    results = {}
    ncpu = os.cpu_count()
    for threads in sorted({1, ncpu}):
        out = str(qdir / f"out{threads}")
        t_small, _ = run_oracle(binary, str(q_small), db, out,
                                f"small{threads}", threads)
        log(f"threads={threads}: {N_SMALL} reads in {t_small:.1f}s "
            f"(incl. DB load)")
        t_full, n_cls = run_oracle(binary, str(q_full), db, out,
                                   f"full{threads}", threads)
        n = len(reads)
        rate = (n - N_SMALL) / max(t_full - t_small, 1e-9)
        log(f"threads={threads}: {n} reads in {t_full:.1f}s; marginal "
            f"{rate:.0f} reads/s; classified {n_cls} "
            f"({100*n_cls/n:.1f}%)")
        results[threads] = {
            "t_small_s": round(t_small, 2),
            "t_full_s": round(t_full, 2),
            "marginal_reads_per_s": round(rate, 1),
            "classified": n_cls,
        }

    per_core = max(r["marginal_reads_per_s"] / t
                   for t, r in results.items())
    socket = per_core * NOMINAL_SOCKET_CORES
    out = {
        "config": CONFIG,
        "world": {"db_rows": int(len(values)),
                  "genome_rows": int(n_real),
                  "cap": int(cap),
                  "n_reads": len(reads),
                  "read_len": bench.CONFIGS[CONFIG]["read_len"]},
        "host": {"cpus": ncpu,
                 "model": _cpu_model()},
        "method": "marginal rate (T_full - T_small)/(N_full - N_small);"
                  " cancels DB load + startup, matching bench.py's"
                  " exclusion of device staging",
        "oracle": "tests/ref_oracle/classify_oracle (reference"
                  " Classifier stack, OpenMP)",
        "threads": results,
        "all_cores_reads_per_s": results[ncpu]["marginal_reads_per_s"],
        "per_core_reads_per_s": round(per_core, 1),
        "nominal_socket_cores": NOMINAL_SOCKET_CORES,
        "socket_scaling": "perfect linear (reference-favoring)",
        "socket_reads_per_s": round(socket, 1),
    }
    (ROOT / "BASELINE_MEASURED.json").write_text(
        json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))


def _cpu_model():
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


if __name__ == "__main__":
    main()
