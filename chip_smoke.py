"""Smoke test of the classifier on NVIDIA GPUs, through the entry points a
user calls. Run from the repo root:

    python chip_smoke.py                # one card: phases 0-3
    python chip_smoke.py --four-cards   # phase 0, then the 4-card DB shards

Everything runs in this one process (a second JAX process could not get
the card's memory), and every world is generated from fixed seeds.

 0. Device check: exits non-zero unless JAX's default device is a GPU;
    prints the device, JAX version, compile cache, native library, and
    the card's name and power limit from nvidia-smi.
 1. Golden bytes: the golden suite's two worlds (syncmer 0 and 1) built
    and classified on the GPU, byte-compared with tests/golden (files
    produced on the CPU).
 2. Miscompile gate: compiled vs op-by-op metamer extraction on the GPU.
 3. Main path: bench.py's primary world (60M-row decoy-padded skew table,
    AA groups to depth 72, 65,536 reads of 150 bp) written as an on-disk
    DB and a FASTQ file, then `classify` through `cli.main`: (a) fused
    device taxonomer with --batch-reads 0, (b) --device-tax 0, (c) the
    last 4,096 reads on the CPU backend. Requires (a) == (b) over every
    read and (a) == (c) on the subset.

--four-cards runs only the primary world through `classify --db-shards 4`
over four cards and through one card, and compares them per read.

Timings are printed for information, each labelled with the card; they
are not a benchmark. Any failure raises, so the exit code is non-zero and
no result line is printed. The last line of stdout on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import sys
import tempfile
import time

# phase 3c needs the CPU backend beside the GPU
_plats = os.environ.get("JAX_PLATFORMS")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import bench  # noqa: E402
import jax  # noqa: E402
from metabuli_tpu import cli  # noqa: E402
from metabuli_tpu.checks import (golden_outputs, jit_eager_mismatches,  # noqa: E402
                                 write_fastq)

GOLDEN_DIR = ROOT / "tests" / "golden"
# classified count of the compiled reference on the primary world's reads
# (BASELINE_MEASURED.json, "classified")
REFERENCE_CLASSIFIED = 58_984
SUBSET = 4096

_compile_s = [0.0]


def _on_duration(name: str, secs: float, **_):
    if name == "/jax/core/compile/backend_compile_duration":
        _compile_s[0] += secs


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 0
def phase_device() -> tuple[dict, str]:
    """(device dict for the result line, card label for timings)."""
    from metabuli_tpu import compile_cache_dir
    from metabuli_tpu.native import loaded_path

    device = bench.require_gpu()
    gpu = bench.gpu_name_power()
    label = gpu.splitlines()[0]
    log(f"[phase 0] device: platform={device['platform']} "
        f"kind={device['kind']} count={device['count']} "
        f"jax={jax.__version__}")
    log(f"[phase 0] compile cache: {compile_cache_dir()}")
    lib = loaded_path()
    log(f"[phase 0] native library: "
        f"{lib if lib else 'NOT LOADED (Python fallbacks)'}")
    log(f"[phase 0] nvidia-smi name, power.limit: {gpu}")
    return device, label


# ------------------------------------------------------------------ phase 1
def phase_golden(golden_dir=GOLDEN_DIR) -> None:
    for syncmer in (0, 1):
        with tempfile.TemporaryDirectory() as tmp:
            produced = golden_outputs(tmp, syncmer)
        differ = [name for name, text in sorted(produced.items())
                  if (pathlib.Path(golden_dir) / name).read_text() != text]
        if differ:
            raise SmokeFailure(f"golden syncmer={syncmer}: {differ} differ "
                               f"from {golden_dir}")
        log(f"[phase 1] golden syncmer={syncmer}: {len(produced)} files "
            "byte-equal")


# ------------------------------------------------------------------ phase 2
def phase_jit_eager() -> None:
    bad = jit_eager_mismatches()
    if bad:
        raise SmokeFailure(f"jit != eager extraction at {bad}")
    log("[phase 2] jit == eager extraction at every gated shape")


# ------------------------------------------------------------------ phase 3
def write_primary_world(root) -> tuple[str, str, int]:
    """bench.py's primary world as an on-disk DB and a FASTQ file under
    ``root``; returns (db dir, reads path, read count)."""
    from metabuli_tpu.db.formats import DbParameters
    from metabuli_tpu.db.index import MetamerIndex

    tax, _, values, taxids, cap, n_real, reads = bench.prepare_world(
        "primary")
    log(f"[phase 3] world: {len(values)} rows ({n_real} genome-derived), "
        f"max AA group {cap}, {len(reads)} reads")
    db = os.path.join(root, "db")
    MetamerIndex(values=values, taxids=taxids.astype(np.uint32),
                 taxonomy=tax, params=DbParameters(),
                 max_group=cap).save(db)
    fq = os.path.join(root, "reads.fq")
    write_fastq(fq, reads)
    return db, fq, len(reads)


def classify(args: list[str], device=None) -> tuple[dict, float, float]:
    """`classify` through cli.main; (summary, wall s, XLA compile s)."""
    buf = io.StringIO()
    t0, c0 = time.time(), _compile_s[0]
    ctx = (jax.default_device(device) if device is not None
           else contextlib.nullcontext())
    with ctx, contextlib.redirect_stdout(buf):
        rc = cli.main(["classify", *args])
    wall, comp = time.time() - t0, _compile_s[0] - c0
    if rc != 0:
        raise SmokeFailure(f"classify {args} exited {rc}")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]), wall, comp


def read_rows(out_dir: str, job: str) -> list[str]:
    """Classification rows (header dropped), in read order."""
    with open(os.path.join(out_dir, f"{job}_classifications.tsv")) as fh:
        return [ln for ln in fh if not ln.startswith("#")]


def _report(out_dir: str, job: str) -> str:
    with open(os.path.join(out_dir, f"{job}_report.tsv")) as fh:
        return fh.read()


def _first_diff(a: list[str], b: list[str]) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"row {i}: {x.strip()!r} vs {y.strip()!r}"
    return f"row counts {len(a)} vs {len(b)}"


def _run_line(tag: str, label: str, summary: dict, wall: float,
              comp: float) -> None:
    log(f"[phase 3] [{label}] run {tag}: {summary['reads']} reads, "
        f"{summary['classified']} classified, wall {wall:.2f} s, "
        f"XLA compile {comp:.2f} s, retries {summary['retries']}, "
        f"host-taxonomer fallbacks {summary['host_fallbacks']}, "
        f"fused batches {summary['fused_batches']}")


def phase_main(db: str, fq: str, n_reads: int, work, label: str = "",
               batch_reads: int = 0, subset: int = SUBSET,
               threads: int | None = None) -> dict:
    """Runs (a), (b), (c) of phase 3 and checks them; returns the
    summary of run (a)."""
    work = pathlib.Path(work)
    common = ["--seq-mode", "1", "--threads", str(threads or os.cpu_count())]
    out_a, out_b, out_c = (str(work / t) for t in ("a", "b", "c"))

    sa, wall, comp = classify(
        [fq, db, out_a, "a", *common, "--batch-reads", str(batch_reads)])
    _run_line("a (device taxonomer)", label, sa, wall, comp)
    dev = jax.devices()[0]
    if dev.platform != "cpu":
        log(f"[phase 3] [{label}] peak_bytes_in_use after (a): "
            f"{dev.memory_stats()['peak_bytes_in_use']}")
    if sa["fused_batches"] == 0:
        raise SmokeFailure("run (a) never ran the fused device taxonomer")

    sb, wall, comp = classify(
        [fq, db, out_b, "b", *common, "--batch-reads", str(batch_reads),
         "--device-tax", "0"])
    _run_line("b (host taxonomer)", label, sb, wall, comp)
    rows_a, rows_b = read_rows(out_a, "a"), read_rows(out_b, "b")
    if len(rows_a) != n_reads or rows_a != rows_b:
        raise SmokeFailure(f"(a) != (b): {_first_diff(rows_a, rows_b)}")
    if _report(out_a, "a") != _report(out_b, "b"):
        raise SmokeFailure("(a) and (b) reports differ")
    log(f"[phase 3] (a) == (b) byte for byte over {n_reads} reads "
        "(classifications and report)")

    with open(fq) as fh:
        lines = fh.readlines()
    fq_c = str(work / "subset.fq")
    with open(fq_c, "w") as fh:
        fh.writelines(lines[-4 * subset:])
    sc, wall, comp = classify(
        [fq_c, db, out_c, "c", *common, "--batch-reads", str(batch_reads)],
        device=jax.devices("cpu")[0])
    _run_line("c (CPU backend, subset)", "host CPU", sc, wall, comp)
    rows_c = read_rows(out_c, "c")
    if rows_c != rows_a[-subset:]:
        raise SmokeFailure(
            f"(a) != (c) on the subset: {_first_diff(rows_a[-subset:], rows_c)}")
    log(f"[phase 3] (a) == (c) on the last {subset} reads")
    return sa


# ------------------------------------------------------- --four-cards path
def phase_four_cards(db: str, fq: str, n_reads: int, work, label: str,
                     batch_reads: int = 16384,
                     threads: int | None = None) -> None:
    devs = jax.devices()
    if len(devs) < 4:
        raise SmokeFailure(f"--four-cards needs 4 devices, found {len(devs)}")
    work = pathlib.Path(work)
    common = ["--seq-mode", "1", "--threads", str(threads or os.cpu_count()),
              "--batch-reads", str(batch_reads)]
    out_s, out_1 = str(work / "shards4"), str(work / "one")
    ss, wall, comp = classify([fq, db, out_s, "s", *common, "--db-shards", "4"])
    log(f"[four-cards] [{label}] --db-shards 4: {ss['reads']} reads, "
        f"{ss.get('classified')} classified, wall {wall:.2f} s, "
        f"XLA compile {comp:.2f} s")
    if devs[0].platform != "cpu":
        peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devs[:4]]
        log(f"[four-cards] [{label}] peak_bytes_in_use per device: {peaks}")
        # the 60M-row table is a few hundred MB per shard: every card must
        # have held one
        if min(peaks) < (1 << 27):
            raise SmokeFailure(f"a db shard did not land on its card: {peaks}")
    s1, wall, comp = classify([fq, db, out_1, "one", *common],
                              device=devs[0])
    log(f"[four-cards] [{label}] one card: {s1['reads']} reads, "
        f"{s1['classified']} classified, wall {wall:.2f} s, "
        f"XLA compile {comp:.2f} s")
    rows_s, rows_1 = read_rows(out_s, "s"), read_rows(out_1, "one")
    if len(rows_1) != n_reads or rows_s != rows_1:
        raise SmokeFailure(
            f"--db-shards 4 != one card: {_first_diff(rows_s, rows_1)}")
    log(f"[four-cards] --db-shards 4 == one card over all {n_reads} reads")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the --db-shards 4 path on four cards "
                         "and its one-card comparison")
    args = ap.parse_args(argv)
    t_start = time.time()
    device, label = phase_device()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            t0 = time.time()
            db, fq, n = write_primary_world(tmp)
            log(f"[four-cards] [{label}] set-up (world, DB, FASTQ): "
                f"{time.time() - t0:.2f} s")
            phase_four_cards(db, fq, n, tmp, label)
        else:
            t0 = time.time()
            phase_golden()
            phase_jit_eager()
            log(f"[phase 1-2] [{label}] {time.time() - t0:.2f} s")
            t0 = time.time()
            db, fq, n = write_primary_world(tmp)
            log(f"[phase 3] [{label}] set-up (world, DB, FASTQ): "
                f"{time.time() - t0:.2f} s")
            sa = phase_main(db, fq, n, tmp, label)
            log(f"[phase 3] classified {sa['classified']} of {n}; the "
                f"compiled reference classified {REFERENCE_CLASSIFIED} of "
                "65536 on the same reads")
    log(f"[done] [{label}] total {time.time() - t_start:.2f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
