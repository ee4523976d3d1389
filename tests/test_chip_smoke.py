"""chip_smoke.py's phases at tiny size on the CPU, its refusal to run
without a GPU, and bench.py's. The full-size run needs a GPU (run
``python chip_smoke.py`` there); the ``gpu`` test below runs phases 1-2 on
one when present."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from metabuli_tpu.checks import skill_world  # noqa: E402


def test_golden_phase_passes_on_cpu():
    chip_smoke.phase_golden()


def test_golden_phase_catches_a_changed_byte(tmp_path):
    golden = tmp_path / "golden"
    shutil.copytree(chip_smoke.GOLDEN_DIR, golden)
    f = golden / "classifications_s0.tsv"
    f.write_text(f.read_text().replace("\t", " ", 1))
    with pytest.raises(chip_smoke.SmokeFailure, match="classifications_s0"):
        chip_smoke.phase_golden(golden)


def test_jit_eager_phase_passes_on_cpu():
    chip_smoke.phase_jit_eager()


def test_main_phase_device_equals_host_taxonomer_on_skill_world(tmp_path):
    db, fq, n = skill_world(tmp_path / "world")
    # 32-read batches: batches 0-1 are dispatched before the first drain
    # seeds the fused grids, so they go through the host taxonomer;
    # batches 2-3 run the fused device taxonomer
    s = chip_smoke.phase_main(db, fq, n, tmp_path, "cpu", batch_reads=32,
                              subset=40, threads=2)
    assert s["reads"] == n == 120
    assert s["classified"] == 120
    assert s["fused_batches"] == 2


def test_read_rows_and_first_diff(tmp_path):
    (tmp_path / "j_classifications.tsv").write_text(
        "#header\n1\tr0\t4\n0\tr1\t0\n")
    rows = chip_smoke.read_rows(str(tmp_path), "j")
    assert rows == ["1\tr0\t4\n", "0\tr1\t0\n"]
    assert "row 1" in chip_smoke._first_diff(rows, [rows[0], "1\tr1\t8\n"])
    assert "row counts 2 vs 1" in chip_smoke._first_diff(rows, rows[:1])


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    res = _run([os.path.join(REPO, script)], REPO)
    assert res.returncode != 0
    assert not _printed_result(res.stdout)
    assert "needs a GPU" in res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert not _printed_result(res.stdout)


@pytest.mark.gpu
def test_golden_and_jit_phases_on_gpu(gpu_device):
    with jax.default_device(gpu_device):
        chip_smoke.phase_golden()
        chip_smoke.phase_jit_eager()


def test_four_cards_phase_on_cpu_mesh(tmp_path):
    # the test session's 8 virtual CPU devices: --db-shards 4 runs a
    # (2 data x 4 db) mesh and must equal the one-device run per read
    db, fq, n = skill_world(tmp_path / "world")
    chip_smoke.phase_four_cards(db, fq, n, tmp_path, "cpu", batch_reads=32,
                                threads=2)
