"""Golden regression suite — the analogue of the reference's
Metabuli-regression (`azure-pipelines.yml:64-68`): build a deterministic
tiny DB, classify canned reads, and byte-compare the outputs against
committed fixtures.

Regenerate fixtures intentionally with:
    REGEN_GOLDEN=1 python -m pytest tests/test_golden.py -q
and review the diff before committing.
"""

import os
import pathlib

import pytest

from metabuli_tpu.checks import golden_outputs

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
REGEN = bool(os.environ.get("REGEN_GOLDEN"))


def _fixture_compare(name: str, produced: str):
    golden_path = GOLDEN_DIR / name
    if REGEN:
        GOLDEN_DIR.mkdir(exist_ok=True)
        golden_path.write_text(produced)
        return
    assert golden_path.exists(), f"missing fixture {name}; run with REGEN_GOLDEN=1"
    assert produced == golden_path.read_text(), f"{name} diverged from fixture"


@pytest.mark.parametrize("syncmer", [0, 1])
def test_golden_classify(tmp_path, syncmer):
    # the world itself lives in metabuli_tpu.checks, shared with
    # chip_smoke.py, which compares the same files on a GPU
    for name, produced in golden_outputs(tmp_path, syncmer).items():
        _fixture_compare(name, produced)
