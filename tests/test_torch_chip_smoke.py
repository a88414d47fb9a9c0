"""chip_smoke.py on a machine without a GPU: it must fail and print no
result (the port has no CPU fallback), both from the repository and from a
directory that holds chip_smoke.py alone."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; run chip_smoke.py itself")
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout
