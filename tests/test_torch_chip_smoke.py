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


def test_phase_14_entries_name_built_launchers_and_logged_kernels():
    """Each phase-14 entry's launcher is one the kernel library builds
    (``launchers``), and its dispatch_log name is the one its kernel's
    wrapper logs for the entry's model."""
    import chip_smoke
    from cddp_tpu_torch.ops.kernels import ipddp_riccati, riccati

    built = {stem for stems in chip_smoke.launchers().values() for stem in stems}
    shapes = {"pendulum": (2, 1, 2), "cartpole": (4, 1)}
    for name, logged, kernel, model, launcher in chip_smoke.ZOO_ENTRIES:
        assert launcher in built, launcher
        if kernel == "riccati_backward":
            assert logged == riccati.dispatch_name(*shapes[model][:2])
        elif kernel == "ipddp_backward":
            assert logged == ipddp_riccati.dispatch_name(*shapes[model])
        else:
            assert logged == name and logged.endswith("@" + model)
