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


def test_phase_15_entries_name_built_launchers_and_logged_kernels():
    """Each phase-15 entry's launcher is one the kernel library builds, its
    dispatch_log name the one its kernel's wrapper logs for the car's,
    the forklift's or the LTISystem's shapes, and its launch count is read
    from a run of phase 15's main path."""
    import chip_smoke
    from cddp_tpu_torch.models import Car, Forklift
    from cddp_tpu_torch.ops.kernels import ipddp_riccati, riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    built = {stem for stems in chip_smoke.launchers().values() for stem in stems}
    tags = {"car": rollout_ops.model_entry(Car()).tag,
            "forklift": rollout_ops.model_entry(Forklift()).tag}
    names = set()
    for name, logged, kernel, model, launcher in chip_smoke.DISCRETE_ENTRIES:
        assert launcher in built, launcher
        names.add(name)
        if kernel == "riccati_backward":
            assert logged == riccati.dispatch_name(4, 2)
        elif kernel == "ipddp_backward":
            assert logged == ipddp_riccati.dispatch_name(4, 2, 4)
        else:
            assert logged == kernel + tags[model] == name
    assert names == {"riccati_backward@car", "riccati_backward@lti", "forward_rollout@car",
                     "open_loop_rollout@car", "open_loop_rollout@forklift", "ip_forward@car",
                     "ipddp_backward@car"}


def test_whole_solve_plain_drivers_are_timed_at_b_check():
    """Phases 4-13 time each whole solve's plain driver on the first B_CHECK
    instances of the main path's seeds, and say so ("plain_at")."""
    import chip_smoke

    p = chip_smoke.flagship_problem(__import__("cddp_tpu_torch"), torch.float64, "cpu")
    x0 = torch.zeros(chip_smoke.B_CHECK + 5, 3, dtype=torch.float64)
    seeds = (x0, x0[:, :2], torch.tensor(1.0))
    pc, sc = chip_smoke.check_slice(p.replace(x0=x0), seeds)
    assert pc.x0.shape[0] == chip_smoke.B_CHECK
    assert [tuple(t.shape) for t in sc] == [(chip_smoke.B_CHECK, 3), (chip_smoke.B_CHECK, 2), ()]
    assert chip_smoke.plain_at().startswith(f"B={chip_smoke.B_CHECK}, float32")
    assert chip_smoke.fleet_batch("plain driver", x0).shape[0] == chip_smoke.B_CHECK
    assert chip_smoke.fleet_batch("whole-solve kernel", x0).shape[0] == x0.shape[0]
