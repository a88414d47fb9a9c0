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


def test_phase_16_entries_name_built_launchers_and_logged_kernels():
    """Each phase-16 entry's launcher is one the kernel library builds, and
    its dispatch_log name is the one its kernel's wrapper logs for the
    quadrotor's (13x4, m = 8) or QuadrotorRate's (10x4) shapes."""
    import chip_smoke
    from cddp_tpu_torch.ops.kernels import ipddp_riccati, riccati

    built = {stem for stems in chip_smoke.launchers().values() for stem in stems}
    nx = {"quadrotor": 13, "quadrotor_rate": 10}
    for name, logged, kernel, model, launcher in chip_smoke.QUAD_ENTRIES:
        assert launcher in built, launcher
        if kernel == "riccati_backward":
            assert logged == riccati.dispatch_name(nx[model], 4)
        elif kernel == "ipddp_backward":
            assert logged == ipddp_riccati.dispatch_name(nx[model], 4, 8)
        else:
            assert logged == name and name.startswith(kernel)
    assert {e[0] for e in chip_smoke.QUAD_ENTRIES} == {
        f"{k}@{m}" for k in ("riccati_backward", "forward_rollout", "open_loop_rollout",
                             "ip_forward", "ipddp_backward") for m in nx} | {
        "ip_forward_track@quadrotor"}


def _plain_kernels(monkeypatch):
    """Every kernel wrapper of phase 16's path replaced by its plain version,
    which records a launch under the name the kernel logs; the card's
    clocks and memory counters stubbed."""
    import chip_smoke
    from cddp_tpu_torch.ops.kernels import dispatch_log, ip_rollout, riccati
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
    from cddp_tpu_torch.solvers import clddp

    def k1(*a):
        dispatch_log.launched(riccati.dispatch_name(a[0].shape[-1], a[1].shape[-1]),
                              a[0].shape[0])
        return riccati.riccati_backward_plain(*a)

    def k2(consts, *a):
        dispatch_log.launched("forward_rollout" + consts.variant + consts.tag, a[0].shape[0])
        return rollout_ops.forward_rollout_plain(consts, *a)

    def k4(model, entry, x0, U, dt):
        dispatch_log.launched("open_loop_rollout" + entry.tag, x0.shape[0])
        return ip_rollout.open_loop_rollout_plain(model, x0, U, dt)

    public = ip_rollout.open_loop_rollout

    def k4_public(model, x0, U, dt, kernel=True):
        entry = rollout_ops.model_entry(model)
        if not kernel or rollout_ops.lane_integrator(model, entry) is None:
            return public(model, x0, U, dt, kernel)
        return k4(model, entry, x0, U, dt)

    def k5(fc, *a):
        dispatch_log.launched("ip_forward" + fc.lane.variant + fc.lane.tag, a[0].shape[0])
        return ip_rollout.ip_forward_plain(fc, *a)

    def k6(*a):
        dispatch_log.launched(ric.dispatch_name(a[0].shape[-1], a[1].shape[-1], a[7].shape[-1]),
                              a[0].shape[0])
        return ric.ipddp_backward_plain(*a)

    for mod, name, fn in ((riccati, "_launch", k1), (riccati, "riccati_backward", k1),
                          (clddp, "riccati_backward", k1), (rollout_ops, "_launch", k2),
                          (rollout_ops, "forward_rollout", k2),
                          (ip_rollout, "_launch_open_loop", k4),
                          (ip_rollout, "open_loop_rollout", k4_public),
                          (ip_rollout, "_launch_forward", k5), (ip_rollout, "ip_forward", k5),
                          (ric, "_launch", k6), (ric, "ipddp_backward", k6)):
        monkeypatch.setattr(mod, name, fn)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    class Profile:  # no device rows on the CPU; its CPU records cost tens of seconds
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return []

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps, warm=True: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, kernel, reps, events_ok=False: (fn(), 1.0, "dry run")[1:])


def test_phase_16_dry_run(monkeypatch, tmp_path):
    """Phase 16's plumbing on the CPU at tiny sizes (B_CHECK = 16, QUAD_B =
    32, every horizon 10, every solve at most 3 iterations): the kernels
    replaced by their plain versions that count a launch
    (``_plain_kernels``), the plain references (``quad_plain_refs``)
    computed in this process; each check, fleet, the golden (held to a float64
    plain solve of its problem cut so, saved as the golden file), the
    single solve, the anchor (on a short line near hover: a figure-8
    compressed into 10 steps cannot meet the anchor's bounds, which are the
    card's to hold) and the timings run through; every entry of
    ``QUAD_ENTRIES`` gets its launches from a fleet that drives it, its
    errors from (a) and its timing tuple."""
    import numpy as np

    import chip_smoke
    import cddp_tpu_torch as tt

    for name, value in (("B_CHECK", 16), ("QUAD_B", 32), ("QUAD_CHECK_B", 8), ("QUAD_N", 10),
                        ("QUAD_KERNEL_B", 8),
                        ("RATE_N", 10), ("BENCH_N", 10), ("BENCH_REPS", 2),
                        ("FIG8_ITERS", 3)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name in ("quad_options", "bench_options"):
        full = getattr(chip_smoke, name)
        monkeypatch.setattr(chip_smoke, name,
                            lambda tt, iterations=3, full=full: full(tt, min(iterations, 3)))
    monkeypatch.setattr(chip_smoke, "figure8_problem", lambda tt, dtype, device: chip_smoke.
                        quad_problem(tt, dtype, device, goal=(0.05, 0.0, 0.05), tracking=True))
    dev = torch.device("cpu")
    prob = chip_smoke.quad_problem(tt, torch.float64, dev)
    g = tt.solve(prob.replace(x0=prob.x0[None]), "IPDDP", chip_smoke.plain_ip_options(
        tt, chip_smoke.quad_options(tt, 120)), U0=chip_smoke.hover(prob, 1))
    np.savez(tmp_path / "golden.npz", X=g.state_trajectory[0].numpy(),
             U=g.control_trajectory[0].numpy(), cost=g.final_objective[0].numpy(),
             status=g.status_code[0].numpy(), iterations=g.iterations_completed[0].numpy())
    monkeypatch.setattr(chip_smoke, "GOLDEN", tmp_path / "golden.npz")
    _plain_kernels(monkeypatch)

    class Refs:  # the plain references computed in this process
        def __init__(self, out):
            self.out = out

        def result(self, dev):
            return self.out

        def close(self):
            pass

    monkeypatch.setattr(chip_smoke, "start_quad_plain_refs",
                        lambda tt, dev: Refs(chip_smoke.quad_plain_refs(tt, dev)))
    launches, errs, single = chip_smoke.phase_quadrotor(tt, dev, "dry run")
    timing = chip_smoke.time_quad_kernels(tt, dev, single, "dry run")
    names = {e[0] for e in chip_smoke.QUAD_ENTRIES}
    assert set(launches) == names and all(n >= 1 for n in launches.values())
    assert launches["open_loop_rollout@quadrotor"] == 1
    assert launches["open_loop_rollout@quadrotor_rate"] == 1
    assert launches["ipddp_backward@quadrotor"] == 3  # one a per-pass iteration
    for tag in ("float64", "float32"):
        assert set(errs[tag]) == names
    assert set(timing) == names and all(len(v) == 6 for v in timing.values())


def test_quad_plain_refs_process_failure_is_raised():
    """The plain references' process (``chip_smoke.py --quad-plain-refs``)
    needs the card: here it exits with an error, which ``result`` raises,
    and ``close`` removes its files."""
    import chip_smoke

    refs = chip_smoke.QuadPlainRefs()
    try:
        with pytest.raises(AssertionError, match="exited with status"):
            refs.result(torch.device("cpu"))
    finally:
        refs.close()
    assert not Path(refs._dir.name).exists()
