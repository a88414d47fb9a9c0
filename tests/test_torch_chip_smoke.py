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
        dispatch_log.launched("ip_forward" + fc.tag, a[0].shape[0])
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

    checked = chip_smoke.quad_checks(tt, dev, "dry run",
                                     Refs(chip_smoke.quad_plain_refs(tt, dev)))
    launches, errs, single = chip_smoke.phase_quadrotor(tt, dev, "dry run", checked)
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
    """The plain references' process (``chip_smoke.py --side quadrotor``)
    needs the card: here it exits with an error, which ``result`` raises,
    and ``close`` removes its files."""
    import chip_smoke

    refs = chip_smoke.Side("quadrotor")
    try:
        with pytest.raises(AssertionError, match="exited with status"):
            refs.result(torch.device("cpu"))
    finally:
        refs.close()
    assert not Path(refs._dir.name).exists()


@pytest.mark.parametrize("errs", [{}, {"float64": {"k": 0.0}, "float32": {}},
                                  {"float64": {}, "float32": {"k": 0.0}}])
def test_checks_that_returned_nothing_are_refused(errs):
    """A phase given check errors with no entry for a dtype (a side process
    or check that returned nothing) fails before its fleets run."""
    import chip_smoke

    with pytest.raises(AssertionError, match="returned no errors"):
        chip_smoke.phase_discrete(None, None, "dry run", errs)
    full = {"float64": {"k": 0.0}, "float32": {"k": 1.0}}
    assert chip_smoke.checked_errs("phase 15", full) is full


def test_phase_17_entries_name_built_launchers_and_logged_kernels():
    """Each phase-17 entry's launcher is one the kernel library builds, its
    dispatch_log name the one its kernel's wrapper logs for the attitude
    model (6x3 or 7x3; m = 6), and the entries are the eight kernels of the
    trio's path on each model but the whole solves the tables leave out
    (``whole_takes``: kernel 3 on the MRP model, kernel 7 on the Euler
    model), which then take no horizon in ``rollout.WHOLE_MAX_HORIZON``."""
    import chip_smoke
    from cddp_tpu_torch.models import EulerAttitude, MrpAttitude, QuaternionAttitude
    from cddp_tpu_torch.ops.kernels import ipddp_riccati, mega_ipddp, riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    built = {stem for stems in chip_smoke.launchers().values() for stem in stems}
    models = {"euler_attitude": EulerAttitude, "quaternion_attitude": QuaternionAttitude,
              "mrp_attitude": MrpAttitude}
    kernels = ("riccati_backward", "forward_rollout", "clddp_solve", "open_loop_rollout",
               "ip_forward", "ipddp_backward", "ipddp_solve", "logddp_solve")
    left_out = {("clddp_solve", "mrp_attitude"), ("ipddp_solve", "euler_attitude")}
    assert {e[0] for e in chip_smoke.att_entries()} == {
        f"{k}@{m}" for k in kernels for m in models if (k, m) not in left_out}
    for m in models:
        for kernel in ("clddp_solve", "ipddp_solve", "logddp_solve"):
            assert chip_smoke.whole_takes(kernel, m) == ((kernel, m) not in left_out)
            assert (m in rollout_ops.WHOLE_MAX_HORIZON[kernel]) == ((kernel, m) not in left_out)
        assert m in rollout_ops.ROLLOUT_MODELS and m in mega_ipddp.LOG_BOX_ROWS
    for name, logged, kernel, model, launcher in chip_smoke.att_entries():
        assert launcher in built, launcher
        mdl = models[model](device="cpu")
        nx = mdl.state_dim
        assert rollout_ops.model_entry(mdl).tag == "@" + model
        if kernel == "riccati_backward":
            assert logged == riccati.dispatch_name(nx, 3)
        elif kernel == "ipddp_backward":
            assert logged == ipddp_riccati.dispatch_name(nx, 3, 6)
        else:
            assert logged == name
    assert set(mega_ipddp.MS_BOX_ROWS).isdisjoint(models)


def _plain_whole_solves(monkeypatch):
    """The whole-solve kernels 3, 7, 8 and 9 replaced by their plain
    drivers, which record a launch under the name the kernel logs and
    return work rows of ones; the dispatchers call them on CPU tensors
    too."""
    from cddp_tpu_torch.ops.kernels import (dispatch_log, mega_clddp, mega_ipddp, mega_logddp,
                                            mega_msipddp)
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
    from cddp_tpu_torch.solvers import clddp, ipddp, logddp, msipddp

    def counted(name, sol, B, rows):
        dispatch_log.launched(name, B)
        return sol, torch.ones(rows, B)

    def k3(p, o, X, U, k, K):
        lane = rollout_ops.lane_consts(p)
        return counted("clddp_solve" + lane.variant + lane.tag,
                       clddp._solve(p, o.replace(backward_engine="scan"), X, U, k, K),
                       X.shape[0], 2)

    def k7(p, o, X, U, Y, S, G, L, mu0, ku0, Ku0, terminal=None):
        sol = ipddp._drive(p, o.replace(backward_engine="scan", ipddp=dataclasses.replace(
            o.ipddp, forward_engine="scan")), X, U, Y, S, G, L, mu0, ku0, Ku0, terminal=terminal)
        return counted(mega_ipddp.dispatch_name(p), sol, X.shape[0], 13)

    def k9(p, o, X, U, k, K):
        lane = rollout_ops.lane_consts(p)
        return counted("logddp_solve" + lane.variant + lane.tag, logddp._drive(p, o, X, U, k, K),
                       X.shape[0], 2)

    def k8(p, o, *seeds):
        lane = rollout_ops.lane_consts(p)
        sol, st = msipddp._drive(p, o, *seeds)
        dispatch_log.launched("msipddp_solve" + lane.variant + lane.tag, sol.status_code.shape[0])
        return sol, st, torch.ones(4, sol.status_code.shape[0])

    import dataclasses

    monkeypatch.setattr(mega_clddp, "launch_counting_work", k3)
    monkeypatch.setattr(mega_clddp, "clddp_solve", lambda *a: mega_clddp._launch(*a))
    monkeypatch.setattr(mega_ipddp, "_run", k7)
    monkeypatch.setattr(mega_ipddp, "ipddp_solve", lambda *a, **k: mega_ipddp._launch(*a, **k))
    monkeypatch.setattr(mega_logddp, "launch_counting_work", k9)
    monkeypatch.setattr(mega_logddp, "logddp_solve", lambda *a: mega_logddp._launch(*a))
    monkeypatch.setattr(mega_msipddp, "launch_counting_work", k8)
    monkeypatch.setattr(mega_msipddp, "msipddp_solve", lambda *a: mega_msipddp._launch(*a))
    monkeypatch.setattr(torch.cuda, "Event", lambda **k: type(
        "Event", (), {"record": lambda self: None, "elapsed_time": lambda self, o: 1.0})())


def test_phase_17_dry_run(monkeypatch):
    """Phase 17's plumbing on the CPU at tiny sizes (B_CHECK = B_MAIN = SLEW_B
    = 16, N = 5 and 3, every solve at most 2 iterations): the per-pass
    kernels replaced by their plain versions that count a launch
    (``_plain_kernels``), the whole solves by their plain drivers
    (``_plain_whole_solves``), the plain references computed in this
    process; each check (the whole solves' longest horizons cut to 4),
    fleet, the single slew and the timings run through; every entry of
    ``att_entries`` gets its launches from a fleet that drives it, its
    errors from (a) and its timing tuple."""
    import chip_smoke
    import cddp_tpu_torch as tt
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    for name, value in (("B_CHECK", 16), ("B_MAIN", 16), ("SLEW_B", 16), ("SLEW_N", 5),
                        ("MPC_N", 3), ("QUAD_CHECK_B", 8), ("ATT_KERNEL_B", 8), ("ATT_ITERS", 2),
                        ("ATT_WHOLE_ITERS", 2), ("ATT_CHECK_ITERS", 2), ("ATT_PLAIN_ITERS", 2),
                        ("SINGLE_ITERS", 2), ("SINGLE_REPS", 1), ("TIMING_BUDGET_MS", 1.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    # The whole solves' longest horizons cut with the rest (N = 4).
    monkeypatch.setattr(rollout_ops, "WHOLE_MAX_HORIZON", {
        k: dict.fromkeys(v, 4) for k, v in rollout_ops.WHOLE_MAX_HORIZON.items()})
    _plain_kernels(monkeypatch)
    _plain_whole_solves(monkeypatch)

    class Refs:  # the plain references computed in this process
        def __init__(self, out):
            self.out = out

        def result(self, dev):
            return self.out

        def close(self):
            pass

    dev = torch.device("cpu")
    checked = chip_smoke.attitude_checks(tt, dev, "dry run",
                                         Refs(chip_smoke.attitude_plain_refs(tt, dev)))
    launches, errs, fleets, plain = chip_smoke.phase_attitude(tt, dev, "dry run", checked)
    timing = chip_smoke.time_attitude_kernels(tt, dev, fleets, plain, "dry run")
    names = {e[0] for e in chip_smoke.att_entries()}
    assert set(launches) == names and all(n >= 1 for n in launches.values())
    for model in chip_smoke.ATT_MODELS:
        assert launches[f"open_loop_rollout@{model}"] == 1
        assert launches[f"ipddp_backward@{model}"] == 2  # one a per-pass iteration
        for kernel in ("clddp_solve", "ipddp_solve", "logddp_solve"):
            if chip_smoke.whole_takes(kernel, model):
                assert launches[f"{kernel}@{model}"] == 1
    for tag in ("float64", "float32"):
        assert set(errs[tag]) == names
    assert set(timing) == names and all(len(v) == 6 for v in timing.values())


def test_phase_18_entries_name_built_launchers_and_logged_kernels():
    """Each phase-18 entry's launcher is one the kernel library builds, its
    dispatch_log name the one its kernel's wrapper logs for the spacecraft
    model (kernels 1 and 6 at its shape, with its control box's m), and the
    entries are the eight kernels of the models' path on each model but any
    whole solve the tables leave out (``whole_takes``), which then takes no
    horizon in ``rollout.WHOLE_MAX_HORIZON``, and kernel 1 on the model it
    leaves out (``riccati.LEFT_OUT_MODELS``); kernel 8 takes none of the
    four."""
    import chip_smoke
    from cddp_tpu_torch import models
    from cddp_tpu_torch.ops.kernels import ipddp_riccati, ip_rollout, mega_ipddp, riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    built = {stem for stems in chip_smoke.launchers().values() for stem in stems}
    kernels = ("riccati_backward", "forward_rollout", "clddp_solve", "open_loop_rollout",
               "ip_forward", "ipddp_backward", "ipddp_solve", "logddp_solve")
    left_out = {("clddp_solve", "sc_linear_fuel"), ("clddp_solve", "sc_landing2d"),
                ("clddp_solve", "sc_twobody"), ("ipddp_solve", "sc_linear_fuel"),
                ("ipddp_solve", "sc_landing2d"), ("ipddp_solve", "sc_twobody"),
                ("logddp_solve", "sc_nonlinear"), ("logddp_solve", "sc_landing2d"),
                ("logddp_solve", "sc_twobody"), ("riccati_backward", "sc_twobody")}
    assert {e[0] for e in chip_smoke.sc_entries()} == {
        f"{k}@{m}" for k in kernels for m in chip_smoke.SC_MODELS if (k, m) not in left_out}
    assert riccati.LEFT_OUT_MODELS == ("sc_twobody",)
    for cls, m in chip_smoke.SC_CLASSES.items():
        mdl = getattr(models, cls)()
        nx, nu, rows = chip_smoke.SC_SHAPES[m]
        assert (mdl.state_dim, mdl.control_dim) == (nx, nu)
        assert rollout_ops.model_entry(mdl).tag == "@" + m
        for kernel in ("clddp_solve", "ipddp_solve", "logddp_solve"):
            assert chip_smoke.whole_takes(kernel, m) == ((kernel, m) not in left_out)
            assert (m in rollout_ops.WHOLE_MAX_HORIZON[kernel]) == ((kernel, m) not in left_out)
        assert m in rollout_ops.ROLLOUT_MODELS
        assert ip_rollout.KERNEL_ROWS[m] == (rows,) and m not in mega_ipddp.MS_BOX_ROWS
    for name, logged, kernel, model, launcher in chip_smoke.sc_entries():
        assert launcher in built, launcher
        nx, nu, rows = chip_smoke.SC_SHAPES[model]
        if kernel == "riccati_backward":
            assert logged == riccati.dispatch_name(nx, nu)
        elif kernel == "ipddp_backward":
            assert logged == ipddp_riccati.dispatch_name(nx, nu, rows)
        else:
            assert logged == name


def test_phase_18_dry_run(monkeypatch):
    """Phase 18's plumbing on the CPU at tiny sizes (B_CHECK = B_MAIN =
    SC_LONG_B = 16, N = 5 and 3, every solve at most 2 iterations; kernels
    1, 2 and 4 checked on 64 instances, so that one instance off float64
    stays within ``check``'s TIE_SHARE): the
    per-pass kernels replaced by their plain versions that count a launch
    (``_plain_kernels``), the whole solves by their plain drivers
    (``_plain_whole_solves``), the side process's work (the plain
    references) done in this process;
    the whole solves' longest horizons cut to 4, the nonlinear model's
    kernels 3 and 7 to 2, below the MPC horizon, as at full size; each
    check, fleet and timing runs through, and every entry of
    ``sc_entries`` gets its launches from a fleet that drives it, its
    errors from (a) and its timing tuple."""
    import chip_smoke
    import cddp_tpu_torch as tt
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    for name, value in (("B_CHECK", 16), ("B_MAIN", 16), ("SC_LONG_B", 16), ("SC_LONG_N", 5),
                        ("MPC_N", 3), ("SC_KERNEL_B", 64), ("SC_ITERS", 2),
                        ("SC_WHOLE_ITERS", 2), ("TIMING_BUDGET_MS", 1.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    horizons = {k: dict.fromkeys(v, 4) for k, v in rollout_ops.WHOLE_MAX_HORIZON.items()}
    horizons["clddp_solve"]["sc_nonlinear"] = horizons["ipddp_solve"]["sc_nonlinear"] = 2
    monkeypatch.setattr(rollout_ops, "WHOLE_MAX_HORIZON", horizons)
    _plain_kernels(monkeypatch)
    _plain_whole_solves(monkeypatch)

    class Refs:  # the plain references computed in this process
        def __init__(self, out):
            self.out = out

        def result(self, dev):
            return self.out

        def close(self):
            pass

    dev = torch.device("cpu")
    checked = chip_smoke.sc_checks(tt, dev, Refs(chip_smoke.sc_plain_refs(tt, dev)))
    launches, errs, fleets, plain = chip_smoke.phase_spacecraft(tt, dev, "dry run", checked)
    timing = chip_smoke.time_sc_kernels(tt, dev, fleets, plain, "dry run")
    names = {e[0] for e in chip_smoke.sc_entries()}
    assert set(launches) == names and all(n >= 1 for n in launches.values())
    for model in chip_smoke.SC_MODELS:
        assert launches[f"open_loop_rollout@{model}"] == 1
        assert launches[f"ipddp_backward@{model}"] == 2  # one a per-pass iteration
        for kernel in ("clddp_solve", "ipddp_solve", "logddp_solve"):
            if chip_smoke.whole_takes(kernel, model):
                assert launches[f"{kernel}@{model}"] == 1
    assert ("mpc", "clddp_solve", "sc_nonlinear") in fleets
    assert fleets[("mpc", "clddp_solve", "sc_nonlinear")][0].horizon == 2
    for tag in ("float64", "float32"):
        assert set(errs[tag]) == names
    assert set(timing) == names and all(len(v) == 6 for v in timing.values())


def test_phase_19_entries_name_built_launchers_and_logged_kernels():
    """Each phase-19 entry's launcher is one the kernel library builds, its
    dispatch_log name the one its kernel's wrapper logs for the small model
    (kernels 1 and 6 at its shape, with its control box's m), and the
    entries are the nine kernels of the models' path on each model, kernel
    8 included, but any whole solve the tables leave out (``whole_takes``),
    which then takes no horizon in ``rollout.WHOLE_MAX_HORIZON``; the new
    shapes 3x1, 3x1x2 and 4x1x2 are built."""
    import chip_smoke
    from cddp_tpu_torch import models
    from cddp_tpu_torch.ops.kernels import ipddp_riccati, ip_rollout, mega_ipddp, riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    built = {stem for stems in chip_smoke.launchers().values() for stem in stems}
    assert {"cddp_riccati_backward_3x1", "cddp_ipddp_backward_3x1x2",
            "cddp_ipddp_backward_4x1x2"} <= built
    kernels = ("riccati_backward", "forward_rollout", "clddp_solve", "open_loop_rollout",
               "ip_forward", "ipddp_backward", "ipddp_solve", "msipddp_solve", "logddp_solve")
    whole = tuple(chip_smoke.SMALL_KERNELS.values())
    left_out = {(k, m) for k in whole for m in chip_smoke.SMALL_MODELS
                if not chip_smoke.whole_takes(k, m)}
    assert {e[0] for e in chip_smoke.small_entries()} == {
        f"{k}@{m}" for k in kernels for m in chip_smoke.SMALL_MODELS if (k, m) not in left_out}
    assert set(whole) == {"clddp_solve", "ipddp_solve", "msipddp_solve", "logddp_solve"}
    for cls, m in chip_smoke.SMALL_CLASSES.items():
        mdl = getattr(models, cls)()
        nx, nu, rows = chip_smoke.SMALL_SHAPES[m]
        assert (mdl.state_dim, mdl.control_dim) == (nx, nu)
        assert rollout_ops.model_entry(mdl).tag == "@" + m
        for kernel in whole:
            assert (m in rollout_ops.WHOLE_MAX_HORIZON[kernel]) == ((kernel, m) not in left_out)
        assert m in rollout_ops.ROLLOUT_MODELS and m in rollout_ops.SMALL_MODELS
        assert ip_rollout.KERNEL_ROWS[m] == (rows,)
        assert mega_ipddp.MS_BOX_ROWS.get(m, (rows,)) == (rows,)
    for name, logged, kernel, model, launcher in chip_smoke.small_entries():
        assert launcher in built, launcher
        nx, nu, rows = chip_smoke.SMALL_SHAPES[model]
        if kernel == "riccati_backward":
            assert logged == riccati.dispatch_name(nx, nu)
        elif kernel == "ipddp_backward":
            assert logged == ipddp_riccati.dispatch_name(nx, nu, rows)
        else:
            assert logged == name


def test_phase_19_dry_run(monkeypatch):
    """Phase 19's plumbing on the CPU at tiny sizes (B_CHECK = B_MAIN =
    SMALL_LONG_B = 16, N = 5 and 3, every solve at most 2 iterations;
    kernels 1, 2 and 4 checked on 64 instances, so that one instance off
    float64 stays within ``check``'s TIE_SHARE): the per-pass kernels
    replaced by their plain versions that count a launch
    (``_plain_kernels``), the whole solves 3, 7, 8 and 9 by their plain
    drivers (``_plain_whole_solves``), the side process's work (the plain
    references) done in this process; the whole solves' longest horizons
    cut to 4 (DreyfusRocket's CLDDP and IPDDP to 6, so that its N = 5 fleets
    stay whole and the per-pass engine drives its kernels 1, 2, 5 and 6,
    as at full size), kernel 8's on the bicycle to 2, below the MPC
    horizon, where it then runs on the fleet at N = 2 (at full size every
    gate takes the MPC horizon); each check, fleet and timing runs through,
    and every entry of
    ``small_entries`` gets its launches from a fleet that drives it, its
    errors from (a) and its timing tuple."""
    import chip_smoke
    import cddp_tpu_torch as tt
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    for name, value in (("B_CHECK", 16), ("B_MAIN", 16), ("SMALL_LONG_B", 16),
                        ("SMALL_LONG_N", 5), ("MPC_N", 3), ("SMALL_KERNEL_B", 64),
                        ("SMALL_ITERS", 2), ("SMALL_WHOLE_ITERS", 2), ("TIMING_BUDGET_MS", 1.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    horizons = {k: dict.fromkeys(v, 4) for k, v in rollout_ops.WHOLE_MAX_HORIZON.items()}
    horizons["clddp_solve"]["dreyfus_rocket"] = horizons["ipddp_solve"]["dreyfus_rocket"] = 6
    horizons["msipddp_solve"]["bicycle"] = 2
    monkeypatch.setattr(rollout_ops, "WHOLE_MAX_HORIZON", horizons)
    _plain_kernels(monkeypatch)
    _plain_whole_solves(monkeypatch)

    class Refs:  # the plain references computed in this process
        def __init__(self, out):
            self.out = out

        def result(self, dev):
            return self.out

        def close(self):
            pass

    dev = torch.device("cpu")
    lane_errs = chip_smoke.small_lane_checks(tt, dev, chip_smoke.SMALL_MODELS)
    checked = chip_smoke.small_checks(tt, dev, Refs(chip_smoke.small_plain_refs(tt, dev)))
    launches, errs, fleets, plain = chip_smoke.phase_small(tt, dev, "dry run", checked,
                                                           lane_errs)
    timing = chip_smoke.time_small_kernels(tt, dev, fleets, plain, "dry run")
    names = {e[0] for e in chip_smoke.small_entries()}
    assert set(launches) == names and all(n >= 1 for n in launches.values())
    for model in chip_smoke.SMALL_MODELS:
        assert launches[f"ipddp_backward@{model}"] == 2  # one a per-pass iteration
        for kernel in chip_smoke.SMALL_KERNELS.values():
            if chip_smoke.whole_takes(kernel, model):
                # The MPC fleet, and DreyfusRocket's long fleets, which stay whole.
                extra = model == "dreyfus_rocket" and kernel in ("clddp_solve", "ipddp_solve")
                assert launches[f"{kernel}@{model}"] == 1 + extra
    assert fleets[("mpc", "msipddp_solve", "bicycle")][0].horizon == 2
    assert ("mpc", "msipddp_solve", "acrobot") not in fleets  # ROADMAP C.14
    for tag in ("float64", "float32"):
        assert set(errs[tag]) == names
    assert set(timing) == names and all(len(v) == 6 for v in timing.values())


@pytest.mark.parametrize("model", ["sc_nonlinear", "sc_landing2d", "mrp_attitude"])
def test_count_ops_steps_is_the_full_count(model):
    """The op count from two- and three-step cuts (``count_ops_steps``, what
    the long-horizon timings take) equals the full count for each per-pass
    kernel's plain version at N = 24, the quadrotor's tracking forward
    trial included."""
    import chip_smoke
    import cddp_tpu_torch as tt
    from cddp_tpu_torch.ops.kernels import ip_rollout, riccati
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    dev, gen = torch.device("cpu"), torch.Generator().manual_seed(0)
    if model.startswith("sc_"):
        prob = chip_smoke.sc_problem(tt, torch.float64, dev, model, 24)
        X, U, back, alpha = chip_smoke.sc_stage(prob, 2, gen)
        opts = chip_smoke.sc_options(tt, 3)
    else:
        prob = chip_smoke.attitude_problem(tt, torch.float64, dev, model, 24)
        X, U, back, alpha = chip_smoke.stage_inputs(prob, 2, gen)
        opts = chip_smoke.attitude_options(tt, 3)
    consts = rollout_ops.lane_consts(prob)
    k, K = riccati.riccati_backward_plain(*back)[:2]
    p, ol, back6, fwd5 = chip_smoke.stage_ip_inputs(tt, prob, 2, gen, opts, iterations=1)
    fc = chip_smoke.forward_consts(p, opts, False)
    runs = [(riccati.riccati_backward_plain, back),
            (lambda *a: rollout_ops.forward_rollout_plain(consts, *a),
             (X[:, :-1], U, k, K, X[:, 0], alpha)),
            (lambda *a: ip_rollout.open_loop_rollout_plain(p.model, *a, p.timestep), ol),
            (lambda *a: ip_rollout.ip_forward_plain(fc, *a), fwd5),
            (ric.ipddp_backward_plain, chip_smoke.per_pass_layout(back6))]
    if model == "mrp_attitude":
        quad = chip_smoke.quad_problem(tt, torch.float64, dev, horizon=24, tracking=True)
        qp, _, _, qfwd = chip_smoke.quad_ip_stage(tt, quad, 2, gen, chip_smoke.quad_options(tt, 3))
        qfc = chip_smoke.forward_consts(qp, chip_smoke.quad_options(tt, 3), False)
        runs.append((lambda *a: ip_rollout.ip_forward_plain(qfc, *a), qfwd))
    for fn, args in runs:
        args = chip_smoke.one(args)
        assert chip_smoke.count_ops_steps(fn, *args) == chip_smoke.count_ops(fn, *args) > 0


def test_side_part_process_failure_is_raised():
    """A part of a side process that runs several (``SIDE_PARTS``: phases
    16, 18, 19 and 20's plain references) is raised as the process's failure
    when the process ends without saving it (here it needs the card)."""
    import chip_smoke

    refs = chip_smoke.Side("quadrotor+spacecraft+small+mpcc")
    try:
        for part in chip_smoke.SIDE_PARTS["quadrotor+spacecraft+small+mpcc"]:
            with pytest.raises(AssertionError, match="exited with status"):
                refs.part(part).result(torch.device("cpu"))
    finally:
        refs.close()
    assert not Path(refs._dir.name).exists()


def test_phase_20_dry_run(monkeypatch):
    """Phase 20's plumbing on the CPU at tiny sizes (B_CHECK = 16, the fleets
    at 8 and 16 cars, 2 iterations, windows of 16 coefficients), kernels 4,
    5 and 6 replaced by their plain versions that count a launch and kernel
    7 by its plain driver (``_plain_kernels``, ``_plain_whole_solves``): the
    checks, the fleets on every engine with their launch counts, the golden
    tick (float64, 15 iterations from the JAX package's snapshot) and the
    timings run through, and every entry of ``MPCC_ENTRIES`` gets its
    launches, errors, timing tuple and record."""
    import types

    import chip_smoke
    import cddp_tpu_torch as tt

    for name, value in (("B_CHECK", 16), ("MPCC_B", 8), ("MPCC_BIG_B", 16), ("MPCC_ITERS", 2),
                        ("MPCC_WARM_ITERS", 1), ("MPCC_WARM_TICKS", 1), ("MPCC_COEFFS", 16),
                        ("TIMING_BUDGET_MS", 1.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    _plain_kernels(monkeypatch)
    _plain_whole_solves(monkeypatch)
    from cddp_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "kernel_attributes", lambda name, header=None: dict.fromkeys(
        build.ATTRIBUTES, 0))
    dev = torch.device("cpu")
    refs = chip_smoke.mpcc_plain_refs(tt, dev)  # the side process's work, here
    launches, errs, fleet_ms, captured = chip_smoke.phase_mpcc(
        tt, dev, "dry run", types.SimpleNamespace(result=lambda dev: refs))
    m = chip_smoke.mpcc_lib()
    timing = chip_smoke.time_mpcc_kernels(tt, dev, m, captured, fleet_ms, "dry run")
    record = chip_smoke.mpcc_record(tt, dev, m, launches, errs, timing)
    names = [e[0] for e in chip_smoke.MPCC_ENTRIES]
    assert [r["name"] for r in record] == names
    assert all(launches[n] >= 1 for n in names)
    for tag in ("float64", "float32"):
        assert set(errs[tag]) == set(names)
    assert set(timing) == set(names)
