"""The IPDDP box fleet: IPDDP through the port's public entry points on CPU
against the JAX package's vmapped ``_drive``, seeded by ``_initialize`` as
tests/test_mega_ipddp.py::_run_both seeds it (float64, rtol = atol = 1e-8
on X, U, k, K, Y, S, Lambda, cost, inf_pr, inf_du, inf_comp, mu, reg and
alpha_pr; statuses and iteration counts exact). Both engines run: the
whole-solve dispatch (on CPU tensors, the plain driver the kernel is held
to) and the per-pass driver (``solve_engine="xla"``). Also the filter, the
constraint stack, ``ftb_ok``, the problem and options carried across, and
the options the port refuses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.constraints.stack import PathStacker as JPathStacker
from cddp_tpu.constraints.stack import TerminalStacker as JTerminalStacker
from cddp_tpu.options import BarrierStrategy as JBarrierStrategy
from cddp_tpu.solvers import base as jbase
from cddp_tpu.solvers import filter as jflt
from cddp_tpu.solvers import ipddp as jipddp
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.interop import options_from_dict, problem_from_arrays, solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log, mega_ipddp
from cddp_tpu_torch.parallel.batch import batched_solve
from cddp_tpu_torch.solvers import base, ipddp
from cddp_tpu_torch.solvers import filter as flt
from test_mega_ipddp import VERDICT_SEEDS, _seed_batch, _unicycle_box

torch.set_num_threads(1)

FIELDS = ("X", "U", "k", "K", "Y", "S", "Lambda", "cost", "inf_pr", "inf_du",
          "inf_comp", "mu", "reg", "alpha_pr", "iterations", "status")


def port_ip_problem(jp, dtype=torch.float64):
    """The port's copy of a JAX IPDDP box problem, through numpy arrays."""
    o = jp.objective
    boxes = {name: ("control" if type(c).__name__ == "ControlConstraint" else "state",
                    np.asarray(c.lower), np.asarray(c.upper), c.scale_factor)
             for name, c in jp.constraints.items()}
    return problem_from_arrays(
        type(jp.model).__name__, [], o.Q, o.R, o.Qf, o.reference_state, None, None,
        jp.x0, jp.horizon, jp.timestep, jp.model.integration_type,
        device="cpu", dtype=dtype, boxes=boxes)


def port_options(jopts):
    return options_from_dict(dataclasses.asdict(jopts))


def jax_drive(jp, jopts, x0):
    """The JAX vmapped ``_drive`` from ``_initialize`` seeds."""
    Xb, Ub, Yb, Sb, Lb, mu0b, STb, YTb, LTEb = _seed_batch(jp, jopts, x0)
    N = jp.horizon

    def one(x, Xi, Ui, Yi, Si, Li, mu0i, STi, YTi, LTEi):
        p = jp.replace(x0=x)
        stk, tstk = JPathStacker(p), JTerminalStacker(p)
        sol, st = jipddp._drive(
            p, jopts, Xi, Ui, Yi, Si, jipddp._eval_path(p, stk, Xi, Ui),
            tstk.ineq_evaluate(Xi[-1]), STi, YTi, Li, LTEi, mu0i,
            jnp.zeros((N, 2)), jnp.zeros((N, 2, 3)))
        return dict(zip(FIELDS, (
            sol.state_trajectory, sol.control_trajectory, st.k_u, st.K_u, st.Y,
            st.S, st.Lambda, sol.final_objective, sol.inf_pr, sol.inf_du,
            sol.inf_comp, sol.barrier_mu, sol.final_regularization,
            sol.final_step_length, sol.iterations_completed, sol.status_code)))

    return jax.jit(jax.vmap(one))(x0, Xb, Ub, Yb, Sb, Lb, mu0b, STb, YTb, LTEb)


def assert_match(got, want, tol=1e-8):
    for name in FIELDS:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name in ("iterations", "status"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def _barrier(jopts, strategy):
    bar = dataclasses.replace(jopts.ipddp.barrier, strategy=strategy)
    return jopts.replace(ipddp=dataclasses.replace(jopts.ipddp, barrier=bar))


def _x0(B, seed, scale):
    return jnp.asarray(np.random.default_rng(seed).uniform(-scale, scale, size=(B, 3)))


# id -> (problem, JAX options, x0, the statuses the case is there for)
CASES = {
    "verdict_4": lambda: (_unicycle_box(horizon=20),
                          ct.CDDPOptions(max_iterations=4, tolerance=1e-4),
                          jnp.asarray(VERDICT_SEEDS), None),
    "verdict_8": lambda: (_unicycle_box(horizon=20),
                          ct.CDDPOptions(max_iterations=8, tolerance=1e-4),
                          jnp.asarray(VERDICT_SEEDS), None),
    "monotonic": lambda: (_unicycle_box(horizon=12),
                          _barrier(ct.CDDPOptions(max_iterations=8, tolerance=1e-4),
                                   JBarrierStrategy.MONOTONIC),
                          _x0(4, 2, 0.5), None),
    "ipopt": lambda: (_unicycle_box(horizon=10),
                      _barrier(ct.CDDPOptions(max_iterations=6, tolerance=1e-4),
                               JBarrierStrategy.IPOPT),
                      _x0(3, 3, 0.4), None),
    "control_and_state_box": lambda: (
        _unicycle_box(horizon=10, state_box=True),
        ct.CDDPOptions(max_iterations=7, tolerance=1e-4), _x0(4, 5, 0.4), None),
    # An indefinite R fails the condensed Quu's PD check at every reachable
    # regularization: the backward retry loop ends at status 3.
    "regularization_limit": lambda: (
        (lambda p: p.replace(objective=p.objective.replace(
            R=jnp.asarray(-np.eye(2) * 5.0))))(_unicycle_box(horizon=8)),
        ct.CDDPOptions(max_iterations=4, regularization=ct.RegularizationOptions(
            initial_value=1e-6, update_factor=10.0, max_value=1e-2)),
        jnp.asarray(np.linspace(-0.2, 0.2, 6).reshape(2, 3)), {3}),
    # The mild reachable goal of test_mega_ipddp.py::test_run_to_convergence,
    # on its first two verdict seeds.
    "to_convergence": lambda: (_unicycle_box(horizon=20, goal=(0.6, 0.4, 0.5)),
                               ct.CDDPOptions(max_iterations=60, tolerance=1e-5),
                               jnp.asarray(VERDICT_SEEDS[:2]), {1, 2}),
    "theta_l2": lambda: (_unicycle_box(horizon=10),
                         (lambda o: o.replace(ipddp=dataclasses.replace(
                             o.ipddp, theta_norm="l2")))(
                             ct.CDDPOptions(max_iterations=6, tolerance=1e-4)),
                         _x0(3, 9, 0.4), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_matches_jax_driver(case):
    jp, jopts, x0, statuses = CASES[case]()
    want = jax_drive(jp, jopts, x0)
    p, opts = port_ip_problem(jp), port_options(jopts)
    for engine in ("auto", "xla"):
        dispatch_log.reset()
        got = solution_to_numpy(batched_solve(p, torch.as_tensor(np.asarray(x0)), "IPDDP",
                                              opts.replace(solve_engine=engine)))
        assert not dispatch_log.launches  # CPU tensors: the plain versions
        assert_match(got, want)
    assert got["iterations"].max() >= 1
    if statuses is not None:
        assert set(got["status"].tolist()) <= statuses


def test_parallel_line_search_matches_jax_driver():
    # enable_parallel keeps the per-pass driver (the whole-solve kernel takes
    # the sequential ladder only): the best merit among the successes.
    jp = _unicycle_box(horizon=12)
    jopts = ct.CDDPOptions(max_iterations=6, tolerance=1e-4, enable_parallel=True)
    x0 = _x0(4, 13, 0.5)
    opts = port_options(jopts)
    assert not mega_ipddp.mega_eligible(port_ip_problem(jp), opts)
    got = solution_to_numpy(batched_solve(port_ip_problem(jp),
                                          torch.as_tensor(np.asarray(x0)), "IPDDP", opts))
    assert_match(got, jax_drive(jp, jopts, x0))


def test_unbatched_solve_and_solution_maps():
    jp = _unicycle_box(horizon=8, state_box=True).replace(
        x0=jnp.asarray([0.3, -0.2, 0.1]))
    jopts = ct.CDDPOptions(max_iterations=5, tolerance=1e-4)
    sol = tt.solve(port_ip_problem(jp), "IPDDP", port_options(jopts))
    jsol = ct.solve(jp, "IPDDP", jopts)
    assert sol.state_trajectory.shape == (9, 3) and sol.status_code.shape == ()
    assert sorted(sol.dual_trajectories) == ["ControlConstraint", "StateConstraint"]
    for name in ("ControlConstraint", "StateConstraint"):
        for got, want in ((sol.dual_trajectories, jsol.dual_trajectories),
                          (sol.slack_trajectories, jsol.slack_trajectories)):
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                       rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(sol.costate_trajectory.numpy(),
                               np.asarray(jsol.costate_trajectory), rtol=1e-8, atol=1e-8)
    assert int(sol.iterations_completed) == int(jsol.iterations_completed)
    assert sol.terminal_duals is None and sol.solver_name == "IPDDP"


def test_slack_soc_matches_jax_driver():
    # Explicit slack_soc=True traces the re-closure in the forward pass
    # (the forward kernel's plain version here) and the SOC drop on a failed
    # line search.
    jp = _unicycle_box(horizon=10)
    jopts = ct.CDDPOptions(max_iterations=6, tolerance=1e-4)
    jopts = jopts.replace(ipddp=dataclasses.replace(jopts.ipddp, slack_soc=True))
    x0 = _x0(3, 21, 0.4)
    got = solution_to_numpy(batched_solve(port_ip_problem(jp),
                                          torch.as_tensor(np.asarray(x0)), "IPDDP",
                                          port_options(jopts)))
    assert_match(got, jax_drive(jp, jopts, x0))


def test_dispatch_and_unported_options():
    p = port_ip_problem(_unicycle_box(horizon=6))
    opts = tt.CDDPOptions(max_iterations=2)
    assert mega_ipddp.mega_eligible(p, opts)
    for o in (opts.replace(solve_engine="xla"), opts.replace(backward_engine="scan"),
              opts.replace(backward_engine="fused"), opts.replace(enable_parallel=True),
              opts.replace(ipddp=tt.IPDDPOptions(slack_soc=True)),
              opts.replace(ipddp=tt.IPDDPOptions(max_filter_size=7))):
        assert not mega_ipddp.mega_eligible(p, o)
    with pytest.raises(ValueError, match="solve_engine='fused'"):
        tt.solve(p, "IPDDP", opts.replace(solve_engine="fused", enable_parallel=True))
    for o, match in (
        (opts.replace(use_ilqr=False), "full DDP"),
        (opts.replace(ipddp=tt.IPDDPOptions(lqr_backend="parallel")), "parallel"),
        (opts.replace(ipddp=tt.IPDDPOptions(check_state_stationarity=True)),
         "stationarity"),
        (opts.replace(verbose=True), "verbose"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            tt.solve(p, "IPDDP", o)
    with pytest.raises(ValueError, match="forward_engine"):
        tt.solve(p, "IPDDP", opts.replace(ipddp=tt.IPDDPOptions(forward_engine="pallas")))
    with pytest.raises(TypeError, match="terminal constraint 'goal' has unsupported type"):
        tt.solve(p.add_terminal_constraint("goal", object()), "IPDDP", opts)
    # Without path constraints the plain driver solves (the regime of
    # tests/test_torch_ipddp_unconstrained.py); no whole-solve kernel takes it.
    free = p.replace(constraints={})
    assert not mega_ipddp.mega_eligible(free, opts)
    sol = tt.solve(free, "IPDDP", opts)
    assert sol.dual_trajectories is None and int(sol.iterations_completed) >= 1


def test_options_and_problem_carried_across():
    jopts = _barrier(ct.CDDPOptions(max_iterations=7, tolerance=3e-5),
                     JBarrierStrategy.IPOPT)
    jopts = jopts.replace(ipddp=dataclasses.replace(jopts.ipddp, theta_norm="l2",
                                                    max_filter_size=4))
    opts = port_options(jopts)
    assert opts.ipddp.barrier.strategy is tt.BarrierStrategy.IPOPT
    assert (opts.max_iterations, opts.tolerance, opts.ipddp.theta_norm,
            opts.ipddp.max_filter_size) == (7, 3e-5, "l2", 4)
    jp = _unicycle_box(horizon=5, state_box=True)
    jp = jp.add_constraint("ControlConstraint", ct.control_constraint(
        jnp.asarray([-1.0, -2.0]), jnp.asarray([1.5, 2.5]), scale_factor=2.0))
    p = port_ip_problem(jp)
    stk, jstk = PathStacker(p), JPathStacker(jp)
    assert stk.names == jstk.names and stk.dims == jstk.dims
    assert stk.total_dim == 10 and not stk.has_curved
    rng = np.random.default_rng(4)
    x, u = rng.normal(size=(6, 3)) * 3, rng.normal(size=(6, 2)) * 3
    got = stk.evaluate_shifted(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    want = np.stack([np.asarray(jstk.evaluate_shifted(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(x, u)])
    np.testing.assert_array_equal(got, want)
    # Per point, as broadcasts of one copy (the box stack's constant rows).
    gx, gu = stk.jacobians(torch.as_tensor(x), torch.as_tensor(u))
    assert gx.stride(0) == 0 and gu.stride(0) == 0
    for i in range(len(x)):
        jgx, jgu = jstk.jacobians(jnp.asarray(x[i]), jnp.asarray(u[i]))
        np.testing.assert_array_equal(gx[i].numpy(), np.asarray(jgx))
        np.testing.assert_array_equal(gu[i].numpy(), np.asarray(jgu))
    split = stk.split(torch.as_tensor(got))
    for name, block in jstk.split(jnp.asarray(want)).items():
        np.testing.assert_array_equal(split[name].numpy(), np.asarray(block))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ftb_ok_matches_jax(dtype):
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    eps = float(np.finfo({torch.float64: np.float64, torch.float32: np.float32}[dtype]).eps)
    rng = np.random.default_rng(6)
    v_old = rng.uniform(1e-3, 2.0, size=64)
    tau = 0.99
    bound = (1.0 - tau) * v_old
    # On the bound, within the slop either way, far inside, and negative.
    v_new = np.concatenate([bound[:16], bound[16:32] * (1 - 8 * eps),
                            bound[32:48] * (1 - 64 * eps), -bound[48:]])
    got = base.ftb_ok(torch.as_tensor(v_new, dtype=dtype),
                      torch.as_tensor(v_old, dtype=dtype),
                      torch.tensor(tau, dtype=dtype)).numpy()
    want = np.asarray(jbase.ftb_ok(jnp.asarray(v_new, jdt), jnp.asarray(v_old, jdt),
                                   jnp.asarray(tau, jdt)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_filter_matches_jax():
    cap = 7
    rng = np.random.default_rng(8)
    jf = [jflt.empty_filter(cap, jnp.float64) for _ in range(4)]
    f = flt.empty_filter(4, cap, torch.float64, "cpu")
    for step in range(40):
        cand = rng.integers(0, 6, size=(4, 2)).astype(float)  # ties on purpose
        got, acc = flt.accept_entry(f, torch.as_tensor(cand[:, 0]),
                                    torch.as_tensor(cand[:, 1]))
        outs = [jflt.accept_entry(j, c[0], c[1]) for j, c in zip(jf, cand)]
        np.testing.assert_array_equal(acc.numpy(), [bool(o[1]) for o in outs])
        jf = [o[0] for o in outs]
        if step % 3 == 2:
            got = flt.prune_to_best(got)
            jf = [jflt.prune_to_best(j) for j in jf]
        f = got
        for i, j in enumerate(jf):
            np.testing.assert_array_equal(f.valid[i].numpy(), np.asarray(j.valid))
            np.testing.assert_array_equal(f.merit[i].numpy(), np.asarray(j.merit))
            np.testing.assert_array_equal(f.violation[i].numpy(), np.asarray(j.violation))
        mf, cv, ne = flt.back(f)
        for i, j in enumerate(jf):
            want = jflt.back(j)
            assert (float(mf[i]), float(cv[i]), bool(ne[i])) == (
                float(want[0]), float(want[1]), bool(want[2]))
    assert int(flt.size(flt.clear(f)).sum()) == 0
