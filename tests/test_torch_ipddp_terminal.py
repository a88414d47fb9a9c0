"""IPDDP with terminal constraints through the port's entry points on CPU
against the JAX package's vmapped ``_drive``, seeded as
tests/test_mega_ipddp.py::_run_both seeds it (float64, rtol = atol = 1e-8 on
X, U, k, K, Y, S, Lambda, cost, inf_pr, inf_du, inf_comp, mu, reg, alpha_pr
and the terminal state S_T, Y_T, Lambda_T_eq; statuses and iteration counts
exact), on the JAX package's four terminal cases
(tests/test_mega_ipddp.py:611-735): a binding linear terminal inequality at
4 and 8 iterations, an inactive one, the terminal equality x_N = target at 4
and 8 iterations, and the equality with an inequality. Each runs on both of
the port's engines: the whole-solve dispatch (on CPU tensors, the plain
driver kernel 7 is held to) and the per-pass driver (``solve_engine="xla"``,
kernels 5 and 6's plain versions). Also kernel 7's eligibility for each
terminal instantiation, the plain-driver route for a layout that has none,
and the terminal maps of an unbatched solve."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.constraints.stack import PathStacker as JPathStacker
from cddp_tpu.constraints.stack import TerminalStacker as JTerminalStacker
from cddp_tpu.solvers import ipddp as jipddp
from cddp_tpu_torch.interop import problem_from_arrays, solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log, mega_ipddp, mega_logddp, mega_msipddp
from cddp_tpu_torch.parallel.batch import batched_solve
from test_mega_ipddp import (VERDICT_SEEDS, _seed_batch, _unicycle_box,
                             _unicycle_terminal_eq, _unicycle_terminal_ineq)
from test_torch_ipddp import FIELDS, port_options

torch.set_num_threads(1)

TERMINAL_FIELDS = FIELDS + ("S_T", "Y_T", "Lambda_T_eq")
BOXES = {"ControlConstraint": "control", "StateConstraint": "state"}


def port_terminal_problem(jp, dtype=torch.float64):
    """The port's copy of a JAX IPDDP box problem with terminal
    constraints, through ``interop.problem_from_arrays``."""
    o = jp.objective
    boxes = {name: (BOXES[type(c).__name__], np.asarray(c.lower), np.asarray(c.upper),
                    c.scale_factor) for name, c in jp.constraints.items()}
    term = {}
    for name, c in jp.terminal_constraints.items():
        kind = type(c).__name__
        fields = ({"target_state": np.asarray(c.target_state)}
                  if kind == "TerminalEqualityConstraint"
                  else {"A": np.asarray(c.A), "b": np.asarray(c.b)})
        term[name] = (kind, fields)
    return problem_from_arrays(
        type(jp.model).__name__, [], o.Q, o.R, o.Qf, o.reference_state, None, None,
        jp.x0, jp.horizon, jp.timestep, jp.model.integration_type,
        device="cpu", dtype=dtype, boxes=boxes, terminal_constraints=term)


@functools.lru_cache(maxsize=None)
def _jax_fleet(jopts):
    """The jitted JAX vmapped ``_drive`` for one option set, returning the
    terminal state too; the problem is an argument."""

    def one(p, x, Xi, Ui, Yi, Si, Li, mu0i, STi, YTi, LTEi):
        p = p.replace(x0=x)
        stk, tstk = JPathStacker(p), JTerminalStacker(p)
        N = p.horizon
        sol, st = jipddp._drive(
            p, jopts, Xi, Ui, Yi, Si, jipddp._eval_path(p, stk, Xi, Ui),
            tstk.ineq_evaluate(Xi[-1]), STi, YTi, Li, LTEi, mu0i,
            jnp.zeros((N, 2)), jnp.zeros((N, 2, 3)))
        return dict(zip(TERMINAL_FIELDS, (
            sol.state_trajectory, sol.control_trajectory, st.k_u, st.K_u, st.Y,
            st.S, st.Lambda, sol.final_objective, sol.inf_pr, sol.inf_du,
            sol.inf_comp, sol.barrier_mu, sol.final_regularization,
            sol.final_step_length, sol.iterations_completed, sol.status_code,
            st.S_T, st.Y_T, st.Lambda_T_eq)))

    return jax.jit(jax.vmap(one, in_axes=(None,) + (0,) * 10))


def jax_drive(jp, jopts, x0):
    return _jax_fleet(jopts)(jp, x0, *_seed_batch(jp, jopts, x0))


def assert_match(got, want, tol=1e-8):
    for name in TERMINAL_FIELDS:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name in ("iterations", "status"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def _eq_and_ineq(horizon):
    return _unicycle_terminal_eq(horizon=horizon).add_terminal_constraint(
        "TerminalInequality", ct.terminal_inequality_constraint(
            jnp.asarray([[0.0, 0.0, 1.0]]), jnp.asarray([2.0])))


def _x0(seed, scale):
    return jnp.asarray(np.random.default_rng(seed).uniform(-scale, scale, size=(4, 3)))


# id -> (problem, JAX options, x0, kernel 7's launcher suffix for it)
CASES = {
    "binding_ineq_4": lambda: (_unicycle_terminal_ineq(horizon=20, binding=True), 4,
                               jnp.asarray(VERDICT_SEEDS), "m4_ti2"),
    "binding_ineq_8": lambda: (_unicycle_terminal_ineq(horizon=20, binding=True), 8,
                               jnp.asarray(VERDICT_SEEDS), "m4_ti2"),
    "inactive_ineq": lambda: (_unicycle_terminal_ineq(horizon=12, binding=False), 6,
                              _x0(7, 0.4), "m4_ti2"),
    "equality_4": lambda: (_unicycle_terminal_eq(horizon=20), 4,
                           jnp.asarray(VERDICT_SEEDS), "m4_te3"),
    "equality_8": lambda: (_unicycle_terminal_eq(horizon=20), 8,
                           jnp.asarray(VERDICT_SEEDS), "m4_te3"),
    "equality_and_ineq": lambda: (_eq_and_ineq(12), 6, _x0(11, 0.3), "m4_te3_ti1"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_terminal_fleet_matches_jax_driver(case):
    jp, iters, x0, variant = CASES[case]()
    jopts = ct.CDDPOptions(max_iterations=iters, tolerance=1e-4)
    want = jax_drive(jp, jopts, x0)
    p, opts = port_terminal_problem(jp), port_options(jopts)
    assert mega_ipddp.solve_variant(p) == variant and mega_ipddp.mega_eligible(p, opts)
    for engine in ("auto", "xla"):
        dispatch_log.reset()
        got = solution_to_numpy(batched_solve(p, torch.as_tensor(np.asarray(x0)), "IPDDP",
                                              opts.replace(solve_engine=engine)))
        assert not dispatch_log.launches  # CPU tensors: the plain versions
        assert_match(got, want)
    assert got["iterations"].max() >= 1


def _with_terminal(jp, kind):
    if kind == "ineq1":
        return jp.add_terminal_constraint("TerminalInequality", ct.terminal_inequality_constraint(
            jnp.asarray([[1.0, 0.0, 0.0]]), jnp.asarray([1.9])))
    if kind == "ineq3":
        return jp.add_terminal_constraint("TerminalInequality", ct.terminal_inequality_constraint(
            jnp.eye(3), jnp.full((3,), 1.9)))
    return jp.add_terminal_constraint("TerminalEquality", ct.terminal_equality_constraint(
        jnp.asarray([1.5, 1.0, np.pi / 4])))


@pytest.mark.parametrize("kind,state_box,variant", [
    ("ineq1", False, "m4_ti1"),
    ("eq", False, "m4_te3"),
    # A layout kernel 7 has no terminal instantiation of: the plain driver.
    ("ineq3", False, None),
    ("eq", True, None),
])
def test_kernel_7_eligibility_and_route(kind, state_box, variant):
    jp = _with_terminal(_unicycle_box(horizon=6, state_box=state_box), kind)
    p = port_terminal_problem(jp)
    opts = tt.CDDPOptions(max_iterations=2)
    assert mega_ipddp.solve_variant(p) == variant
    assert mega_ipddp.mega_eligible(p, opts) == (variant is not None)
    # Kernels 8 and 9 decline terminal constraints, as in JAX.
    assert not mega_logddp.mega_eligible(p, opts)
    assert not mega_msipddp.mega_eligible(p, opts)
    if variant is None:
        with pytest.raises(ValueError, match="solve_engine='fused'"):
            tt.solve(p, "IPDDP", opts.replace(solve_engine="fused"))
    x0 = torch.as_tensor(np.asarray(VERDICT_SEEDS[:2]))
    got = solution_to_numpy(batched_solve(p, x0, "IPDDP", opts))
    want = solution_to_numpy(batched_solve(p, x0, "IPDDP", opts.replace(solve_engine="xla")))
    for name in TERMINAL_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_unbatched_terminal_maps_match_jax_solve():
    jp = _eq_and_ineq(8).replace(x0=jnp.asarray([0.3, -0.2, 0.1]))
    jopts = ct.CDDPOptions(max_iterations=4, tolerance=1e-4)
    sol = tt.solve(port_terminal_problem(jp), "IPDDP", port_options(jopts))
    jsol = ct.solve(jp, "IPDDP", jopts)
    assert sol.state_trajectory.shape == (9, 3) and sol.status_code.shape == ()
    assert sorted(sol.terminal_duals) == sorted(jsol.terminal_duals) == [
        "TerminalEquality", "TerminalInequality"]
    assert sorted(sol.terminal_slacks) == ["TerminalInequality"]
    for name, want in jsol.terminal_duals.items():
        np.testing.assert_allclose(sol.terminal_duals[name].numpy(), np.asarray(want),
                                   rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(sol.state_trajectory.numpy(),
                               np.asarray(jsol.state_trajectory), rtol=1e-8, atol=1e-8)
    assert int(sol.iterations_completed) == int(jsol.iterations_completed)
