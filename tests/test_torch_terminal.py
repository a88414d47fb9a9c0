"""Terminal constraints in the port (``constraints/terminal.py``,
``constraints/stack.py::TerminalStacker``, ``Problem.add_terminal_constraint``)
against the JAX package's on CPU: the two types' values, Jacobians,
Hessians, bounds and violations and the stacker's layout at 1e-12; the
builders' and stacker's errors; and CLDDP, LogDDP and MSIPDDP on a problem
with terminal constraints, which the JAX drivers never read (float64,
1e-8; statuses and iteration counts exact), with kernels 8 and 9 declining
such a problem and MSIPDDP's eligibility raising the stacker's TypeError
as the JAX package's does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.constraints.stack import TerminalStacker as JTerminalStacker
from cddp_tpu_torch.constraints.stack import TerminalStacker
from cddp_tpu_torch.interop import solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log, mega_clddp, mega_logddp, mega_msipddp
from test_mega_ipddp import _unicycle_box
from test_torch_ipddp import port_options
from test_torch_ipddp_terminal import port_terminal_problem

torch.set_num_threads(1)

RNG = np.random.default_rng(3)
A_T = RNG.normal(size=(2, 3))
B_T = RNG.normal(size=2)
TARGET = np.array([1.5, 1.0, np.pi / 4])


def _pairs():
    """(JAX, port) pairs of each terminal type."""
    kw = dict(device="cpu", dtype=torch.float64)
    return [
        (ct.terminal_inequality_constraint(jnp.asarray(A_T), jnp.asarray(B_T)),
         tt.terminal_inequality_constraint(A_T, B_T, **kw)),
        (ct.terminal_equality_constraint(jnp.asarray(TARGET)),
         tt.terminal_equality_constraint(TARGET, **kw)),
    ]


@pytest.mark.parametrize("which", [0, 1], ids=["inequality", "equality"])
def test_terminal_types_match_jax(which):
    jc, pc = _pairs()[which]
    xs = RNG.normal(size=(5, 3)) * 2
    x = torch.as_tensor(xs)
    assert pc.dual_dim == jc.dual_dim and pc.is_equality == jc.is_equality
    np.testing.assert_allclose(pc.upper_bound().numpy(), np.asarray(jc.upper_bound()))
    g = pc.evaluate(x)
    for i, xi in enumerate(xs):
        xj = jnp.asarray(xi)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(jc.evaluate(xj)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(pc.state_jacobian(x)[i].numpy(),
                                   np.asarray(jc.state_jacobian(xj)), rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(pc.state_hessian(x)[i].numpy(),
                                      np.asarray(jc.state_hessian(xj)))
        np.testing.assert_allclose(pc.violation(x)[i].numpy(), np.asarray(jc.violation(xj)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(pc.violation_from_value(g)[i].numpy(),
                                   np.asarray(jc.violation_from_value(jc.evaluate(xj))),
                                   rtol=1e-12, atol=1e-12)


def _stacked_problems():
    """One problem with two inequality items (sorted apart by name) and an
    equality, in both packages."""
    (ji, pi), (je, pe) = _pairs()
    ji2 = ct.terminal_inequality_constraint(jnp.asarray([[0.0, 0.0, 1.0]]), jnp.asarray([2.0]))
    pi2 = tt.terminal_inequality_constraint([[0.0, 0.0, 1.0]], [2.0], device="cpu",
                                            dtype=torch.float64)
    jp = _unicycle_box(horizon=4)
    for name, c in (("b_ineq", ji), ("a_eq", je), ("c_ineq", ji2)):
        jp = jp.add_terminal_constraint(name, c)
    p = port_terminal_problem(_unicycle_box(horizon=4))
    for name, c in (("b_ineq", pi), ("a_eq", pe), ("c_ineq", pi2)):
        p = p.add_terminal_constraint(name, c)
    return jp, p


def test_terminal_stacker_matches_jax():
    jp, p = _stacked_problems()
    js, ps = JTerminalStacker(jp), TerminalStacker(p)
    for attr in ("ineq_names", "ineq_dims", "ineq_dim", "eq_names", "eq_dims", "eq_dim"):
        assert getattr(ps, attr) == getattr(js, attr), attr
    assert ps.ineq_names == ["b_ineq", "c_ineq"] and ps.eq_names == ["a_eq"]
    xs = RNG.normal(size=(4, 3))
    x = torch.as_tensor(xs)
    gi, ge = ps.ineq_evaluate(x), ps.eq_evaluate(x)
    assert gi.shape == (4, 3) and ge.shape == (4, 3)
    for i, xi in enumerate(xs):
        xj = jnp.asarray(xi)
        np.testing.assert_allclose(gi[i].numpy(), np.asarray(js.ineq_evaluate(xj)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(ge[i].numpy(), np.asarray(js.eq_evaluate(xj)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(ps.ineq_jacobian(x).numpy(),
                                      np.asarray(js.ineq_jacobian(xj)))
        np.testing.assert_array_equal(ps.eq_jacobian(x).numpy(), np.asarray(js.eq_jacobian(xj)))
    for split, jsplit, v in ((ps.split_ineq, js.split_ineq, gi), (ps.split_eq, js.split_eq, ge)):
        got, want = split(v), jsplit(jnp.asarray(v.numpy()))
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    # No terminal constraints: empty groups of width 0.
    empty = TerminalStacker(p.replace(terminal_constraints={}))
    assert (empty.ineq_dim, empty.eq_dim) == (0, 0)
    assert empty.ineq_evaluate(x).shape == (4, 0) and empty.eq_jacobian(x).shape == (0, 3)


def test_builders_problem_and_stacker_errors():
    with pytest.raises(ValueError, match="rows and b_N size mismatch"):
        tt.terminal_inequality_constraint(np.ones((2, 3)), np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="rows and b_N size mismatch"):
        ct.terminal_inequality_constraint(jnp.ones((2, 3)), jnp.ones(3))
    _, p = _stacked_problems()
    with pytest.raises(ValueError, match="null constraint"):
        p.add_terminal_constraint("x", None)
    # Add or replace by name; the constructor takes them too.
    (_, pi), (_, pe) = _pairs()
    q0 = p.add_terminal_constraint("b_ineq", pi)
    q = q0.add_terminal_constraint("b_ineq", pe)
    assert q.terminal_constraints["b_ineq"] is pe and q0.terminal_constraints["b_ineq"] is pi
    assert [n for n, _ in q.sorted_terminal_constraints()] == ["a_eq", "b_ineq", "c_ineq"]
    built = tt.problem(p.model, p.objective, [0.0, 0.0, 0.0], 4, 0.05, p.constraints,
                       terminal_constraints={"goal": pe}, device="cpu", dtype=torch.float64)
    assert list(built.terminal_constraints) == ["goal"]
    # Any other type: the stacker raises the JAX package's TypeError, and so
    # does an IPDDP solve and MSIPDDP's kernel eligibility (JAX builds the
    # stacker in mega_ms_eligible); LogDDP's never builds one.
    bad = p.add_terminal_constraint("odd", object())
    jbad = _unicycle_box(horizon=4).add_terminal_constraint("odd", object())
    for stacker, prob in ((TerminalStacker, bad), (JTerminalStacker, jbad)):
        with pytest.raises(TypeError, match="terminal constraint 'odd' has unsupported type"):
            stacker(prob)
    opts = tt.CDDPOptions(max_iterations=1)
    with pytest.raises(TypeError, match="unsupported type"):
        tt.solve(bad, "IPDDP", opts)
    with pytest.raises(TypeError, match="unsupported type"):
        mega_msipddp.mega_eligible(bad, opts)
    assert not mega_msipddp.mega_eligible(bad, opts.replace(solve_engine="xla"))
    assert not mega_logddp.mega_eligible(bad, opts)


FIELDS = ("X", "U", "k", "K", "cost", "iterations", "status")


@pytest.mark.parametrize("solver", ["CLDDP", "LogDDP", "MSIPDDP"])
def test_other_solvers_match_jax_with_terminal_constraints(solver):
    """The JAX CLDDP, LogDDP and MSIPDDP drivers never read terminal
    constraints; the port's give the JAX results on the same problem, kernel
    3 takes it and kernels 8 and 9 decline it."""
    jp = _unicycle_box(horizon=8, state_box=solver != "CLDDP").replace(
        x0=jnp.asarray([0.3, -0.2, 0.1]))
    jp = jp.add_terminal_constraint("TerminalEquality", ct.terminal_equality_constraint(
        jnp.asarray(TARGET))).add_terminal_constraint(
        "TerminalInequality", ct.terminal_inequality_constraint(
            jnp.asarray(A_T), jnp.asarray(B_T)))
    jopts = ct.CDDPOptions(max_iterations=4, tolerance=1e-4)
    p, opts = port_terminal_problem(jp), port_options(jopts)
    kernel = {"CLDDP": mega_clddp, "LogDDP": mega_logddp, "MSIPDDP": mega_msipddp}[solver]
    assert kernel.mega_eligible(p, opts) == (solver == "CLDDP")
    dispatch_log.reset()
    got = solution_to_numpy(tt.solve(p, solver, opts))
    assert not dispatch_log.launches
    jsol = ct.solve(jp, solver, jopts)
    want = dict(zip(FIELDS, (jsol.state_trajectory, jsol.control_trajectory,
                             jsol.feedforward_gains, jsol.feedback_gains,
                             jsol.final_objective, jsol.iterations_completed,
                             jsol.status_code)))
    for name in FIELDS:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name in ("iterations", "status"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-8, err_msg=name)
    # The port's solve with and without them: the same bits.
    free = solution_to_numpy(tt.solve(p.replace(terminal_constraints={}), solver, opts))
    for name in FIELDS:
        np.testing.assert_array_equal(got[name], free[name], err_msg=name)
    assert "Y_T" not in got
