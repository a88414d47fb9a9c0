"""The float64 polish (``cddp_tpu_torch.refine.polish``, ``tt.polish``)
against the JAX package's ``cddp_tpu.refine.polish`` on CPU.

A float32 fleet (B = 3, the reachable unicycle box MPC of
tests/test_refine.py at H = 10) is solved by the port, handed to both
packages' polish (the JAX one as its own Solution type), and the polished
float64 solutions agree: statuses and iterations exactly, X, U, cost,
duals, slacks, residuals and barrier parameter within 1e-8. Cases: the
IPDDP dual-warm path (batched and unbatched, and with a terminal
inequality, whose slacks are rebuilt from g_T), the MSIPDDP dual-warm path,
the trajectory-seeded path (a fleet with one unconverged instance), and
CLDDP's. Also ``Solution.converged_mask``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.solution import Solution as JSolution
from cddp_tpu.solution import Status as JStatus
from cddp_tpu_torch import refine
from cddp_tpu_torch.interop import solution_to_numpy
from test_mega_ipddp import _unicycle_box
from test_torch_warm import port_problem

torch.set_num_threads(1)

REACHABLE = (0.8, 0.6, np.pi / 2)
B, N = 3, 10


def _problem(dtype=jnp.float64, terminal=False):
    jp = _unicycle_box(horizon=N, dtype=dtype, goal=REACHABLE)
    if terminal:
        jp = jp.add_terminal_constraint("TerminalInequality", ct.terminal_inequality_constraint(
            jnp.asarray([[1.0, 0.0, 0.0]], dtype), jnp.asarray([5.0], dtype)))
    return jp


def _jax_solution(sol):
    """A port Solution as the JAX package's Solution (float32 arrays kept)."""
    kw = {}
    for f in dataclasses.fields(sol):
        v = getattr(sol, f.name)
        if f.name == "terminal_slacks":
            continue
        if isinstance(v, torch.Tensor):
            v = jnp.asarray(v.numpy())
        elif isinstance(v, dict):
            v = {k: jnp.asarray(t.numpy()) for k, t in v.items()}
        kw[f.name] = v
    return JSolution(**kw)


def _fleet32(solver, terminal=False, iterations=100):
    """The port's float32 fleet on CPU from three x0 near the origin."""
    p = port_problem(_problem(terminal=terminal), dtype=torch.float32)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.2, 0.2, size=(B, 3)),
                         dtype=torch.float32)
    opts = tt.CDDPOptions(max_iterations=iterations, tolerance=1e-4, acceptable_tolerance=1e-4)
    return p, tt.batched_solve(p, x0, solver, opts)


def _assert_polish_match(got, want):
    np.testing.assert_array_equal(got.status_code.numpy(), np.asarray(want.status_code))
    np.testing.assert_array_equal(got.iterations_completed.numpy(),
                                  np.asarray(want.iterations_completed))
    g = solution_to_numpy(got)
    w = dict(X=want.state_trajectory, U=want.control_trajectory, k=want.feedforward_gains,
             K=want.feedback_gains, cost=want.final_objective, inf_du=want.inf_du,
             mu=want.barrier_mu, inf_pr=want.inf_pr, inf_comp=want.inf_comp,
             Lambda=want.costate_trajectory)
    if want.dual_trajectories is not None:
        w["Y"] = np.concatenate([want.dual_trajectories[k] for k in sorted(want.dual_trajectories)],
                                -1)
        w["S"] = np.concatenate([want.slack_trajectories[k]
                                 for k in sorted(want.slack_trajectories)], -1)
    for name, v in w.items():
        if v is None:
            continue
        assert g[name].dtype == np.float64 or name in ("iterations", "status"), name
        np.testing.assert_allclose(g[name], np.asarray(v), rtol=1e-8, atol=1e-8, err_msg=name)


def _path(monkeypatch):
    """Records whether the polish took the dual-warm path."""
    seen = []
    for name in ("_ipddp_warm_state", "_msipddp_warm_state"):
        fn = getattr(refine, name)
        monkeypatch.setattr(refine, name, lambda *a, fn=fn: seen.append(1) or fn(*a))
    return seen


@pytest.mark.parametrize("case", ["ipddp", "ipddp_unbatched", "ipddp_terminal", "msipddp"])
def test_dual_warm_polish_matches_jax(case, monkeypatch):
    solver = "MSIPDDP" if case == "msipddp" else "IPDDP"
    terminal = case == "ipddp_terminal"
    p32, sol32 = _fleet32(solver, terminal)
    assert bool(sol32.converged_mask().all()), sol32.status_code
    if case == "ipddp_unbatched":
        sol32 = sol32.first()
    seen = _path(monkeypatch)
    got = tt.polish(port_problem(_problem(terminal=terminal)), sol32, tolerance=1e-6)
    assert seen == [1]  # the dual-warm path
    want = ct.polish(_problem(terminal=terminal), _jax_solution(sol32), tolerance=1e-6)
    _assert_polish_match(got, want)
    assert bool(got.converged_mask().all())
    if terminal:
        np.testing.assert_allclose(got.terminal_duals["TerminalInequality"].numpy(),
                                   np.asarray(want.terminal_duals["TerminalInequality"]),
                                   rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("solver", ["IPDDP", "CLDDP"])
def test_trajectory_seeded_polish_matches_jax(solver, monkeypatch):
    """A fleet with an unconverged instance (IPDDP) and a CLDDP fleet polish
    from a cold start seeded with their trajectories."""
    p32, sol32 = _fleet32(solver, iterations=100 if solver == "IPDDP" else 6)
    if solver == "IPDDP":
        code = sol32.status_code.clone()
        code[1] = tt.Status.MAX_ITERATIONS_REACHED
        sol32 = dataclasses.replace(sol32, status_code=code)
    assert not bool(sol32.converged_mask().all())
    seen = _path(monkeypatch)
    got = tt.polish(port_problem(_problem()), sol32, tolerance=1e-6)
    assert seen == []
    want = ct.polish(_problem(), _jax_solution(sol32), tolerance=1e-6)
    assert got.solver_name == solver
    _assert_polish_match(got, want)


def test_converged_mask_matches_jax():
    codes = np.array([[-1, 0, 1], [2, 3, 4], [5, 1, 0]], np.int32)
    sol = tt.Solution(solver_name="IPDDP", status_code=torch.as_tensor(codes),
                      **{f: None for f in ("iterations_completed", "final_objective",
                                           "final_step_length", "final_regularization",
                                           "time_points", "state_trajectory",
                                           "control_trajectory", "feedback_gains",
                                           "feedforward_gains")})
    want = JSolution(status_code=jnp.asarray(codes)).converged_mask()
    got = sol.converged_mask()
    assert got.dtype == torch.bool and tuple(got.shape) == codes.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(tt.Status.CONVERGED) == tuple(JStatus.CONVERGED)
    with pytest.raises(ValueError, match="solver_name"):
        tt.polish(port_problem(_problem()), dataclasses.replace(sol, solver_name=""))
