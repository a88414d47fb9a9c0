"""IPDDP without path constraints through the port's ``tt.solve`` on CPU
against the JAX package's vmapped ``_drive``, seeded as
tests/test_mega_ipddp.py::_seed_batch seeds it (float64, rtol = atol = 1e-8
on X, U, k, K, Lambda, cost, inf_pr, inf_du, inf_comp, mu, reg, alpha_pr and
the terminal state; statuses and iteration counts exact): the unconstrained
pendulum of tests/test_ipddp.py:81-92 at N = 30, the default LTISystem 4x2
of tests/test_clddp.py:160-172, and the flagship unicycle with a terminal
inequality alone and with a terminal equality alone (the p+1 reduced LQR
without path rows). No such problem reaches the forward trial kernel (5),
the condensed backward kernel (6) or the whole solve (7), not even their
plain versions' dispatch: the JAX driver gates all three on path rows."""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.constraints.stack import PathStacker as JPathStacker
from cddp_tpu.constraints.stack import TerminalStacker as JTerminalStacker
from cddp_tpu.models import Pendulum as JPendulum
from cddp_tpu.models import lti_system as jlti_system
from cddp_tpu.solvers import ipddp as jipddp
from cddp_tpu_torch.interop import problem_from_arrays, solution_to_numpy
from cddp_tpu_torch.ops.kernels import mega_ipddp
from test_mega_ipddp import (VERDICT_SEEDS, _seed_batch, _unicycle_box,
                             _unicycle_terminal_eq, _unicycle_terminal_ineq)
from test_torch_ipddp import port_options
from test_torch_models import model_params

torch.set_num_threads(1)

FIELDS = ("X", "U", "k", "K", "Lambda", "cost", "inf_pr", "inf_du", "inf_comp", "mu", "reg",
          "alpha_pr", "iterations", "status", "Y_T", "S_T", "Lambda_T_eq")
BOXES = {"ControlConstraint": "control", "StateConstraint": "state"}


def port_any(jp, dtype=torch.float64):
    """The port's copy of a JAX problem of any ported model, with its box
    and terminal constraints, through ``interop.problem_from_arrays``."""
    o = jp.objective
    boxes = {name: (BOXES[type(c).__name__], np.asarray(c.lower), np.asarray(c.upper),
                    c.scale_factor) for name, c in jp.constraints.items()}
    term = {}
    for name, c in jp.terminal_constraints.items():
        kind = type(c).__name__
        term[name] = (kind, {"target_state": np.asarray(c.target_state)}
                      if kind == "TerminalEqualityConstraint"
                      else {"A": np.asarray(c.A), "b": np.asarray(c.b)})
    return problem_from_arrays(
        type(jp.model).__name__, model_params(jp.model), o.Q, o.R, o.Qf, o.reference_state,
        None, None, jp.x0, jp.horizon, jp.timestep, jp.model.integration_type,
        device="cpu", dtype=dtype, boxes=boxes, terminal_constraints=term)


@functools.lru_cache(maxsize=None)
def _jax_fleet(jopts, N, nx, nu):
    """The jitted JAX vmapped ``_drive`` for one option set and shape, from
    cold seeds; the problem is an argument."""

    def one(p, x, Xi, Ui, Yi, Si, Li, mu0i, STi, YTi, LTEi):
        p = p.replace(x0=x)
        stk, tstk = JPathStacker(p), JTerminalStacker(p)
        sol, st = jipddp._drive(
            p, jopts, Xi, Ui, Yi, Si, jipddp._eval_path(p, stk, Xi, Ui),
            tstk.ineq_evaluate(Xi[-1]), STi, YTi, Li, LTEi, mu0i,
            jnp.zeros((N, nu)), jnp.zeros((N, nu, nx)))
        return dict(zip(FIELDS, (
            sol.state_trajectory, sol.control_trajectory, st.k_u, st.K_u, st.Lambda,
            sol.final_objective, sol.inf_pr, sol.inf_du, sol.inf_comp, sol.barrier_mu,
            sol.final_regularization, sol.final_step_length, sol.iterations_completed,
            sol.status_code, st.Y_T, st.S_T, st.Lambda_T_eq))), sol.dual_trajectories

    return jax.jit(jax.vmap(one, in_axes=(None,) + (0,) * 10))


def jax_drive(jp, jopts, x0):
    out, duals = _jax_fleet(jopts, jp.horizon, jp.state_dim, jp.control_dim)(
        jp, x0, *_seed_batch(jp, jopts, x0))
    assert duals is None
    return out


def assert_match(got, want, tol=1e-8):
    for name in FIELDS:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name in ("iterations", "status"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def _pendulum(N=30):
    """tests/test_ipddp.py:81-92 at N = 30: no constraint at all."""
    obj = ct.quadratic_objective(jnp.zeros((2, 2)), 0.1 * jnp.eye(1), 100.0 * jnp.eye(2),
                                 jnp.zeros(2), 0.02)
    return ct.problem(JPendulum(length=0.5, mass=1.0, damping=0.01), obj,
                      jnp.array([jnp.pi, 0.0]), N, 0.02)


def _lti():
    """tests/test_clddp.py:160-172: the default 4x2 system, N = 30."""
    obj = ct.quadratic_objective(0.5 * jnp.eye(4), 0.1 * jnp.eye(2), 5.0 * jnp.eye(4),
                                 jnp.zeros(4), 0.1)
    return ct.problem(jlti_system(0.1), obj, jnp.array([1.0, -1.0, 0.5, 0.2]), 30, 0.1)


def _no_box(prob):
    return prob.replace(constraints={})


def _x0(base, seed, scale, B=3):
    rng = np.random.default_rng(seed)
    return jnp.asarray(np.asarray(base) + rng.uniform(-scale, scale, (B, len(base))))


# id -> (JAX problem, JAX options, x0 batch)
CASES = {
    "pendulum": lambda: (_pendulum(), ct.CDDPOptions(max_iterations=60, tolerance=1e-5),
                         _x0([np.pi, 0.0], 0, 0.1)),
    "lti_4x2": lambda: (_lti(), ct.CDDPOptions(max_iterations=10, tolerance=1e-8,
                                               acceptable_tolerance=1e-12),
                        _x0([1.0, -1.0, 0.5, 0.2], 1, 0.2)),
    "terminal_inequality_only": lambda: (
        _no_box(_unicycle_terminal_ineq(horizon=20, binding=True)),
        ct.CDDPOptions(max_iterations=8, tolerance=1e-4), jnp.asarray(VERDICT_SEEDS)),
    "terminal_equality_only": lambda: (
        _no_box(_unicycle_terminal_eq(horizon=20)),
        ct.CDDPOptions(max_iterations=8, tolerance=1e-4), jnp.asarray(VERDICT_SEEDS)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_drive_and_reaches_no_path_kernel(case, caplog):
    jp, jopts, x0 = CASES[case]()
    want = jax_drive(jp, jopts, x0)
    p = port_any(jp).replace(x0=torch.as_tensor(np.asarray(x0)))
    assert not mega_ipddp.mega_eligible(p, port_options(jopts))
    with caplog.at_level(logging.INFO, logger="cddp_tpu_torch.dispatch"):
        sol = tt.solve(p, "IPDDP", port_options(jopts))
    touched = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith(("ip_forward", "ipddp_backward", "ipddp_solve"))]
    assert not touched, touched
    assert sol.dual_trajectories is None and sol.slack_trajectories is None
    got = solution_to_numpy(sol)
    for name in ("Y_T", "S_T", "Lambda_T_eq"):
        got.setdefault(name, np.zeros(np.shape(want[name])))
    assert_match(got, want)


def test_unconstrained_regime_converges_and_keeps_mu():
    """The pendulum's cold mu0 is max(tolerance / 10, mu_min_value)
    (ipddp.py:1371-1374) and stays there; instances converge (status 1 or
    2), as tests/test_ipddp.py:81 requires of the JAX driver."""
    jp, jopts, x0 = CASES["pendulum"]()
    opts = port_options(jopts).replace(max_iterations=200)
    sol = tt.solve(port_any(jp).replace(x0=torch.as_tensor(np.asarray(x0))), "IPDDP", opts)
    assert torch.all(sol.barrier_mu == max(opts.tolerance / 10.0,
                                           opts.ipddp.barrier.mu_min_value))
    assert set(sol.status_code.tolist()) <= {1, 2}


def test_unbatched_solve_and_solver_state():
    """An unbatched no-path solve returns no dual maps, and its solver state
    carries (N, 0) duals and slacks, as the JAX state does."""
    jp, jopts, _ = CASES["lti_4x2"]()
    p = port_any(jp)
    sol, st = tt.solve(p, "IPDDP", port_options(jopts), return_state=True)
    assert sol.dual_trajectories is None and sol.state_trajectory.shape == (31, 4)
    assert st.Y.shape == (30, 0) and st.S.shape == (30, 0) and st.Y_T.shape == (0,)


def test_fused_engine_refuses_the_no_path_regime():
    jp, jopts, x0 = CASES["pendulum"]()
    with pytest.raises(ValueError, match="solve_engine='fused'"):
        tt.solve(port_any(jp).replace(x0=torch.as_tensor(np.asarray(x0))), "IPDDP",
                 port_options(jopts).replace(solve_engine="fused"))
