"""Warm starts: the port's IPDDP, MSIPDDP and LogDDP warm paths and the
solver-state MPC controller against the JAX package on CPU in float64.

- IPDDP's warm start (``ipddp.warm_start``, ``_initialize(trajectory_warm=)``)
  against the JAX ``_initialize`` under vmap: fabricated path and terminal
  duals and slacks kept exactly (1e-12), stale steps re-initialised, the
  interior repair, the x0-drift reset splitting a batch, the three
  trajectory-warm mu tiers (the unicycle counterparts of
  tests/test_ipddp.py:157-253, :327-).
- ``solve(state=..., return_state=True)`` on the three engines (whole-solve
  dispatch, per-pass, plain) against the JAX ``solve`` vmapped, on the box,
  obstacle and terminal stacks: statuses and iterations equal, X, U, cost
  and every state field within 1e-8.
- MSIPDDP's warm path against the JAX warm ``_initialize`` + ``_drive``,
  seeded as tests/test_mega_msipddp.py::test_warm_start_parity; LogDDP with
  warm gains; ``make_mpc_controller(..., warm_start_solver_state=True)``
  for IPDDP and MSIPDDP against the JAX controller vmapped over B = 3 for
  three ticks; ``interop`` carrying each JAX state across.
"""

import dataclasses
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
from cddp_tpu.parallel.batch import make_mpc_controller as jmake_mpc_controller
from cddp_tpu.solvers import ipddp as jipddp
from cddp_tpu.solvers import logddp as jlogddp
from cddp_tpu.solvers import msipddp as jmsipddp
from cddp_tpu_torch.constraints import path
from cddp_tpu_torch.constraints.stack import PathStacker, TerminalStacker
from cddp_tpu_torch.interop import (options_from_dict, problem_from_arrays,
                                    solution_to_numpy, solver_state_from_arrays)
from cddp_tpu_torch.ops.kernels import dispatch_log, mega_ipddp
from cddp_tpu_torch.solvers import ipddp
from test_mega_ipddp import (_unicycle_box, _unicycle_obstacle, _unicycle_terminal_eq,
                             _unicycle_terminal_ineq)

torch.set_num_threads(1)

F64 = jnp.float64
B = 3
BOXES = {"ControlConstraint": "control", "StateConstraint": "state"}
STATE_FIELDS = ("k", "K", "Y", "S", "Lambda", "Y_T", "S_T", "Lambda_T_eq", "x0")
SOLVE_FIELDS = ("X", "U", "cost", "mu", "inf_pr", "inf_du", "inf_comp", "reg", "alpha_pr")


def port_problem(jp, dtype=torch.float64):
    """The port's copy of a JAX problem: boxes, the other path-constraint
    types and terminal constraints, through ``interop.problem_from_arrays``."""
    o = jp.objective
    boxes, others, term = {}, {}, {}
    for name, c in jp.constraints.items():
        kind = type(c).__name__
        if kind in BOXES:
            boxes[name] = (BOXES[kind], np.asarray(c.lower), np.asarray(c.upper),
                           c.scale_factor)
            continue
        fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(getattr(path, kind))}
        others[name] = (kind, {k: v if isinstance(v, (int, float)) else np.asarray(v)
                               for k, v in fields.items()})
    for name, c in jp.terminal_constraints.items():
        kind = type(c).__name__
        term[name] = (kind, {"target_state": np.asarray(c.target_state)}
                      if kind == "TerminalEqualityConstraint"
                      else {"A": np.asarray(c.A), "b": np.asarray(c.b)})
    return problem_from_arrays(
        type(jp.model).__name__, [], o.Q, o.R, o.Qf, o.reference_state, None, None,
        jp.x0, jp.horizon, jp.timestep, jp.model.integration_type,
        device="cpu", dtype=dtype, boxes=boxes, constraints=others,
        terminal_constraints=term)


def port_options(jopts):
    return options_from_dict(dataclasses.asdict(jopts))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, name, tol=1e-8):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


def _x0(seed, scale=0.4, n=B):
    return np.random.default_rng(seed).uniform(-scale, scale, size=(n, 3))


def _ipopts(iterations, **ip):
    return ct.CDDPOptions(max_iterations=iterations, tolerance=1e-4,
                          ipddp=ct.IPDDPOptions(**ip))


# ---------------------------------------------------------------------------
# IPDDP: the warm branches of _initialize
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_warm_solve(jopts):
    """The jitted JAX ``solve`` from a state, vmapped over (x0, X0, U0,
    state), returning (Solution, IPDDPSolverState); the problem is an
    argument."""

    def one(p, x, X0, U0, st):
        return jipddp.solve(p.replace(x0=x), jopts, X0=X0, U0=U0, state=st, return_state=True)

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0, 0)))


def _cold_state(jp, x0, iterations=3, solver="IPDDP", **ms):
    """A cold solve from x0 and its state as the JAX package's state type
    (numpy fields): the seed each warm case starts from. The port solves it
    (its cold solves are held to the JAX package by the other parity files),
    so that no JAX compile is spent on it."""
    p = port_problem(jp).replace(x0=torch.as_tensor(x0))
    opts = tt.CDDPOptions(max_iterations=iterations, tolerance=1e-4,
                          msipddp=tt.MSIPDDPOptions(**ms))
    sol, st = tt.solve(p, solver, opts, return_state=True)
    cls = jipddp.IPDDPSolverState if solver == "IPDDP" else jmsipddp.MSIPDDPSolverState
    return sol, cls(*(t.numpy() for t in st))


def _jax_initialize(jp, jopts, x0, U0, warm, trajectory_warm):
    """The JAX ``_initialize`` (and ``_solve``'s warm gains) under vmap."""
    N = jp.horizon

    def one(x, U, st):
        p = jp.replace(x0=x)
        X, U, Y, S, G, G_T, S_T, Y_T, Lam, Lte, mu0, reset = jipddp._initialize(
            p, jopts, JPathStacker(p), JTerminalStacker(p), U, st, trajectory_warm, F64)
        k, K = jnp.zeros((N, 2)), jnp.zeros((N, 2, 3))
        if st is not None:
            k, K = ((jnp.where(reset, k, st.k_u), jnp.where(reset, K, st.K_u))
                    if reset is not None else (st.k_u, st.K_u))
        return dict(X=X, U=U, Y=Y, S=S, G=G, S_T=S_T, Y_T=Y_T, Lambda=Lam,
                    Lambda_T_eq=Lte, mu0=jnp.broadcast_to(mu0, ()), k=k, K=K)

    return jax.vmap(one)(jnp.asarray(x0), jnp.asarray(U0), warm)


def _port_initialize(p, opts, U0, state, trajectory_warm):
    stk, tstk = PathStacker(p), TerminalStacker(p)
    U0 = torch.as_tensor(np.asarray(U0))
    if state is not None:
        X, U, Y, S, G, Lam, mu0, (S_T, Y_T, Lte), k, K = ipddp.warm_start(
            p, opts, stk, tstk, U0, state)
    else:
        X, U, Y, S, G, Lam, mu0 = ipddp._initialize(p, opts, stk, U0, trajectory_warm, tstk)
        S_T, Y_T, Lte = ipddp.initialize_terminal(p, opts, tstk, X, mu0)
        k, K = X.new_zeros(X.shape[0], p.horizon, 2), X.new_zeros(X.shape[0], p.horizon, 2, 3)
    return dict(X=X, U=U, Y=Y, S=S, G=G, S_T=S_T, Y_T=Y_T, Lambda=Lam, Lambda_T_eq=Lte,
                mu0=mu0, k=k, K=K)


def _fabricate(st, **values):
    """The state with fields set to constants or edited by functions."""
    out = st._asdict()
    for name, v in values.items():
        out[name] = v(np.array(out[name])) if callable(v) else np.full_like(out[name], v)
    return type(st)(**out)


def _stale_steps(Y):
    Y = Y.copy()
    Y[:, ::3, 1] = 0.0  # y <= EPS_DUAL: the step re-initialises
    Y[1, 4, 0] = np.nan  # a non-finite entry too
    return Y


def _hug_boundary(S):
    S = S.copy()
    S[0, 0, 0], S[2, 5, 3] = 1e-12, 3e-5
    return S


def _drift(x0):
    """x0 moved by 0.9 on instance 1 (above the 0.5 threshold), 0.01 on the
    others."""
    x1 = x0 + 0.01
    x1[1, 0] += 0.9
    return x1


def _tier_controls(N):
    """One control seed per mu tier: inside the box (no violation), 0.05
    outside it, 0.5 outside it."""
    U = np.zeros((B, N, 2))
    U[1, :, 0], U[2, :, 0] = 2.05, 2.5
    return U


# id -> (problem builder, options, fabricated fields, x0 of the warm start,
#        checks on the port's result)
INIT_CASES = {
    "fabricated_path": (lambda: _unicycle_box(horizon=10), _ipopts(1),
                        dict(Y=0.73, S=0.42), None),
    "fabricated_terminal": (lambda: _unicycle_terminal_eq(horizon=10).add_terminal_constraint(
        "TerminalInequality", ct.terminal_inequality_constraint(
            jnp.concatenate([jnp.eye(2, 3), -jnp.eye(2, 3)]), jnp.full((4,), 4.0))),
        _ipopts(1), dict(Y=0.73, S=0.42, Y_T=0.61, S_T=0.37, Lambda_T_eq=0.53), None),
    "stale_slacks": (lambda: _unicycle_box(horizon=10, state_box=True), _ipopts(1),
                     dict(S=0.42), None),
    "stale_steps": (lambda: _unicycle_box(horizon=10), _ipopts(1), dict(Y=_stale_steps), None),
    "interior_repair": (lambda: _unicycle_terminal_ineq(horizon=10),
                        _ipopts(1, warmstart_repair=True, warmstart_staleness_check=False),
                        dict(S=_hug_boundary, Y_T=lambda v: v * 0 + 2e-5), None),
    "repair_and_staleness": (lambda: _unicycle_box(horizon=10),
                             _ipopts(1, warmstart_repair=True),
                             dict(S=_hug_boundary), None),
    "reset_x0": (lambda: _unicycle_terminal_ineq(horizon=10),
                 _ipopts(1, warmstart_reset_x0_threshold=0.5), {}, _drift),
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_warm_initialize_matches_jax(case):
    make, jopts, fab, move = INIT_CASES[case]
    jp = make()
    x0 = _x0(1)
    sol, st = _cold_state(jp, x0, iterations=1)
    st = _fabricate(st, **fab)
    x1 = x0 if move is None else move(x0)
    # The fabricated cases start from zero controls, as the JAX package's
    # zero-iteration solves do, so that no step's slack is stale.
    U0 = np.asarray(sol.control_trajectory) * (not case.startswith("fabricated"))
    wopts = jopts.replace(warm_start=True)
    want = _jax_initialize(jp, wopts, x1, U0, st, False)
    p = port_problem(jp).replace(x0=torch.as_tensor(x1))
    got = _port_initialize(p, port_options(wopts), U0,
                           solver_state_from_arrays(st, device="cpu"), False)
    for name in want:
        _close(got[name], want[name], name, tol=1e-12)
    for name, v in fab.items():
        if not callable(v) and "stale" not in case:
            np.testing.assert_allclose(got[{"k_u": "k"}.get(name, name)].numpy(), v, atol=1e-12,
                                       err_msg=name)
    if case == "stale_slacks":
        assert float(got["S"].min()) > 1.0  # re-initialised at ~5, not 0.42
    if case == "stale_steps":
        kept = np.ones((B, 10), bool)
        kept[:, ::3], kept[1, 4] = False, False
        np.testing.assert_array_equal(got["Y"].numpy()[kept], st.Y[kept])
        assert np.all(got["Y"].numpy()[~kept] != st.Y[~kept])
    if case == "reset_x0":
        cold = _port_initialize(p, port_options(jopts), np.zeros_like(U0), None, False)
        for name in ("X", "Y", "S", "mu0"):
            np.testing.assert_array_equal(got[name][1].numpy(), cold[name][1].numpy())
        assert not np.allclose(got["X"][0].numpy(), cold["X"][0].numpy())
        assert float(got["k"][1].abs().max()) == 0.0 < float(got["k"][0].abs().max())


def test_trajectory_warm_mu_tiers():
    """A warm start from U0 without a state tiers mu0 per instance by the
    seed's violation (tolerance, 1% of mu_initial, 10%), with a terminal
    inequality's rows counted (ipddp.py:1406-1428)."""
    jp = _unicycle_terminal_ineq(horizon=10, binding=False)
    wopts = _ipopts(1).replace(warm_start=True)
    U0 = _tier_controls(jp.horizon)
    x0 = _x0(2, 0.1)
    want = _jax_initialize(jp, wopts, x0, U0, None, True)
    p = port_problem(jp).replace(x0=torch.as_tensor(x0))
    got = _port_initialize(p, port_options(wopts), U0, None, True)
    for name in want:
        _close(got[name], want[name], name, tol=1e-12)
    np.testing.assert_allclose(got["mu0"].numpy(), [1e-4, 0.01, 0.1], rtol=1e-12)
    # Through the entry point: warm_start with U0 and no state.
    sol = tt.solve(p, "IPDDP", port_options(wopts.replace(max_iterations=0)),
                   U0=torch.as_tensor(U0))
    np.testing.assert_allclose(sol.barrier_mu.numpy(), [1e-4, 0.01, 0.1], rtol=1e-12)


def test_zero_iteration_warm_solve_keeps_fabricated_state():
    """A zero-iteration warm solve returns the initialized state, through
    the public entry point, unbatched (tests/test_ipddp.py:197-240)."""
    jp = _unicycle_terminal_ineq(horizon=10, binding=False)
    p = port_problem(jp)
    opts = tt.CDDPOptions(max_iterations=1, tolerance=1e-4)
    _, st = tt.solve(p, "IPDDP", opts, return_state=True)
    assert tuple(st.Y.shape) == (10, 4) and tuple(st.x0.shape) == (3,)
    fab = st._replace(Y=torch.full_like(st.Y, 0.73), S=torch.full_like(st.S, 0.42),
                      Y_T=torch.full_like(st.Y_T, 0.61), S_T=torch.full_like(st.S_T, 0.37))
    _, out = tt.solve(p, "IPDDP", opts.replace(warm_start=True, max_iterations=0),
                      state=fab, return_state=True)
    for name, v in (("Y", 0.73), ("S", 0.42), ("Y_T", 0.61), ("S_T", 0.37)):
        np.testing.assert_allclose(getattr(out, name).numpy(), v, atol=1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# IPDDP: warm solves on the three engines
# ---------------------------------------------------------------------------

STACKS = {
    "box": (lambda: _unicycle_box(horizon=10), 4),
    "obstacle": (lambda: _unicycle_obstacle(horizon=10), 4),
    "terminal_ineq": (lambda: _unicycle_terminal_ineq(horizon=10), 4),
    "terminal_eq": (lambda: _unicycle_terminal_eq(horizon=10), 3),
}
ENGINES = {
    "whole": {},
    "per_pass": dict(solve_engine="xla"),
    "plain": dict(backward_engine="scan"),
}


def _tick(sol, x0):
    """The next tick's seed: x0 advanced one step, the plan shifted."""
    U = np.asarray(sol.control_trajectory)
    X = np.asarray(sol.state_trajectory)
    return X[:, 1], np.concatenate([U[:, 1:], U[:, -1:]], 1)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_warm_solve_matches_jax(stack, engine):
    make, iterations = STACKS[stack]
    jp = make()
    N = jp.horizon
    x0 = _x0(3, 0.3)
    sol, st = _cold_state(jp, x0, iterations=3)
    x1, U1 = _tick(sol, x0)
    jopts = _ipopts(iterations).replace(warm_start=True)
    X1 = np.broadcast_to(x1[:, None], (B, N + 1, 3))
    jsol, jst = _jax_warm_solve(jopts)(jp, jnp.asarray(x1), jnp.asarray(X1), jnp.asarray(U1),
                                       st)
    p = port_problem(jp).replace(x0=torch.as_tensor(x1))
    opts = port_options(jopts).replace(**ENGINES[engine])
    assert mega_ipddp.mega_eligible(p, opts) == (engine == "whole")
    dispatch_log.reset()
    got, gst = tt.solve(p, "IPDDP", opts, U0=torch.as_tensor(U1),
                        state=solver_state_from_arrays(st, device="cpu"),
                        return_state=True)
    assert not dispatch_log.launches  # CPU tensors: the plain versions
    np.testing.assert_array_equal(got.status_code.numpy(), np.asarray(jsol.status_code))
    np.testing.assert_array_equal(got.iterations_completed.numpy(),
                                  np.asarray(jsol.iterations_completed))
    g = solution_to_numpy(got, gst)
    want = dict(X=jsol.state_trajectory, U=jsol.control_trajectory, cost=jsol.final_objective,
                mu=jsol.barrier_mu, inf_pr=jsol.inf_pr, inf_du=jsol.inf_du,
                inf_comp=jsol.inf_comp, reg=jsol.final_regularization,
                alpha_pr=jsol.final_step_length, k=jst.k_u, K=jst.K_u, Y=jst.Y, S=jst.S,
                Lambda=jst.Lambda, Y_T=jst.Y_T, S_T=jst.S_T, Lambda_T_eq=jst.Lambda_T_eq,
                x0=jst.x0)
    for name in SOLVE_FIELDS + STATE_FIELDS:
        _close(g[name], want[name], name)
    assert int(got.iterations_completed.max()) >= 1


# ---------------------------------------------------------------------------
# MSIPDDP and LogDDP
# ---------------------------------------------------------------------------


def _msopts(iterations, **ms):
    return ct.CDDPOptions(max_iterations=iterations, tolerance=1e-4,
                          msipddp=ct.MSIPDDPOptions(**ms))


@functools.lru_cache(maxsize=None)
def _jax_ms_warm(jopts):
    """The JAX warm ``_initialize`` + ``_drive`` vmapped over (x0, X0, U0,
    state), as tests/test_mega_msipddp.py::test_warm_start_parity seeds it."""

    def one(p, x, X0, U0, st):
        p = p.replace(x0=x)
        X, U, Y, S, G, F, Lam, mu0 = jmsipddp._initialize(p, jopts, JPathStacker(p), X0, U0,
                                                          st, F64)
        return jmsipddp._drive(p, jopts, X, U, Y, S, G, F, Lam, jnp.asarray(mu0, F64),
                               st.k_u, st.K_u)

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0, 0)))


@pytest.mark.parametrize("staleness", [True, False], ids=["staleness", "no_staleness"])
@pytest.mark.parametrize("engine", ["whole", "plain"])
def test_msipddp_warm_matches_jax(engine, staleness):
    """The MSIPDDP warm path from a cold solve's state and trajectories
    (defect-free) and from the next tick's shifted plans (the shifted X
    carries defects at its last node), against the JAX warm ``_initialize``
    + ``_drive``; one slack below 10% of its cold value shows the staleness
    rule."""
    jp = _unicycle_box(horizon=12)
    csol, cst = _cold_state(jp, _x0(4, 0.3), 3, "MSIPDDP", segment_length=4)
    X, U = csol.state_trajectory.numpy(), csol.control_trajectory.numpy()
    st = _fabricate(cst, S=lambda S: np.where(
        np.arange(S.shape[1])[None, :, None] == 2, 1e-3, S))
    jopts = _msopts(4, segment_length=4, warmstart_staleness_check=staleness).replace(
        warm_start=True)
    p = port_problem(jp)
    opts = port_options(jopts).replace(**ENGINES[engine])
    for Xs, Us in ((X, U), (np.concatenate([X[:, 1:], X[:, -1:]], 1),
                            np.concatenate([U[:, 1:], U[:, -1:]], 1))):
        xs = Xs[:, 0]
        want_sol, want_st = _jax_ms_warm(jopts)(jp, jnp.asarray(xs), jnp.asarray(Xs),
                                                jnp.asarray(Us), st)
        got, gst = tt.solve(p.replace(x0=torch.as_tensor(xs)), "MSIPDDP", opts,
                            X0=torch.as_tensor(Xs), U0=torch.as_tensor(Us),
                            state=solver_state_from_arrays(st, device="cpu"),
                            return_state=True)
        np.testing.assert_array_equal(got.status_code.numpy(), np.asarray(want_sol.status_code))
        np.testing.assert_array_equal(got.iterations_completed.numpy(),
                                      np.asarray(want_sol.iterations_completed))
        g = solution_to_numpy(got, gst)
        want = dict(X=want_sol.state_trajectory, U=want_sol.control_trajectory,
                    cost=want_sol.final_objective, mu=want_sol.barrier_mu,
                    inf_pr=want_sol.inf_pr, inf_du=want_sol.inf_du, k=want_st.k_u,
                    K=want_st.K_u, Y=want_st.Y, S=want_st.S, F=want_st.F,
                    Lambda=want_st.Lambda)
        for name, w in want.items():
            _close(g[name], w, name)


def test_logddp_warm_gains_match_jax():
    """LogDDP seeded with gains (logddp.py:531-536) on both engines against
    the JAX ``solve`` vmapped; without ``warm_start`` the gains are ignored,
    and a zero-iteration solve returns the seed, as in JAX."""
    jp = _unicycle_box(horizon=12)
    x0 = jnp.asarray(_x0(5, 0.3))
    rng = np.random.default_rng(7)
    gains = (0.05 * rng.standard_normal((B, 12, 2)), 0.05 * rng.standard_normal((B, 12, 2, 3)))
    wopts = ct.CDDPOptions(max_iterations=4, tolerance=1e-4, warm_start=True)
    want = jax.jit(jax.vmap(lambda x, k, K: jlogddp.solve(
        jp.replace(x0=x), wopts, gains=(k, K))))(x0, *gains)
    p = port_problem(jp).replace(x0=torch.as_tensor(np.asarray(x0)))
    tgains = tuple(torch.as_tensor(g) for g in gains)
    for engine in ("whole", "plain"):
        got = tt.solve(p, "LogDDP", port_options(wopts).replace(**ENGINES[engine]),
                       gains=tgains)
        np.testing.assert_array_equal(got.iterations_completed.numpy(),
                                      np.asarray(want.iterations_completed))
        np.testing.assert_array_equal(got.status_code.numpy(), np.asarray(want.status_code))
        for name, g, w in (("X", got.state_trajectory, want.state_trajectory),
                           ("U", got.control_trajectory, want.control_trajectory),
                           ("k", got.feedforward_gains, want.feedforward_gains),
                           ("K", got.feedback_gains, want.feedback_gains),
                           ("cost", got.final_objective, want.final_objective)):
            _close(g, w, name)
    seed = tt.solve(p, "LogDDP", port_options(wopts.replace(max_iterations=0)), gains=tgains)
    np.testing.assert_array_equal(seed.feedforward_gains.numpy(), gains[0])
    cold = tt.solve(p, "LogDDP", port_options(wopts.replace(warm_start=False, max_iterations=0)),
                    gains=tgains)
    assert float(cold.feedforward_gains.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the solver-state MPC controller
# ---------------------------------------------------------------------------


TICKS = 3


def _plant(x, u, dt):
    return x + dt * np.stack([u[:, 0] * np.cos(x[:, 2]), u[:, 0] * np.sin(x[:, 2]), u[:, 1]], 1)


@functools.lru_cache(maxsize=None)
def _jax_controller(solver, iterations):
    jp = _unicycle_box(horizon=10)
    jopts = ct.CDDPOptions(max_iterations=iterations, tolerance=1e-4)
    init_fn, step_fn = jmake_mpc_controller(jp, solver, jopts, warm_start_solver_state=True)
    return jp, jopts, jax.jit(jax.vmap(init_fn)), jax.jit(jax.vmap(step_fn,
                                                                    in_axes=(0, 0, None)))


@pytest.mark.parametrize("solver,iterations", [("IPDDP", 4), ("MSIPDDP", 4)])
def test_solver_state_controller_matches_jax(solver, iterations):
    """Three ticks of the solver-state controller against the JAX one
    vmapped over the fleet: u_apply, the plans, every state field and the
    info within 1e-8 (counts exactly); the state is carried unshifted."""
    jp, jopts, jinit, jstep = _jax_controller(solver, iterations)
    p = port_problem(jp)
    init_fn, step_fn = tt.make_mpc_controller(p, solver, port_options(jopts),
                                              warm_start_solver_state=True)
    x = _x0(6, 0.3)
    (jmpc, jst), (mpc, st) = jinit(jnp.asarray(x)), init_fn(torch.as_tensor(x))
    tol = dict(rtol=1e-8, atol=1e-8)
    for tick in range(TICKS + 1):
        for name in st._fields:
            np.testing.assert_allclose(_np(getattr(st, name)), np.asarray(getattr(jst, name)),
                                       err_msg=f"tick {tick} state {name}", **tol)
        if tick == TICKS:
            break
        ju, (jmpc, jst), jinfo = jstep((jmpc, jst), jnp.asarray(x), tick)
        u, (mpc, st), info = step_fn((mpc, st), torch.as_tensor(x), tick)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), **tol)
        np.testing.assert_allclose(mpc.U_plan.numpy(), np.asarray(jmpc.U_plan), **tol)
        np.testing.assert_allclose(mpc.X_plan.numpy(), np.asarray(jmpc.X_plan), **tol)
        np.testing.assert_allclose(info["cost"].numpy(), np.asarray(jinfo["cost"]), **tol)
        for key in ("iterations", "status"):
            np.testing.assert_array_equal(info[key].numpy(), np.asarray(jinfo[key]), err_msg=key)
        x = _plant(x, u.numpy(), jp.timestep)


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["IPDDP", "MSIPDDP"])
def test_interop_carries_solver_states(solver):
    """A JAX state (the JAX package's type, jax arrays), unbatched or with a
    batch axis, becomes the port's state of the same layout and values;
    ``solution_to_numpy`` exports a port state back."""
    jp = _unicycle_terminal_ineq(horizon=6) if solver == "IPDDP" else _unicycle_box(horizon=6)
    sol, st = _cold_state(jp, _x0(8, 0.3, n=2), 1, solver)
    cls = tt.IPDDPSolverState if solver == "IPDDP" else tt.MSIPDDPSolverState
    jst = type(st)(*(jnp.asarray(v) for v in st))
    for one in (jst, jax.tree.map(lambda v: v[0], jst)):
        got = solver_state_from_arrays(one, device="cpu")
        assert type(got) is cls and got._fields == one._fields
        for name in one._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(one, name)))
    out = solution_to_numpy(sol, solver_state_from_arrays(jst, device="cpu"))
    keys = {"IPDDP": ("k", "K", "Y", "S", "Lambda", "Y_T", "S_T", "Lambda_T_eq", "x0"),
            "MSIPDDP": ("k", "K", "Y", "S", "Lambda", "F")}[solver]
    fields = dict(k="k_u", K="K_u")
    for key in keys:
        np.testing.assert_array_equal(out[key], getattr(st, fields.get(key, key)), err_msg=key)
    assert ("F" in out) == (solver == "MSIPDDP") and ("x0" in out) == (solver == "IPDDP")
    with pytest.raises(TypeError, match="not an IPDDP or MSIPDDP"):
        solver_state_from_arrays(sol)
