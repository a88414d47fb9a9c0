"""The port's batch-first receding-horizon controller
(``parallel/batch.py::make_mpc_controller``) against the JAX package's,
vmapped over a fleet of B = 3 controllers, on CPU in float64: three ticks
of CLDDP and IPDDP, each with and without ``reference_fn`` (the arc
reference sliding by one step a tick). Both controllers see the same plant
states; u_apply, the shifted plans and the (B,) cost, iterations and status
of ``info`` agree within 1e-8 (counts exactly) on every tick. Also the
``warm_start_solver_state`` refusals of CLDDP and LogDDP."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.parallel.batch import make_mpc_controller as jmake_mpc_controller
from cddp_tpu_torch.interop import options_from_dict
from test_torch_tracking import DT, arc, port_problem, tracking_jax

torch.set_num_threads(1)

B, N, TICKS = 3, 10, 3
# The reference of each tick: the arc slid by tick * dt, its last row the
# goal. One table, so that both controllers track the same numbers.
REFS = np.stack([arc(N, shift=tick * DT) for tick in range(TICKS)])


def _plant(x, u):
    """The unicycle's Euler step, in numpy: the fleet both controllers steer."""
    return x + DT * np.stack([u[:, 0] * np.cos(x[:, 2]), u[:, 0] * np.sin(x[:, 2]), u[:, 1]], 1)


@functools.lru_cache(maxsize=None)
def _jax_fleet(solver, iterations, tracking):
    jp = tracking_jax(rows="arc", horizon=N)
    if not tracking:
        jp = jp.replace(objective=jp.objective.replace(reference_states=None))
    jopts = ct.CDDPOptions(max_iterations=iterations, tolerance=1e-4)
    ref_fn = (lambda tick: jnp.asarray(REFS)[tick]) if tracking else None
    init_fn, step_fn = jmake_mpc_controller(jp, solver, jopts, reference_fn=ref_fn)
    return jp, jopts, jax.vmap(init_fn), jax.jit(jax.vmap(step_fn, in_axes=(0, 0, None)))


@pytest.mark.parametrize("tracking", [True, False], ids=["reference_fn", "fixed_goal"])
@pytest.mark.parametrize("solver,iterations", [("CLDDP", 6), ("IPDDP", 5)])
def test_fleet_controller_matches_jax(solver, iterations, tracking):
    jp, jopts, jinit, jstep = _jax_fleet(solver, iterations, tracking)
    p = port_problem(jp)
    if not tracking:
        p = p.replace(objective=p.objective.replace(reference_states=None))
    ref_fn = (lambda tick: torch.as_tensor(REFS[tick])) if tracking else None
    init_fn, step_fn = tt.make_mpc_controller(p, solver, options_from_dict(
        dataclasses.asdict(jopts)), reference_fn=ref_fn)

    # The fleet starts off the reference and catches up with it: a fleet on
    # it converges within a tick, and from then on CLDDP's Armijo test and
    # acceptance read a cost change of a few ulps, a roundoff tie between the
    # two packages (ROADMAP section C).
    x = np.random.default_rng(3).uniform(-0.3, 0.3, size=(B, 3)) + np.asarray([-1.5, 1.5, 0.0])
    jstate, state = jinit(jnp.asarray(x)), init_fn(torch.as_tensor(x))
    assert tuple(state.U_plan.shape) == (B, N, 2) and tuple(state.X_plan.shape) == (B, N + 1, 3)
    np.testing.assert_array_equal(state.X_plan.numpy(), np.asarray(jstate.X_plan))
    tol = dict(rtol=1e-8, atol=1e-8)
    for tick in range(TICKS):
        ju, jstate, jinfo = jstep(jstate, jnp.asarray(x), tick)
        u, state, info = step_fn(state, torch.as_tensor(x), tick)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), **tol)
        np.testing.assert_allclose(state.U_plan.numpy(), np.asarray(jstate.U_plan), **tol)
        np.testing.assert_allclose(state.X_plan.numpy(), np.asarray(jstate.X_plan), **tol)
        np.testing.assert_allclose(info["cost"].numpy(), np.asarray(jinfo["cost"]), **tol)
        for key in ("iterations", "status"):
            assert tuple(info[key].shape) == (B,)
            np.testing.assert_array_equal(info[key].numpy(), np.asarray(jinfo[key]), err_msg=key)
        x = _plant(x, u.numpy())
    assert np.all(np.isfinite(x))


@pytest.mark.parametrize("solver", ["CLDDP", "LogDDP"])
def test_warm_start_solver_state_refusals(solver):
    """CLDDP and LogDDP refuse solver-state threading as the JAX package
    does (IPDDP and MSIPDDP thread it: tests/test_torch_warm.py)."""
    p = port_problem(tracking_jax(horizon=N))
    with pytest.raises(ValueError, match="requires IPDDP or MSIPDDP"):
        tt.make_mpc_controller(p, solver, warm_start_solver_state=True)
    with pytest.raises(ValueError, match="requires IPDDP or MSIPDDP"):
        jmake_mpc_controller(tracking_jax(horizon=N), solver, warm_start_solver_state=True)
