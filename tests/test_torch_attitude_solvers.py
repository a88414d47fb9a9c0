"""The attitude trio's solves through the port against the JAX package (CPU,
float64, statuses and iteration counts exact, X, U and cost within 1e-8):

- CLDDP, IPDDP and LogDDP at the attitude MPC's horizon N = 20 against the
  JAX ``batched_solve``, on both of the port's dispatch paths (the
  whole-solve dispatch, which CPU tensors take to the plain driver kernels
  3, 7 and 9 are held to, and the per-pass engine, ``solve_engine="xla"``),
  one model each (the MRP's CLDDP below; every model's kernels and routes
  in ``tests/test_torch_attitude.py``);
- the example's MRP slew (examples/spacecraft_examples.py:59-82, N = 200)
  through ``tt.solve`` against the JAX example's solve, over its first
  iterations, before the solve converges: at convergence the acceptable
  exit reads one-ulp cost changes, which the two packages' cost sums round
  apart (ROADMAP C.7). Its full 150 iterations are slow-marked.

Apart from the model tests (``tests/test_torch_attitude.py``) because the
JAX drivers' tracing and compiling take most of the time of each."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.parallel.batch import batched_solve as jbatched_solve
from cddp_tpu_torch.interop import solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log
from cddp_tpu_torch.parallel.batch import batched_solve
from test_torch_attitude import att_box, x0_batch
from test_torch_ipddp import port_options
from test_torch_zoo import port_zoo_problem

torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)
# Field name -> Solution attribute of both packages.
FIELDS = {"X": "state_trajectory", "U": "control_trajectory", "cost": "final_objective",
          "inf_du": "inf_du", "iterations": "iterations_completed", "status": "status_code"}
BARRIER = {"inf_pr": "inf_pr", "mu": "barrier_mu"}


def assert_match(got, jsol, names):
    for name in names:
        g, w = got[name], np.asarray(getattr(jsol, {**FIELDS, **BARRIER}[name]))
        if name in ("iterations", "status"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("name,solver,iters", [
    ("euler_attitude", "CLDDP", 6),
    ("quaternion_attitude", "IPDDP", 6),
    ("mrp_attitude", "LogDDP", 6),
])
def test_mpc_fleet_matches_jax_batched_solve(name, solver, iters):
    """The MPC fleet's problem (N = 20) from four start attitudes at rest,
    the example's options at ``iters`` iterations, on each dispatch path."""
    jp = att_box(name, 20)
    x0 = x0_batch(name, 4, seed=21)
    jopts = ct.CDDPOptions(max_iterations=iters, tolerance=1e-5, acceptable_tolerance=1e-6)
    jsol = jbatched_solve(jp, x0, solver, jopts)
    p, opts = port_zoo_problem(jp), port_options(jopts)
    names = list(FIELDS) + (list(BARRIER) if solver != "CLDDP" else [])
    for engine in ("auto", "xla"):
        dispatch_log.reset()
        sol = batched_solve(p, torch.as_tensor(np.asarray(x0)), solver,
                            opts.replace(solve_engine=engine))
        assert not dispatch_log.launches  # CPU tensors: the plain versions
        assert_match(solution_to_numpy(sol), jsol, names)
    assert int(np.asarray(jsol.iterations_completed).max()) >= 3


def _slew(iterations):
    """The example's slew in both packages, as the example calls it."""
    jp = att_box("mrp_attitude", 200)
    jopts = ct.CDDPOptions(max_iterations=iterations, tolerance=1e-5,
                           acceptable_tolerance=1e-6)
    jsol = ct.solve(jp, "CLDDP", jopts, X0=jnp.tile(jp.x0, (201, 1)))
    p = port_zoo_problem(jp)
    sol = tt.solve(p, "CLDDP", port_options(jopts), X0=p.x0.expand(201, -1))
    return solution_to_numpy(sol), jsol


def test_example_slew_matches_jax_before_convergence():
    """Eight iterations of the example's slew (unbatched, X0 the tiled x0):
    the same status and iterations, X, U and cost within 1e-8."""
    got, jsol = _slew(8)
    assert_match(got, jsol, list(FIELDS))
    assert int(got["iterations"]) == 8 and int(got["status"]) == 0


@pytest.mark.slow
def test_example_slew_full():
    """The example's full 150 iterations: the same status; at the converged
    slew the two packages may exit an iteration apart (ROADMAP C.7), with
    costs equal to 1e-10 relative and trajectories within 1e-6."""
    got, jsol = _slew(150)
    assert int(got["status"]) == int(np.asarray(jsol.status_code))
    assert abs(int(got["iterations"]) - int(np.asarray(jsol.iterations_completed))) <= 1
    np.testing.assert_allclose(got["cost"], np.asarray(jsol.final_objective), rtol=1e-10)
    for key in ("X", "U"):
        np.testing.assert_allclose(got[key], np.asarray(getattr(jsol, FIELDS[key])),
                                   rtol=1e-6, atol=1e-6)
    assert float(np.linalg.norm(got["X"][-1])) < 0.05
