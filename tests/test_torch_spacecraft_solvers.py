"""The other spacecraft models' solves through the port against the JAX
package (CPU, float64): CLDDP, IPDDP and LogDDP at the MPC horizon N = 20
against the JAX ``batched_solve`` (statuses and iteration counts equal; X,
U and cost within 1e-8) on both of the port's dispatch paths, one model
each; the nonlinear model's CLDDP is past the JAX gate of kernel 3 there,
so its default route is the per-pass one too. Apart from the model tests
(``tests/test_torch_spacecraft.py``) because the JAX drivers' tracing and
compiling take most of the time of each."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
from cddp_tpu.parallel.batch import batched_solve as jbatched_solve
from cddp_tpu_torch.interop import solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log
from cddp_tpu_torch.parallel.batch import batched_solve
from test_torch_ipddp import port_options
from test_torch_spacecraft import sc_box, x0_batch
from test_torch_zoo import port_zoo_problem

torch.set_num_threads(1)

SOLVE_TOL = dict(rtol=1e-8, atol=1e-8)
# --- solves -------------------------------------------------------------------------

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
            np.testing.assert_allclose(g, w, err_msg=name, **SOLVE_TOL)


@pytest.mark.parametrize("name,solver,horizon,iters", [
    ("sc_linear_fuel", "IPDDP", 20, 5),
    ("sc_nonlinear", "CLDDP", 20, 5),  # past the gates of kernel 3: per pass
    ("sc_landing2d", "LogDDP", 20, 5),
    ("sc_twobody", "CLDDP", 20, 5),
])
def test_fleet_matches_jax_batched_solve(name, solver, horizon, iters):
    """The MPC fleet's problem (``chip_smoke.sc_problem``) from four x0 of
    its spread, the fleets' options at ``iters`` iterations, on each
    dispatch path (the whole-solve dispatch, which CPU tensors take to the
    plain drivers kernels 3, 7 and 9 are held to, and the per-pass engine,
    ``solve_engine="xla"``)."""
    jp = sc_box(name, horizon)
    x0 = x0_batch(name, 4, seed=21)
    jopts = ct.CDDPOptions(max_iterations=iters, tolerance=1e-4)
    jsol = jbatched_solve(jp, jnp.asarray(x0), solver, jopts)
    p, opts = port_zoo_problem(jp), port_options(jopts)
    names = list(FIELDS) + (list(BARRIER) if solver != "CLDDP" else [])
    for engine in ("auto", "xla"):
        dispatch_log.reset()
        sol = batched_solve(p, torch.as_tensor(x0), solver, opts.replace(solve_engine=engine))
        assert not dispatch_log.launches  # CPU tensors: the plain versions
        assert_match(solution_to_numpy(sol), jsol, names)
    assert int(np.asarray(jsol.iterations_completed).max()) >= 3


