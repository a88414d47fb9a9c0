"""The small models' solves through the port against the JAX package (CPU,
float64): CLDDP, IPDDP, LogDDP and MSIPDDP at the MPC horizon N = 20
against the JAX ``batched_solve`` (statuses and iteration counts equal; X,
U and cost within 1e-8, the barrier solvers' residuals and mu too) on both
of the port's dispatch paths, one model each; MSIPDDP over
``chip_smoke.MS_EXACT_ITERS`` iterations (its filter forks at roundoff
ties past them, ROADMAP C.1). Apart from the model tests
(``tests/test_torch_ground_models.py``) because the JAX drivers' tracing
and compiling take most of the time of each."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cddp_tpu as ct
from cddp_tpu.parallel.batch import batched_solve as jbatched_solve
from cddp_tpu_torch.interop import solution_to_numpy
from cddp_tpu_torch.ops.kernels import dispatch_log
from cddp_tpu_torch.parallel.batch import batched_solve
from test_torch_ground_models import small_box, x0_batch
from test_torch_ipddp import port_options
from test_torch_spacecraft_solvers import BARRIER, FIELDS, assert_match
from test_torch_zoo import port_zoo_problem

torch.set_num_threads(1)


@pytest.mark.parametrize("name,solver,iters", [
    ("bicycle", "CLDDP", 5),
    ("dubins_car", "IPDDP", 5),
    ("dreyfus_rocket", "LogDDP", 5),  # seeded off zero thrust angle
    ("acrobot", "MSIPDDP", chip_smoke.MS_EXACT_ITERS),
])
def test_fleet_matches_jax_batched_solve(name, solver, iters):
    """The MPC fleet's problem (``chip_smoke.small_problem``) from four x0 of
    its spread and the box's midpoint (``chip_smoke.box_midpoint``), the
    fleets' options at ``iters`` iterations, on each dispatch path (the
    whole-solve dispatch, which CPU tensors take to the plain drivers
    kernels 3, 7, 8 and 9 are held to, and the per-pass engine,
    ``solve_engine="xla"``)."""
    jp = small_box(name, 20)
    x0 = x0_batch(name, 4, seed=21)
    p = port_zoo_problem(jp)
    U0 = chip_smoke.box_midpoint(p, 4)
    jopts = ct.CDDPOptions(max_iterations=iters, tolerance=1e-4)
    jsol = jbatched_solve(jp, jnp.asarray(x0), solver, jopts, U0_batch=jnp.asarray(U0.numpy()))
    opts = port_options(jopts)
    names = list(FIELDS) + (list(BARRIER) if solver != "CLDDP" else [])
    for engine in ("auto", "xla"):
        dispatch_log.reset()
        sol = batched_solve(p, torch.as_tensor(x0), solver, opts.replace(solve_engine=engine),
                            U0_batch=U0)
        assert not dispatch_log.launches  # CPU tensors: the plain versions
        assert_match(solution_to_numpy(sol), jsol, names)
    assert int(np.asarray(jsol.iterations_completed).max()) >= 3
