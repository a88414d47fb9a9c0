"""Problem data in and solutions out as numpy arrays.

This is how a problem built elsewhere (for instance by the JAX package,
through ``np.asarray`` of its fields) enters the port, and how solutions are
compared field by field. The port itself never sees a jax array.
"""

from __future__ import annotations

import numpy as np
import torch

from cddp_tpu_torch.constraints.path import ControlConstraint
from cddp_tpu_torch.costs.objective import QuadraticObjective
from cddp_tpu_torch.models.unicycle import Unicycle
from cddp_tpu_torch.problem import Problem

# Model name -> constructor from (parameter vector, integrator).
_MODELS = {
    "Unicycle": lambda params, integrator: Unicycle(integration_type=integrator),
}


def problem_from_arrays(model_name: str, model_params, Q, R, Qf, goal, lower,
                        upper, x0, horizon: int, timestep: float,
                        integrator: str, *, device, dtype) -> Problem:
    """Build a CLDDP problem from numpy arrays. ``Q`` and ``R`` are already
    dt-prescaled (as ``QuadraticObjective`` stores them) and go in as given;
    ``lower``/``upper`` None means no control box."""
    try:
        make_model = _MODELS[model_name]
    except KeyError as e:
        raise ValueError(f"model {model_name!r} is not ported; "
                         f"available: {sorted(_MODELS)}") from e
    t = lambda a: torch.as_tensor(np.array(a), device=device, dtype=dtype)  # noqa: E731
    objective = QuadraticObjective(Q=t(Q), R=t(R), Qf=t(Qf), reference_state=t(goal))
    constraints = {}
    if lower is not None:
        constraints["ControlConstraint"] = ControlConstraint(lower=t(lower), upper=t(upper))
    return Problem(
        model=make_model(np.asarray(model_params), integrator),
        objective=objective, x0=t(x0), horizon=int(horizon),
        timestep=float(timestep), constraints=constraints,
    )


def solution_to_numpy(sol) -> dict:
    """The fields a parity check compares, as numpy arrays."""
    f = lambda v: v.detach().cpu().numpy()  # noqa: E731
    return {
        "X": f(sol.state_trajectory),
        "U": f(sol.control_trajectory),
        "k": f(sol.feedforward_gains),
        "K": f(sol.feedback_gains),
        "cost": f(sol.final_objective),
        "inf_du": f(sol.inf_du),
        "reg": f(sol.final_regularization),
        "alpha_pr": f(sol.final_step_length),
        "iterations": f(sol.iterations_completed),
        "status": f(sol.status_code),
    }
