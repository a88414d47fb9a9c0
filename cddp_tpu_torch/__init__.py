"""cddp_tpu_torch — the PyTorch + CUDA port of ``cddp_tpu``.

Batch-first CLDDP with a control box over the unicycle, as the JAX package
solves it, plus hand-written CUDA kernels for NVIDIA Hopper
(``ops/csrc/``): the Riccati backward pass, the line-search rollout and the
whole solve. CUDA tensors run the kernels; CPU tensors run their plain
PyTorch versions. The kernels are built with ``nvcc`` at first use, never at
import.
"""

from cddp_tpu_torch.constraints.path import ControlConstraint, control_constraint
from cddp_tpu_torch.costs.objective import QuadraticObjective, quadratic_objective
from cddp_tpu_torch.options import CDDPOptions
from cddp_tpu_torch.parallel.batch import batched_solve
from cddp_tpu_torch.problem import Problem, problem
from cddp_tpu_torch.solution import Solution, Status

__all__ = [
    "CDDPOptions", "ControlConstraint", "Problem", "QuadraticObjective",
    "Solution", "Status", "batched_solve", "control_constraint", "problem",
    "quadratic_objective", "solve",
]


def solve(problem, solver_type: str = "CLDDP", options=None, **kw):
    """Dispatch by solver name (CDDP::solve(string), cddp_core.cpp:235-270)."""
    from cddp_tpu_torch.solvers import get_solver

    return get_solver(solver_type)(
        problem, options if options is not None else CDDPOptions(), **kw)
