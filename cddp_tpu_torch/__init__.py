"""cddp_tpu_torch — the PyTorch + CUDA port of ``cddp_tpu``.

Batch-first CLDDP with a control box; IPDDP with every path-constraint type
of the JAX package (boxes, keep-out balls, linear, pole, cone and thrust
constraints), or none, and both terminal types (linear inequalities A x_N <= b and
equalities x_N = target); LogDDP and MSIPDDP with control and state boxes;
over the unicycle, the pendulum, the cart-pole, the
Hill-Clohessy-Wiltshire spacecraft, the forklift, the discrete car, any
discrete linear system (``LTISystem``, ``lti_system``) and the quadrotor
with rotor-force or body-rate controls (``Quadrotor``, ``quadrotor``,
``QuadrotorRate``), the rigid-body attitude trio under body torques
(``EulerAttitude``, ``QuaternionAttitude``, ``MrpAttitude`` and their
factories), the other spacecraft models (``SpacecraftLinearFuel``,
``SpacecraftNonlinear``, ``SpacecraftLanding2D``, ``SpacecraftTwobody``), the
small models of the JAX registry (``Bicycle``, ``DubinsCar``,
``DreyfusRocket``, ``Acrobot``; all in ``cddp_tpu_torch.models``, the
attitude conversions in
``cddp_tpu_torch.utils.rotations``), as the JAX package solves them,
towards a goal or along a per-step reference trajectory
(``reference_states``), or with a nonlinear least-squares cost
(``ResidualObjective``, Gauss-Newton derivatives; its tensors may carry
one row per instance) or any cost by AD (``NonlinearObjective``); and
batch-first receding-horizon MPC
(``make_mpc_controller``), warm-started from a trajectory or from the
interior-point solvers' state (``IPDDPSolverState``,
``MSIPDDPSolverState``), and the float64 ``polish`` of a float32 fleet.
Hand-written CUDA kernels for NVIDIA Hopper (``ops/csrc/``): for CLDDP the
Riccati backward pass, the line-search rollout and the whole solve; for
IPDDP the open-loop rollout (which seeds every barrier solver), the
interior-point forward pass, the condensed backward and the whole solve
(box and keep-out-ball stacks, with the "auto" stall latch, and terminal
constraints on the control box); the whole LogDDP and MSIPDDP solves. Each
kernel is instantiated for the models and stacks its wrapper's table names;
other problems run the plain driver. Users add model, cost and
Gauss-Newton lanes with their own CUDA structs (``ip_rollout.
register_model_lane``, ``register_cost_lane``, ``mega_ipddp.
register_gn_cost_lane``): kernels 4, 5 and 7 are built for them at first
use (the MPCC racing example, ``examples/mpcc_lib_torch.py``). A discrete model (the car) steps its
exact map in place of an integrator in every kernel that steps a model
(the rollouts and the interior-point forward pass); the whole solves
refuse it, as the JAX package's do. CUDA tensors run the kernels; CPU
tensors run their plain PyTorch versions. The builders put tensors on the
CUDA card unless given ``device``. The kernels are built with ``nvcc`` at
first use, never at import.
"""

from cddp_tpu_torch.constraints.path import (
    BallConstraint,
    ControlConstraint,
    LinearConstraint,
    MaxThrustMagnitudeConstraint,
    PathConstraint,
    PoleConstraint,
    SecondOrderConeConstraint,
    StateConstraint,
    ThrustMagnitudeConstraint,
    ball_constraint,
    control_constraint,
    linear_constraint,
    max_thrust_magnitude_constraint,
    pole_constraint,
    second_order_cone_constraint,
    state_constraint,
    thrust_magnitude_constraint,
)
from cddp_tpu_torch.constraints.terminal import (
    TerminalConstraint,
    TerminalEqualityConstraint,
    TerminalInequalityConstraint,
    terminal_equality_constraint,
    terminal_inequality_constraint,
)
from cddp_tpu_torch.costs.objective import (NonlinearObjective, Objective, QuadraticObjective,
                                            ResidualObjective, quadratic_objective)
from cddp_tpu_torch.models import (Acrobot, Bicycle, Car, DreyfusRocket, DubinsCar,
                                   EulerAttitude, Forklift, LTISystem, MrpAttitude, Quadrotor,
                                   QuadrotorRate, QuaternionAttitude, SpacecraftLanding2D,
                                   SpacecraftLinearFuel, SpacecraftNonlinear, SpacecraftTwobody,
                                   euler_attitude, lti_system, mrp_attitude, quadrotor,
                                   quaternion_attitude)
from cddp_tpu_torch.options import (
    BarrierOptions,
    BarrierStrategy,
    CDDPOptions,
    IPDDPOptions,
    LogBarrierOptions,
    MSIPDDPOptions,
    MultiShootingOptions,
)
from cddp_tpu_torch.parallel.batch import MPCState, batched_solve, make_mpc_controller
from cddp_tpu_torch.problem import Problem, problem
from cddp_tpu_torch.refine import polish
from cddp_tpu_torch.solution import Solution, Status
from cddp_tpu_torch.solvers.ipddp import IPDDPSolverState
from cddp_tpu_torch.solvers.msipddp import MSIPDDPSolverState

__all__ = [
    "BallConstraint", "BarrierOptions", "BarrierStrategy", "CDDPOptions", "Car",
    "Forklift", "LTISystem", "lti_system", "Quadrotor", "QuadrotorRate", "quadrotor",
    "EulerAttitude", "MrpAttitude", "QuaternionAttitude", "euler_attitude", "mrp_attitude",
    "quaternion_attitude", "SpacecraftLanding2D", "SpacecraftLinearFuel", "SpacecraftNonlinear",
    "SpacecraftTwobody", "Acrobot", "Bicycle", "DreyfusRocket", "DubinsCar",
    "ControlConstraint", "IPDDPOptions", "IPDDPSolverState", "MSIPDDPSolverState", "LinearConstraint", "LogBarrierOptions",
    "MPCState", "MSIPDDPOptions", "MaxThrustMagnitudeConstraint", "MultiShootingOptions",
    "NonlinearObjective", "Objective", "PathConstraint", "PoleConstraint", "Problem",
    "QuadraticObjective", "ResidualObjective",
    "SecondOrderConeConstraint", "Solution", "StateConstraint", "Status",
    "TerminalConstraint", "TerminalEqualityConstraint", "TerminalInequalityConstraint",
    "ThrustMagnitudeConstraint", "ball_constraint", "batched_solve",
    "control_constraint", "linear_constraint", "make_mpc_controller",
    "max_thrust_magnitude_constraint",
    "pole_constraint", "polish", "problem", "quadratic_objective", "second_order_cone_constraint",
    "solve", "state_constraint", "terminal_equality_constraint",
    "terminal_inequality_constraint", "thrust_magnitude_constraint",
]


def solve(problem, solver_type: str = "CLDDP", options=None, **kw):
    """Dispatch by solver name (CDDP::solve(string), cddp_core.cpp:235-270)."""
    from cddp_tpu_torch.solvers import get_solver

    return get_solver(solver_type)(
        problem, options if options is not None else CDDPOptions(), **kw)
