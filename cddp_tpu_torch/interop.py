"""Problem data and options in, solutions out, as plain values.

This is how a problem built elsewhere (for instance by the JAX package,
through ``np.asarray`` of its fields and ``dataclasses.asdict`` of its
options) enters the port, and how solutions are compared field by field.
The port itself never sees a jax array.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from cddp_tpu_torch import devices
from cddp_tpu_torch.constraints import path, terminal
from cddp_tpu_torch.costs.objective import QuadraticObjective
from cddp_tpu_torch.models import (HCW, Acrobot, Bicycle, Car, CartPole, DreyfusRocket,
                                   DubinsCar, EulerAttitude, Forklift, LTISystem, MrpAttitude,
                                   Pendulum, Quadrotor, QuadrotorRate, QuaternionAttitude,
                                   SpacecraftLanding2D, SpacecraftLinearFuel, SpacecraftNonlinear,
                                   SpacecraftTwobody, Unicycle)
from cddp_tpu_torch.models.attitude import _RigidBody
from cddp_tpu_torch.options import CDDPOptions
from cddp_tpu_torch.problem import Problem

# Model name (the JAX package's class name) -> (builder from the parameter
# list, the problem's timestep, nx and nu; its parameter count from nx and
# nu). The parameter vector is the model registry's, in the JAX lane order
# (``ops/kernels/rollout.py::_REGISTRY``): the pendulum's (length, mass,
# damping, gravity), the cart-pole's (cart_mass, pole_mass, pole_length,
# gravity, damping), HCW's (mean_motion, mass), the car's (wheelbase; its
# timestep is the problem's), the forklift's (wheelbase, steer_sign, -1
# rear-steered), the quadrotor's (mass, arm_length, gravity, inertia (9,
# row-major)), QuadrotorRate's (mass, gravity), the attitude trio's
# inertia (9, row-major), SpacecraftLinearFuel's (mean_motion, isp, g0,
# epsilon), SpacecraftNonlinear's (mass, mu), SpacecraftLanding2D's (mass,
# length, max_thrust, gravity, inertia: the last must be the model's own
# (1/12) m L^2), SpacecraftTwobody's (mu, mass), the bicycle's (wheelbase),
# DubinsCar's (speed), DreyfusRocket's (thrust_acceleration,
# gravity_acceleration), the acrobot's (l1, l2, m1, m2, J1, J2, gravity,
# friction); the unicycle has none. An
# LTISystem, which has no lane, takes its discrete A (nx, nx) and B (nx,
# nu) flattened and concatenated.
_MODELS = {
    "Unicycle": (lambda p, dt, nx, nu: Unicycle(), lambda nx, nu: 0),
    "Pendulum": (lambda p, dt, nx, nu: Pendulum(*p), lambda nx, nu: 4),
    "CartPole": (lambda p, dt, nx, nu: CartPole(*p), lambda nx, nu: 5),
    "HCW": (lambda p, dt, nx, nu: HCW(*p), lambda nx, nu: 2),
    "Car": (lambda p, dt, nx, nu: Car(p[0], timestep=dt), lambda nx, nu: 1),
    "Forklift": (lambda p, dt, nx, nu: Forklift(p[0], rear_steer=p[1] < 0.0),
                 lambda nx, nu: 2),
    "Quadrotor": (lambda p, dt, nx, nu: Quadrotor(
        mass=p[0], arm_length=p[1], gravity=p[2], inertia=np.reshape(p[3:], (3, 3)),
        device="cpu"), lambda nx, nu: 12),
    "QuadrotorRate": (lambda p, dt, nx, nu: QuadrotorRate(mass=p[0], gravity=p[1],
                                                          device="cpu"),
                      lambda nx, nu: 2),
    **{cls.__name__: (lambda p, dt, nx, nu, cls=cls: cls(np.reshape(p, (3, 3)), device="cpu"),
                      lambda nx, nu: 9)
       for cls in (EulerAttitude, QuaternionAttitude, MrpAttitude)},
    "SpacecraftLinearFuel": (lambda p, dt, nx, nu: SpacecraftLinearFuel(*p),
                             lambda nx, nu: 4),
    "SpacecraftNonlinear": (lambda p, dt, nx, nu: SpacecraftNonlinear(mass=p[0], mu=p[1]),
                            lambda nx, nu: 2),
    "SpacecraftLanding2D": (lambda p, dt, nx, nu: _landing2d(p), lambda nx, nu: 5),
    "SpacecraftTwobody": (lambda p, dt, nx, nu: SpacecraftTwobody(*p), lambda nx, nu: 2),
    "Bicycle": (lambda p, dt, nx, nu: Bicycle(*p), lambda nx, nu: 1),
    "DubinsCar": (lambda p, dt, nx, nu: DubinsCar(*p), lambda nx, nu: 1),
    "DreyfusRocket": (lambda p, dt, nx, nu: DreyfusRocket(*p), lambda nx, nu: 2),
    "Acrobot": (lambda p, dt, nx, nu: Acrobot(*p), lambda nx, nu: 8),
    "LTISystem": (lambda p, dt, nx, nu: LTISystem(
        torch.tensor(p[:nx * nx], dtype=torch.float64).reshape(nx, nx),
        torch.tensor(p[nx * nx:], dtype=torch.float64).reshape(nx, nu), dt),
        lambda nx, nu: nx * nx + nx * nu),
}


def _landing2d(p) -> SpacecraftLanding2D:
    """The lander from its lane vector (mass, length, max_thrust, gravity,
    inertia); raises when the inertia is not the model's (1/12) m L^2."""
    model = SpacecraftLanding2D(*p[:4])
    if float(model.inertia) != p[4]:
        raise ValueError(f"SpacecraftLanding2D: inertia {p[4]!r} is not (1/12) m L^2 = "
                         f"{float(model.inertia)!r}")
    return model


_BOXES = {"control": path.ControlConstraint, "state": path.StateConstraint}
# The other path-constraint types, by the JAX package's type names; each is
# built from its fields, which carry the JAX type's names.
_PATH = {cls.__name__: cls for cls in (
    path.BallConstraint, path.LinearConstraint, path.PoleConstraint,
    path.SecondOrderConeConstraint, path.ThrustMagnitudeConstraint,
    path.MaxThrustMagnitudeConstraint)}
_TERMINAL = {cls.__name__: cls for cls in (
    terminal.TerminalEqualityConstraint, terminal.TerminalInequalityConstraint)}


def problem_from_arrays(model_name: str, model_params, Q, R, Qf, goal, lower,
                        upper, x0, horizon: int, timestep: float,
                        integrator: str, *, device, dtype, boxes=None,
                        constraints=None, reference_states=None,
                        terminal_constraints=None) -> Problem:
    """Build a problem from numpy arrays. ``model_params`` is the model's
    parameter vector in the registry's order (``_MODELS``; an LTISystem's
    A and B, on ``device``). ``Q`` and ``R``
    are already dt-prescaled (as ``QuadraticObjective`` stores them) and go
    in as given;
    ``lower``/``upper`` None means no "ControlConstraint" box. ``boxes`` maps
    further constraint names to ("control" | "state", lower, upper,
    scale_factor); ``constraints`` maps names to (type name, fields): a
    type of ``_PATH`` and its fields, arrays becoming tensors and Python
    numbers staying as they are, for example ("BallConstraint",
    {"radius": np.asarray(0.4), "center": np.asarray([1.0, 1.0]),
    "scale_factor": 1.0}). ``terminal_constraints`` maps names to (type
    name, fields) in the same form, for the two terminal types, for example
    ("TerminalInequalityConstraint", {"A": ..., "b": ...}) or
    ("TerminalEqualityConstraint", {"target_state": ...}).
    ``reference_states`` (N or N+1, nx) makes the objective track it
    (``QuadraticObjective.reference_states``)."""
    try:
        make_model, n_of = _MODELS[model_name]
    except KeyError as e:
        raise ValueError(f"model {model_name!r} is not ported; the ported "
                         f"models: {sorted(_MODELS)}") from e
    params = np.asarray(model_params, dtype=np.float64).reshape(-1).tolist()
    nx, nu = np.shape(Q)[0], np.shape(R)[0]
    n_params = n_of(nx, nu)
    if len(params) != n_params:
        raise ValueError(f"model {model_name!r} takes {n_params} parameters, "
                         f"got {len(params)}")
    t = lambda a: torch.as_tensor(np.array(a), device=device, dtype=dtype)  # noqa: E731
    objective = QuadraticObjective(
        Q=t(Q), R=t(R), Qf=t(Qf), reference_state=t(goal),
        reference_states=None if reference_states is None else t(reference_states))
    items = {}
    if lower is not None:
        items["ControlConstraint"] = path.ControlConstraint(lower=t(lower), upper=t(upper))
    for name, (kind, lo, hi, scale) in (boxes or {}).items():
        items[name] = _BOXES[kind](lower=t(lo), upper=t(hi), scale_factor=float(scale))
    def build(types, specs):
        out = {}
        for name, (kind, fields) in (specs or {}).items():
            if kind not in types:
                raise ValueError(f"constraint type {kind!r} is not ported; "
                                 f"available: {sorted(types)}")
            out[name] = types[kind](**{
                k: v if isinstance(v, (bool, int, float)) else t(v) for k, v in fields.items()})
        return out

    items.update(build(_PATH, constraints))
    model = make_model(params, float(timestep), nx, nu)
    if isinstance(model, (LTISystem, Quadrotor, QuadrotorRate, _RigidBody)):
        # A and B, the inertia: tensors the solve reads on its device.
        model = model.to(device)
    model.integration_type = integrator
    return Problem(
        model=model,
        objective=objective, x0=t(x0), horizon=int(horizon),
        timestep=float(timestep), constraints=items,
        terminal_constraints=build(_TERMINAL, terminal_constraints),
    )


def options_from_dict(values: dict, cls=CDDPOptions):
    """Options from a nested dict of plain values (``dataclasses.asdict`` of
    an option tree; enums may be given by value). Keys the port's option
    tree does not have are dropped."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        default = getattr(cls(), f.name)
        if dataclasses.is_dataclass(default):
            v = options_from_dict(v, type(default))
        elif isinstance(default, enum.Enum):
            v = type(default)(getattr(v, "value", v))
        kw[f.name] = v
    return cls(**kw)


def solver_state_from_arrays(state, device=None, dtype=None):
    """A solver state built elsewhere (the JAX package's IPDDPSolverState or
    MSIPDDPSolverState, whose fields are numpy or array-likes, unbatched or
    with one leading batch axis) as the port's state of the same solver and
    layout, on ``device`` (the CUDA card when None): an IPDDP state has x0,
    an MSIPDDP state F."""
    from cddp_tpu_torch.solvers.ipddp import IPDDPSolverState
    from cddp_tpu_torch.solvers.msipddp import MSIPDDPSolverState

    fields = getattr(state, "_fields", ())
    cls = (IPDDPSolverState if "x0" in fields else
           MSIPDDPSolverState if "F" in fields else None)
    if cls is None:
        raise TypeError(f"not an IPDDP or MSIPDDP solver state: {type(state).__name__}")
    dev = devices.resolve(device)
    return cls(*(torch.as_tensor(np.array(getattr(state, f)), device=dev, dtype=dtype)
                 for f in cls._fields))


def track_from_arrays(cls, arrays, *, device, dtype=torch.float64):
    """A track built elsewhere (the JAX package's ``mpcc_lib.Track`` or
    ``LocalTrack``: their fields as numpy arrays, by name) as an instance
    of the port's dataclass ``cls`` with the same fields
    (``examples/mpcc_lib_torch.py``: the Fourier matrix, the samples, the
    width and the length, or a window's coefficients, center, halfwidth,
    width and length), on ``device`` in ``dtype``, so that both packages
    read the same track. Raises on a missing field."""
    missing = [f.name for f in dataclasses.fields(cls) if f.name not in arrays]
    if missing:
        raise ValueError(f"{cls.__name__}: missing fields {missing}")
    return cls(**{f.name: torch.as_tensor(np.array(arrays[f.name]), device=device, dtype=dtype)
                  for f in dataclasses.fields(cls)})


def solution_to_numpy(sol, state=None) -> dict:
    """The fields a parity check compares, as numpy arrays. Solutions of the
    barrier solvers add mu and inf_pr (LogDDP: the violation), the
    interior-point ones the stacked duals Y and slacks S (path-constraint
    names in sorted order), the costates and inf_comp, and with terminal
    constraints the stacked terminal duals Y_T, slacks S_T and equality
    multipliers Lambda_T_eq (names in sorted order; width 0 where a group
    is empty). A solver ``state`` adds its gains, duals, slacks and
    costates (k, K, Y, S, Lambda), an MSIPDDP state its shooting-node
    values F, an IPDDP state its terminal state (Y_T, S_T, Lambda_T_eq) and
    x0."""
    f = lambda v: v.detach().cpu().numpy()  # noqa: E731
    out = {
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
    for key, v in (("mu", sol.barrier_mu), ("inf_pr", sol.inf_pr),
                   ("inf_comp", sol.inf_comp), ("Lambda", sol.costate_trajectory)):
        if v is not None:
            out[key] = f(v)
    if sol.dual_trajectories is not None:
        stack = lambda d: np.concatenate([f(d[k]) for k in sorted(d)], -1)  # noqa: E731
        out.update(Y=stack(sol.dual_trajectories), S=stack(sol.slack_trajectories))
    if sol.terminal_duals is not None:
        ineq = sorted(sol.terminal_slacks)
        eq = sorted(set(sol.terminal_duals) - set(ineq))
        cat = lambda d, names: np.concatenate(  # noqa: E731
            [f(d[k]) for k in names] or [f(sol.final_objective)[..., None][..., :0]], -1)
        out.update(Y_T=cat(sol.terminal_duals, ineq), S_T=cat(sol.terminal_slacks, ineq),
                   Lambda_T_eq=cat(sol.terminal_duals, eq))
    if state is not None:
        out.update({key: f(getattr(state, field)) for key, field in (
            ("k", "k_u"), ("K", "K_u"), ("Y", "Y"), ("S", "S"), ("Lambda", "Lambda"),
            ("F", "F"), ("Y_T", "Y_T"), ("S_T", "S_T"), ("Lambda_T_eq", "Lambda_T_eq"),
            ("x0", "x0")) if hasattr(state, field)})
    return out
