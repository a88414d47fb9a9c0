"""Closed-loop line-search rollout: CUDA kernel, plain version and the model
registry the kernels read.

Replaces ``cddp_tpu/ops/pallas/rollout.py::make_forward_kernel``. One
rollout applies u = clamp(Ub + alpha*k + K (x - Xb)), accumulates the
quadratic running and terminal cost and takes one explicit integrator step
per time step. The CUDA kernel (``ops/csrc/forward_rollout.cu``) gives each
problem instance one thread; trajectories are batch-last in device memory.

**The model registry.** One table, keyed by the exact torch model class.
Each entry gives the model's parameter vector, ``cuda_name`` and whether
the model is ``discrete``: the model's struct in ``ops/csrc/models.cuh``
holds its device functions ``f`` (the continuous dynamics) and ``fxfu``
(their Jacobians), or for a discrete model (the car) ``step``, its exact
map, which the kernels take in place of an integrator step
(rollout.py:680-683 of the JAX package). The kernel
launchers built for it are exported as ``cddp_<kernel>_<cuda_name>_<f32|f64>``
(the Riccati kernel, which needs no model, as ``..._<nx>x<nu>_...``). A model
that is not in the table is not eligible for the kernels: its problems run
the plain driver on the tensors' device. A registered model is eligible for
a kernel only where that kernel is instantiated for it: each kernel's
module keeps that table (``ROLLOUT_MODELS`` here for kernel 2, ``CLDDP_MODELS``
for kernel 3, ``CLDDP_TRACK_MODELS`` for the tracking forms of both,
``riccati.KERNEL_SHAPES``, ``ip_rollout.KERNEL_ROWS``, ``mega_ipddp.BOX_ROWS``,
``ipddp_riccati.KERNEL_SHAPES``, the layouts of ``mega_ipddp``), and a
problem outside it runs the plain version of that kernel, on the tensors'
device, before any launch is tried. Launches of a model other than the
unicycle log the model's name after the kernel's (``clddp_solve@pendulum``,
``LaneConsts.tag``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from cddp_tpu_torch.models import (HCW, Car, CartPole, DynamicalSystem, EulerAttitude,
                                   Forklift, MrpAttitude, Pendulum, Quadrotor, QuadrotorRate,
                                   QuaternionAttitude, Unicycle)
from cddp_tpu_torch.ops.kernels import dispatch_log
from cddp_tpu_torch.ops.linalg import true_div

INTEGRATORS = ("euler", "heun", "rk3", "rk4")  # kernel codes 0..3
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_double)]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@dataclass(frozen=True)
class ModelEntry:
    params: Callable[[DynamicalSystem], List[float]]  # the JAX lane's parameter vector
    cuda_name: str
    discrete: bool = False  # the struct's exact map ``step`` replaces the integrator

    @property
    def tag(self) -> str:
        """What a launch's ``dispatch_log`` name carries after the kernel's:
        "" for the unicycle, "@<cuda_name>" for every other model."""
        return "" if self.cuda_name == "unicycle" else "@" + self.cuda_name

    def kernel_params(self, model: DynamicalSystem) -> List[float]:
        """The struct's parameter vector ``p`` (its NP values): the lane
        vector; the quadrotor's struct reads the plain model's own hoisted
        inverse inertia after it (models.cuh::Quadrotor), the attitude
        models' the plain model's LU factors of the inertia and its 0-based
        pivots (models.cuh::RigidBody)."""
        out = [float(v) for v in self.params(model)]
        if isinstance(model, Quadrotor):
            out += model.inertia_inverse().reshape(-1).tolist()
        if isinstance(model, (EulerAttitude, QuaternionAttitude, MrpAttitude)):
            LU, piv = model.lu_factors()
            out += LU.reshape(-1).tolist() + [float(v - 1) for v in piv.tolist()]
        return out


def _inertia(model) -> List[float]:
    """The inertia's nine entries, row-major."""
    return model.inertia.reshape(-1).tolist()


def _buffers(*names):
    """The parameter vector: the model's scalar buffers in the JAX lane
    order (rollout.py:138-203 of the JAX package)."""
    return lambda model: [float(getattr(model, n)) for n in names]


_REGISTRY = {
    Unicycle: ModelEntry(params=_buffers(), cuda_name="unicycle"),
    Pendulum: ModelEntry(params=_buffers("length", "mass", "damping", "gravity"),
                         cuda_name="pendulum"),
    CartPole: ModelEntry(params=_buffers("cart_mass", "pole_mass", "pole_length", "gravity",
                                         "damping"), cuda_name="cartpole"),
    HCW: ModelEntry(params=_buffers("mean_motion", "mass"), cuda_name="hcw"),
    Car: ModelEntry(params=_buffers("wheelbase"), cuda_name="car", discrete=True),
    Forklift: ModelEntry(params=lambda m: [float(m.wheelbase), m.steer_sign],
                         cuda_name="forklift"),
    # [mass, arm_length, gravity, I (9, row-major)] (rollout.py:161-169); the
    # struct also reads inv(I), the plain model's own hoisted inverse.
    Quadrotor: ModelEntry(
        params=lambda m: _buffers("mass", "arm_length", "gravity")(m)
        + m.inertia.reshape(-1).tolist(),
        cuda_name="quadrotor"),
    QuadrotorRate: ModelEntry(params=_buffers("mass", "gravity"), cuda_name="quadrotor_rate"),
    # I (9, row-major), the JAX lane's ``_inertia_params`` (rollout.py:547-553).
    # The struct does not invert I by the lane's adjugate (``_inv3_apply``,
    # :220-242), which rounds apart from the plain model's LU solve: it reads
    # the plain model's own LU factors after the lane vector
    # (``kernel_params``), so that kernel and plain version solve with one
    # factorization, term by term alike.
    EulerAttitude: ModelEntry(params=_inertia, cuda_name="euler_attitude"),
    QuaternionAttitude: ModelEntry(params=_inertia, cuda_name="quaternion_attitude"),
    MrpAttitude: ModelEntry(params=_inertia, cuda_name="mrp_attitude"),
}
# The attitude trio, which the whole solves of CLDDP, IPDDP and LogDDP
# (kernels 3, 7, 9) take at their users' MPC horizon (N = 20; the JAX
# package's gates admit them there), but not MSIPDDP's (kernel 8, whose JAX
# gate refuses them at N = 20: 15.6 and 18.2 MiB against 10), and not two
# float32 variants that fork from their plain drivers (ROADMAP C.12): kernel
# 3 on the MRP model and kernel 7 on the Euler model (``mega_ipddp``).
ATTITUDE_MODELS = ("euler_attitude", "quaternion_attitude", "mrp_attitude")
# The models the whole CLDDP solve (kernel 3) and the line-search rollout
# (kernel 2) are instantiated for in the tracking form, and kernel 3 in the
# goal form: those and the Euler and quaternion attitude models (no fleet
# of theirs tracks). The JAX whole solve refuses discrete models
# (mega_clddp.py:843 of the JAX package). The MRP model is left out: in
# float32 kernel 3 agreed with the plain driver on 97.41% of the plain
# driver's own stable instances at N = 20 (ROADMAP C.12), so its CLDDP
# runs per pass (kernels 1 and 2).
CLDDP_TRACK_MODELS = ("unicycle", "pendulum", "cartpole")
CLDDP_MODELS = CLDDP_TRACK_MODELS + ("euler_attitude", "quaternion_attitude")
# The models kernel 2's goal form is instantiated for: the tracking form's,
# the attitude trio, the car and the two quadrotors. Kernel 3 leaves the
# quadrotors out: the JAX package's whole CLDDP solve refuses them at the
# horizons their users run (its VMEM estimate at the golden's N = 60: 57.2
# MiB against a 12 MiB budget; QuadrotorRate 15.9 MiB already at N = 20),
# so their CLDDP runs per pass there, and here.
ROLLOUT_MODELS = CLDDP_TRACK_MODELS + ATTITUDE_MODELS + ("car", "quadrotor", "quadrotor_rate")
# The longest horizon at which the JAX package's whole solves of CLDDP,
# IPDDP and LogDDP (kernels 3, 7, 9) take each attitude model: their
# scratch-memory gates (mega_clddp.py:864, mega_ipddp.py:2527 and
# mega_logddp.py:788 of the JAX package; tests/test_torch_attitude.py
# holds this table to them). Past it JAX runs per pass, and so does the
# port (``whole_horizon_ok``): in float32, kernel 3 on the quaternion slew
# at N = 200 forked from its plain driver (97.58% of the plain driver's
# stable instances, ROADMAP C.12). The other models' whole solves keep no
# such limit (ROADMAP C.11).
WHOLE_MAX_HORIZON = {
    "clddp_solve": {"euler_attitude": 29, "quaternion_attitude": 25},
    "ipddp_solve": {"quaternion_attitude": 25, "mrp_attitude": 27},
    "logddp_solve": {"euler_attitude": 34, "quaternion_attitude": 30, "mrp_attitude": 34},
}


def whole_horizon_ok(kernel: str, lane: "LaneConsts", horizon: int) -> bool:
    """Whether ``WHOLE_MAX_HORIZON`` lets the whole-solve ``kernel`` take the
    lane's model at ``horizon``."""
    limit = WHOLE_MAX_HORIZON.get(kernel, {}).get(lane.entry.cuda_name)
    return limit is None or horizon <= limit


def model_entry(model: DynamicalSystem) -> Optional[ModelEntry]:
    """Registry entry for an exact registered class (a subclass keeps the
    plain path, so its overridden dynamics are honoured)."""
    return _REGISTRY.get(type(model))


@dataclass(frozen=True)
class LaneConsts:
    """Problem constants shared by every instance, in the form the kernels
    take them. ``lower``/``upper`` are None when controls are unclamped.
    ``refs`` is a tracking objective's running reference, rows 0..N-1 of
    ``reference_states`` as one contiguous (N, nx) tensor that the whole
    batch shares, or None for the goal form: the kernels take it as a
    device pointer beside the by-value constants (its size grows with N),
    and their tracking variants (launcher suffix ``_track``) read row t at
    step t."""

    model: DynamicalSystem
    entry: ModelEntry
    integrator: str
    dt: float
    Q: torch.Tensor  # dt-prescaled
    R: torch.Tensor  # dt-prescaled
    Qf: torch.Tensor
    goal: torch.Tensor
    lower: Optional[torch.Tensor]
    upper: Optional[torch.Tensor]
    refs: Optional[torch.Tensor] = None

    @property
    def variant(self) -> str:
        """The launcher suffix of the objective's form: "_track" or ""."""
        return "" if self.refs is None else "_track"

    @property
    def tag(self) -> str:
        """The model's ``dispatch_log`` suffix (``ModelEntry.tag``)."""
        return self.entry.tag

    @property
    def clddp(self) -> bool:
        """Whether kernel 3 is instantiated for the model and objective."""
        return self.entry.cuda_name in (CLDDP_MODELS if self.refs is None
                                        else CLDDP_TRACK_MODELS)

    @property
    def rollout(self) -> bool:
        """Whether kernel 2 is instantiated for the model and objective."""
        return self.entry.cuda_name in (ROLLOUT_MODELS if self.refs is None
                                        else CLDDP_TRACK_MODELS)

    def step(self, x, u, dt):
        """One step of the kernels' model lane (``lane_step``)."""
        return lane_step(self.model, self.entry, self.integrator, x, u, dt)

    def running_ref(self, t: int):
        """Step t's running reference: row t of ``refs``, or the goal."""
        return self.goal if self.refs is None else self.refs[t]

    def refs_ptr(self, like: torch.Tensor):
        """``refs`` as a kernel argument (NULL for the goal form); raises
        unless it lies on ``like``'s device in ``like``'s dtype, as the
        kernel reads it."""
        if self.refs is None:
            return None
        if self.refs.device != like.device or self.refs.dtype != like.dtype:
            raise ValueError(f"reference_states on {self.refs.device} {self.refs.dtype}, "
                             f"the kernel's inputs on {like.device} {like.dtype}")
        return ctypes.c_void_p(self.refs.data_ptr())

    @functools.cached_property
    def host(self) -> List[float]:
        """[dt, Q, R, Qf, goal, lower, upper, params] as the CUDA ``Consts``
        struct lays them out (one device-to-host copy per solve)."""
        nu = self.R.shape[0]
        lo = self.lower if self.lower is not None else self.R.new_zeros(nu)
        hi = self.upper if self.upper is not None else self.R.new_zeros(nu)
        flat = torch.cat([t.reshape(-1).double().cpu()
                          for t in (self.Q, self.R, self.Qf, self.goal, lo, hi)])
        return [self.dt] + flat.tolist() + self.entry.kernel_params(self.model)


def lane_integrator(model, entry: Optional[ModelEntry]) -> Optional[str]:
    """The stepper a registered model's lane takes: its integrator when that
    is one of the four explicit steppers, "euler" (unread) for a discrete
    model, whose exact map needs none (ip_rollout.py:227 of the JAX
    package); None when the model has no lane."""
    if entry is None:
        return None
    if entry.discrete:
        return "euler"
    return model.integration_type if model.integration_type in INTEGRATORS else None


def lane_consts(problem) -> Optional[LaneConsts]:
    """The kernels' view of a problem, or None when its model is not in the
    registry or has no lane (``lane_integrator``)."""
    entry = model_entry(problem.model)
    integrator = lane_integrator(problem.model, entry)
    if integrator is None:
        return None
    obj = problem.objective
    cc = problem.get_constraint("ControlConstraint")
    refs = obj.reference_states
    return LaneConsts(
        model=problem.model, entry=entry, integrator=integrator,
        dt=problem.timestep, Q=obj.Q, R=obj.R, Qf=obj.Qf,
        goal=obj.reference_state,
        lower=cc.lower if cc is not None else None,
        upper=cc.upper if cc is not None else None,
        refs=None if refs is None else refs[:problem.horizon].to(obj.Q.dtype).contiguous(),
    )


def integrate_lane(f, kind: str, x, u, dt):
    """One explicit step with the kernels' stage arithmetic
    (rollout.py:580-613 of the JAX package); ``dt`` is a 0-d tensor of the
    working dtype, as the kernels hold it."""
    if kind == "euler":
        return x + dt * f(x, u)
    k1 = f(x, u)
    if kind == "heun":
        k2 = f(x + dt * k1, u)
        return x + 0.5 * dt * (k1 + k2)
    if kind == "rk3":
        k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + dt * (2.0 * k2 - k1), u)
        return x + true_div(dt, 6.0) * (k1 + 4.0 * k2 + k3)
    if kind == "rk4":
        k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u)
        k4 = f(x + dt * k3, u)
        return x + true_div(dt, 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    raise ValueError(f"unknown integrator {kind!r}")


def lane_step(model, entry: ModelEntry, kind: str, x, u, dt):
    """One step of a registered model's lane: its exact discrete map for a
    discrete model (the kernels' ``Car::step``), else ``integrate_lane``
    over its continuous dynamics."""
    if entry.discrete:
        return model.discrete_dynamics(x, u, None, dt)
    return integrate_lane(lambda x_, u_: model(x_, u_, None), kind, x, u, dt)


def forward_rollout_plain(consts: LaneConsts, Xb, Ub, k, K, x0, alpha):
    """Port of ``rollout.py::_scan_forward_single`` (a discrete model
    steps its exact map, :901-902). Batch-first: Xb
    (B,N,nx) nominal states x_0..x_{N-1}, Ub/k (B,N,nu), K (B,N,nu,nx),
    x0 (B,nx), alpha (B,). Returns (X tail (B,N,nx) = x_1..x_N,
    U (B,N,nu), J (B,)). Step t's running cost tracks
    ``consts.running_ref(t)``, the terminal cost the goal."""
    N = Xb.shape[1]
    dt = torch.tensor(consts.dt, dtype=Xb.dtype, device=Xb.device)
    Q, R, Qf, goal = consts.Q, consts.R, consts.Qf, consts.goal
    a = alpha[:, None]
    x, J = x0, Xb.new_zeros(Xb.shape[0])
    xs, us = [], []
    for t in range(N):
        u = Ub[:, t] + a * k[:, t] + (K[:, t] @ (x - Xb[:, t])[..., None])[..., 0]
        if consts.lower is not None:
            u = torch.minimum(torch.maximum(u, consts.lower), consts.upper)
        e = x - consts.running_ref(t)
        J = J + ((e @ Q) * e).sum(-1) + ((u @ R) * u).sum(-1)
        x = consts.step(x, u, dt)
        xs.append(x)
        us.append(u)
    ef = x - goal
    return torch.stack(xs, 1), torch.stack(us, 1), J + ((ef @ Qf) * ef).sum(-1)


def forward_rollout(consts: LaneConsts, Xb, Ub, k, K, x0, alpha):
    """CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if Xb.device.type == "cpu":
        dispatch_log.plain("forward_rollout" + consts.variant + consts.tag, Xb.shape[0])
        return forward_rollout_plain(consts, Xb, Ub, k, K, x0, alpha)
    return _launch(consts, Xb, Ub, k, K, x0, alpha)


def _launch(consts: LaneConsts, Xb, Ub, k, K, x0, alpha):
    from cddp_tpu_torch.ops.kernels import build

    ins = (Xb, Ub, k, K, x0, alpha)
    Bsz, N, nx = Xb.shape
    nu = Ub.shape[-1]
    tag = build.dtype_tag("forward_rollout", ins, (
        (N, nx), (N, nu), (N, nu), (N, nu, nx), (nx,), ()))
    name = f"cddp_forward_rollout_{consts.entry.cuda_name}{consts.variant}_{tag}"
    fn = build.function(name, _ARGTYPES)
    last = [t.movedim(0, -1).contiguous() for t in ins]
    X = Xb.new_empty(N, nx, Bsz)
    U = Xb.new_empty(N, nu, Bsz)
    J = Xb.new_empty(Bsz)
    err = fn(*(build.ptr(t) for t in last + [X, U, J]), consts.refs_ptr(Xb),
             build.doubles(consts.host), N, Bsz,
             INTEGRATORS.index(consts.integrator), int(consts.lower is not None),
             build.stream_ptr(Xb.device))
    build.check(err, name)
    dispatch_log.launched("forward_rollout" + consts.variant + consts.tag, Bsz)
    return X.movedim(-1, 0), U.movedim(-1, 0), J
