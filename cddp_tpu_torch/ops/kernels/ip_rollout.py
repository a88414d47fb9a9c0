"""Open-loop rollout and the interior-point forward pass: CUDA kernels and
their plain versions.

Replaces ``cddp_tpu/ops/pallas/ip_rollout.py::_make_ol_kernel`` (the
open-loop rollout X[t+1] = f_d(X[t], U[t]) that seeds every solve) and
``_make_ip_forward_kernel`` (one trial of the IPDDP line search). The CUDA
kernels (``ops/csrc/open_loop_rollout.cu``, ``ops/csrc/ip_forward.cu``) give
each problem instance one thread; trajectories are batch-last in device
memory. CUDA tensors launch the kernels; CPU tensors run the plain versions,
which carry the same lane arithmetic (``rollout.integrate_lane``, the box
rows ``(lo - v) * scale`` and ``(v - hi) * scale``).

The forward kernel takes one trial at step sizes (alpha_pr, alpha_du) and
the fraction-to-boundary tau, per instance:

- the feedback law u = Ub + alpha_pr k_u + K_u dx and the costate update
  lam = lam + alpha_pr k_lam + K_lam dx;
- slack and dual trial steps with their separate step sizes, and with
  ``slack_soc`` the slack re-closure s := -g where it passes the
  fraction-to-boundary test;
- the stacked box rows g, the fraction-to-boundary and finiteness masks;
- the quadratic running cost, against a tracking objective's row t at
  step t (the ``_track`` launchers), or a registered cost lane's, and the
  model's step: its integrator, or a discrete model's exact map.

**The user lane registries** (ip_rollout.py:62-133 of the JAX package).
``register_model_lane`` adds a model class's dynamics lane, the plain torch
function beside its CUDA struct; ``register_cost_lane`` an objective
class's running-cost lane, whose per-instance parameters cp (B, n_cp) the
forward kernel reads (one row per instance, batch-last in device memory).
Both match by exact class. The kernels of a header's lanes are built from
it at first use (``build.lane_library``): kernel 4 on each model lane, and
kernel 5 on each model lane with each cost lane of the same header, on the
model's control box (m = 2 nu). The plain versions run the plain lane
functions.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch

from cddp_tpu_torch.constraints.path import (BallConstraint, ControlConstraint,
                                             StateConstraint)
from cddp_tpu_torch.costs.objective import QuadraticObjective
from cddp_tpu_torch.ops.kernels import dispatch_log
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
from cddp_tpu_torch.ops.kernels.rollout import ATTITUDE_MODELS, SMALL_ROWS, SPACECRAFT_ROWS
from cddp_tpu_torch.solvers.base import ftb_ok

_OL_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_double)]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_FWD_ARGTYPES = ([ctypes.c_void_p] * 27 + [ctypes.POINTER(ctypes.c_double)] * 2
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# A cost-lane launcher: the 26 tensors, cp (n_cp, B) and n_cp, the lane's
# weights, then as above.
_FWD_LANE_ARGTYPES = ([ctypes.c_void_p] * 27 + [ctypes.c_int]
                      + [ctypes.POINTER(ctypes.c_double)] * 3 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])

# Box-stack sizes m the forward kernel (5) is instantiated for, by model:
# in the tracking form the unicycle's control box, state box or both, the
# pendulum's control box, HCW's (the rendezvous fleet's per-pass trials)
# and the quadrotor's rotor box (the figure-8); in the goal form those and
# the control boxes of the car, QuadrotorRate, the attitude trio and the
# other spacecraft models (m = 6; the lander's thrust and gimbal box, m =
# 4) and the small models (the bicycle's m = 4, the others' m = 2). The
# open-loop rollout (4) takes every registered model; the whole solves' box
# tables are mega_ipddp.IP_BOX_ROWS, MS_BOX_ROWS and LOG_BOX_ROWS.
TRACK_ROWS = {"unicycle": (4, 6, 10), "pendulum": (2,), "hcw": (6,), "quadrotor": (8,)}
KERNEL_ROWS = {**TRACK_ROWS, "car": (4,), "quadrotor_rate": (8,),
               **{m: (6,) for m in ATTITUDE_MODELS}, **SPACECRAFT_ROWS, **SMALL_ROWS}


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


# --- the user lane registries -----------------------------------------------------


def register_model_lane(cls, n_params, param_fn, lane_f, *, header, struct, name):
    """Register the dynamics lane of the model class ``cls`` (exact class):
    ``param_fn(model)`` gives its ``n_params`` floats, ``lane_f(x (B, nx),
    u (B, nu), p (n_params,)) -> dx (B, nx)`` is the plain torch lane, and
    ``struct`` in ``header`` its CUDA model struct (NX, NU, NP = n_params,
    f and fxfu, as ``ops/csrc/models.cuh``'s). ``name`` names its
    launchers. Lanes are continuous-time: the port has no discrete user
    lanes."""

    def params(model):
        p = [float(v) for v in param_fn(model)]
        if len(p) != n_params:
            raise ValueError(f"{cls.__name__} lane: {len(p)} parameters, registered {n_params}")
        return p

    rollout_ops.USER_MODELS[cls] = rollout_ops.ModelEntry(
        params=params, cuda_name=name, lane_f=lane_f,
        cuda=rollout_ops.CudaLane(Path(header).resolve(), struct))


def model_lane(model) -> Optional[rollout_ops.ModelEntry]:
    """The model's lane: a user lane of its exact class, else the built-in
    registry's entry, else None."""
    return rollout_ops.model_entry(model)


@dataclass(frozen=True)
class CostLane:
    """A resolved running-cost lane of one objective: its per-instance
    parameters ``params`` (n_cp,) or (B, n_cp); ``lane_f(x (B, nx), u (B,
    nu), cp (B, n_cp), t) -> (B,)`` the plain torch lane; ``weights`` the
    constants its CUDA struct reads besides cp. ``cost_lane`` fills in the
    registration's CUDA struct (``header``, ``struct``) and launcher
    ``name``."""

    params: torch.Tensor
    lane_f: Callable
    weights: Tuple[float, ...]
    header: Optional[Path] = None
    struct: Optional[str] = None
    name: Optional[str] = None

    def cp(self, batch: int, like: torch.Tensor) -> torch.Tensor:
        """The parameters as (B, n_cp) in ``like``'s dtype and device."""
        return lane_params(self.params, batch, like)


def lane_params(p, batch: int, like: torch.Tensor) -> torch.Tensor:
    """A lane's parameters, (n_cp,) shared or (B, n_cp) per instance, as
    (B, n_cp) in ``like``'s dtype and device; raises on another batch."""
    p = p.to(like)
    if p.dim() == 1:
        return p.expand(batch, p.shape[-1])
    if p.dim() != 2 or p.shape[0] != batch:
        raise ValueError(f"lane parameters of shape {tuple(p.shape)} for a batch of {batch}")
    return p


# Exact objective class -> (factory, CUDA struct, launcher name).
_COST_LANES = {}


def register_cost_lane(cls, factory, *, header, struct, name):
    """Register a running-cost lane for an objective class (exact class):
    ``factory(objective)`` returns a :class:`CostLane` (its CUDA fields
    unset), or None to decline; ``struct`` in ``header`` is its CUDA cost
    struct, ``name`` names its launchers."""
    _COST_LANES[cls] = (factory, rollout_ops.CudaLane(Path(header).resolve(), struct), name)


def cost_lane(objective) -> Optional[CostLane]:
    """The objective's resolved cost lane, or None."""
    reg = _COST_LANES.get(type(objective))
    lane = None if reg is None else reg[0](objective)
    if lane is None:
        return None
    return dataclasses.replace(lane, weights=tuple(lane.weights), header=reg[1].header,
                               struct=reg[1].struct, name=reg[2])


def registered_lanes(header) -> Tuple[list, list]:
    """(model lanes [(name, struct, nu)], cost lanes [(name, struct)])
    registered with ``header``: what its lane library instantiates."""
    header = Path(header).resolve()
    models = [(e.cuda_name, e.cuda.struct, cls.control_dim)
              for cls, e in rollout_ops.USER_MODELS.items() if e.cuda.header == header]
    costs = [(name, cuda.struct) for _, cuda, name in _COST_LANES.values()
             if cuda.header == header]
    return models, costs


def lane_box(problem, stk, header) -> Optional["BoxRows"]:
    """The stack a user lane's kernels take: the model's control box alone
    (m = 2 nu), under a model lane registered with ``header``; else None."""
    entry = rollout_ops.model_entry(problem.model)
    rows = box_rows(problem, stk)
    if (entry is None or entry.cuda is None or entry.cuda.header != header
            or rows is None or [k for k, _ in rows.items] != ["control"]):
        return None
    return rows


# --- open-loop rollout (kernel 4) ---------------------------------------------


def open_loop_rollout_plain(model, x0, U, dt: float):
    """Lane arithmetic of the JAX package's open-loop scan
    (ip_rollout.py:684-699; a discrete model steps its exact map):
    X (B, N+1, nx) from x0 (B, nx), U (B, N, nu), for a registered model."""
    entry = rollout_ops.model_entry(model)
    kind = rollout_ops.lane_integrator(model, entry)
    dtv = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    xs = [x0]
    for t in range(U.shape[1]):
        xs.append(rollout_ops.lane_step(model, entry, kind, xs[-1], U[:, t], dtv))
    return torch.stack(xs, dim=1)


def open_loop_rollout(model, x0, U, dt: float, kernel: bool = True):
    """X (B, N+1, nx). A registered model with an explicit integrator, or
    a discrete one, launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors or with ``kernel=False`` (the solvers'
    ``backward_engine="scan"``); other models step
    ``model.discrete_dynamics``."""
    entry = rollout_ops.model_entry(model)
    if rollout_ops.lane_integrator(model, entry) is None:
        xs = [x0]
        for t in range(U.shape[1]):
            xs.append(model.discrete_dynamics(xs[-1], U[:, t], t * dt, dt))
        return torch.stack(xs, dim=1)
    if x0.device.type == "cpu" or not kernel:
        dispatch_log.plain("open_loop_rollout" + entry.tag, x0.shape[0])
        return open_loop_rollout_plain(model, x0, U, dt)
    return _launch_open_loop(model, entry, x0, U, dt)


def _launch_open_loop(model, entry, x0, U, dt):
    from cddp_tpu_torch.ops.kernels import build

    Bsz, N, nu = U.shape
    nx = x0.shape[-1]
    tag = build.dtype_tag("open_loop_rollout", (x0, U), ((nx,), (N, nu)))
    name = f"cddp_open_loop_rollout_{entry.cuda_name}_{tag}"
    fn = build.function(name, _OL_ARGTYPES, entry.cuda and entry.cuda.header)
    Ul, x0l = (t.movedim(0, -1).contiguous() for t in (U, x0))
    X = x0.new_empty(N, nx, Bsz)
    host = [float(dt)] + entry.kernel_params(model)
    err = fn(build.ptr(Ul), build.ptr(x0l), build.ptr(X), build.doubles(host),
             N, Bsz, rollout_ops.INTEGRATORS.index(rollout_ops.lane_integrator(model, entry)),
             build.stream_ptr(x0.device))
    build.check(err, name)
    dispatch_log.launched("open_loop_rollout" + entry.tag, Bsz)
    return torch.cat([x0[:, None], X.movedim(-1, 0)], dim=1)


# --- box rows -------------------------------------------------------------------


def row_kind(c, ball: bool = False):
    """A path constraint's kind in the kernels' lane layout: "control" or
    "state" for exactly a ControlConstraint or StateConstraint
    (ip_rollout.py:199-216), with ``ball`` ("ball", d) for a keep-out
    BallConstraint (the whole-solve IPDDP kernel's, mega_ipddp.py:2431-2457);
    None for any other type."""
    if type(c) is ControlConstraint:
        return "control"
    if type(c) is StateConstraint:
        return "state"
    if ball and type(c) is BallConstraint:
        return ("ball", c.dim)
    return None


@dataclass(frozen=True)
class BoxRows:
    """The stacked rows of a lane stack, in stack order: a box row reads
    entry ``var[r]`` of [x; u] and is g = (bound - v) * scale (lower rows)
    or (v - bound) * scale (upper rows); a keep-out ball's row (``ball``
    stacks of the whole-solve IPDDP kernel only) is computed from the
    ball's parameters."""

    items: Tuple  # ((kind "control"|"state"|("ball", d), constraint), ...)
    nx: int
    nu: int

    @property
    def m(self) -> int:
        return sum(c.dual_dim for _, c in self.items)

    @property
    def ball_rows(self) -> List[int]:
        """The stack rows of the keep-out balls."""
        kinds = [kind for kind, c in self.items for _ in range(c.dual_dim)]
        return [r for r, kind in enumerate(kinds) if isinstance(kind, tuple)]

    def evaluate(self, x, u):
        """g (B, m) of a box-only stack, the lane form of the JAX kernels
        (ip_rollout.py:311-317)."""
        parts = []
        for kind, c in self.items:
            v = u if kind == "control" else x
            parts.append((c.lower - v) * c.scale_factor)
            parts.append((v - c.upper) * c.scale_factor)
        return torch.cat(parts, dim=-1)

    @property
    def host(self) -> List[float]:
        """Per row [var index, upper flag, bound, scale], as the CUDA
        ``BoxRows`` struct reads them; a ball's row [-1, 0, 0, 0]."""
        out = []
        for kind, c in self.items:
            if isinstance(kind, tuple):
                out += [-1.0, 0.0, 0.0, 0.0]
                continue
            off = self.nx if kind == "control" else 0
            n = c.upper.shape[0]
            lo, hi = c.lower.double().cpu().tolist(), c.upper.double().cpu().tolist()
            out += [v for i in range(n) for v in (off + i, 0.0, lo[i], c.scale_factor)]
            out += [v for i in range(n) for v in (off + i, 1.0, hi[i], c.scale_factor)]
        return out

    @property
    def ball(self) -> List[float]:
        """The keep-out ball as the whole-solve IPDDP kernel reads it: [d,
        radius, scale, center padded to nx]; zeros without a ball."""
        for kind, c in self.items:
            if isinstance(kind, tuple):
                center = c.center.double().cpu().tolist()
                return ([float(c.dim), float(c.radius), c.scale_factor] + center
                        + [0.0] * (self.nx - len(center)))
        return [0.0] * (3 + self.nx)


def box_rows(problem, stk, ball: bool = False) -> Optional[BoxRows]:
    """The stack as lane rows, or None if it is empty or an item has no
    ``row_kind``: control and state boxes, and with ``ball`` keep-out
    balls."""
    items = [(row_kind(c, ball), c) for _, c in stk.items]
    if not items or any(kind is None for kind, _ in items):
        return None
    return BoxRows(items=tuple(items), nx=problem.state_dim, nu=problem.control_dim)


@dataclass(frozen=True)
class ForwardConsts:
    """The forward kernel's view of a problem; ``cost`` a registered cost
    lane in place of the quadratic cost."""

    lane: rollout_ops.LaneConsts
    rows: BoxRows
    slack_soc: bool
    cost: Optional[CostLane] = None

    @property
    def tag(self) -> str:
        """The ``dispatch_log`` name's suffix: the variant, the cost lane's
        name and the model's tag ("ip_forward_mpcc@bicycle7")."""
        return self.lane.variant + ("_" + self.cost.name if self.cost else "") + self.lane.tag


def resolve_ip_forward(problem, options, stk) -> Optional[ForwardConsts]:
    """Eligibility of the forward kernel (ip_rollout.py:219-242):
    ``forward_engine="auto"``, a registered model with an explicit
    integrator, the quadratic objective and a box-only stack of a size the
    kernel is built for (``KERNEL_ROWS``; ``TRACK_ROWS`` for a tracking
    objective). Box stacks are affine, so the
    "auto" slack SOC resolves to off; only an explicit ``slack_soc=True``
    traces it. On any other stack (a keep-out ball, as in the JAX package,
    ip_rollout.py:821) this returns None and the per-pass driver runs its
    plain trial, ``solvers/ipddp.py::_forward_scan``."""
    if options.ipddp.forward_engine != "auto":
        return None
    if not isinstance(problem.objective, QuadraticObjective):
        # A registered cost lane on a user model lane of the same header.
        cost = cost_lane(problem.objective)
        rows = cost and lane_box(problem, stk, cost.header)
        lane = rows and rollout_ops.lane_consts(problem, cost_lane=True)
        if not lane:
            return None
        return ForwardConsts(lane=lane, rows=rows, cost=cost,
                             slack_soc=options.ipddp.slack_soc is True)
    lane = rollout_ops.lane_consts(problem)
    rows = box_rows(problem, stk)
    table = KERNEL_ROWS if lane is None or lane.refs is None else TRACK_ROWS
    if (lane is None or rows is None
            or rows.m not in table.get(lane.entry.cuda_name, ())):
        return None
    return ForwardConsts(lane=lane, rows=rows,
                         slack_soc=options.ipddp.slack_soc is True)


# --- interior-point forward trial (kernel 5) ------------------------------------


def ip_forward_plain(fc: ForwardConsts, Xb, Ub, Y, S, ku, Ku, klam, Klam, lam,
                     ky, Ky, ks, Ks, x0, a_pr, a_du, tau, soc):
    """Port of ``ip_rollout.py::_scan_ip_forward_single``, batch-first:
    Xb (B,N,nx) nominal x_0..x_{N-1}, Ub/ku (B,N,nu), Ku (B,N,nu,nx), Y/S/ky/ks
    (B,N,m), Ky/Ks (B,N,m,nx), lam/klam (B,N,nx), Klam (B,N,nx,nx), x0 (B,nx),
    a_pr/a_du/tau (B,), soc (B,) bool. Returns (X tail (B,N,nx) = x_1..x_N,
    U (B,N,nu), S, Y, G (B,N,m), Lam (B,N,nx), J (B,), feasible (B,))."""
    lc = fc.lane
    N = Xb.shape[1]
    dt = torch.tensor(lc.dt, dtype=Xb.dtype, device=Xb.device)
    cp = None if fc.cost is None else fc.cost.cp(Xb.shape[0], Xb)
    apr, adu, tau_ = a_pr[:, None], a_du[:, None], tau[:, None]
    x = x0
    J = Xb.new_zeros(Xb.shape[0])
    feas = torch.ones(Xb.shape[0], dtype=torch.bool, device=Xb.device)
    outs = [[] for _ in range(6)]
    for t in range(N):
        dx = x - Xb[:, t]
        s, y = S[:, t], Y[:, t]
        lam_new = lam[:, t] + apr * klam[:, t] + _mv(Klam[:, t], dx)
        s_new = s + apr * ks[:, t] + _mv(Ks[:, t], dx)
        y_new = y + adu * ky[:, t] + _mv(Ky[:, t], dx)
        u = Ub[:, t] + apr * ku[:, t] + _mv(Ku[:, t], dx)
        if cp is not None:
            J = J + fc.cost.lane_f(x, u, cp, t)
        else:
            e = x - lc.running_ref(t)
            J = J + (((e @ lc.Q) * e).sum(-1) + ((u @ lc.R) * u).sum(-1))
        g = fc.rows.evaluate(x, u)
        if fc.slack_soc:
            ok_soc = ftb_ok(-g, s, tau_) & soc[:, None]
            s_new = torch.where(ok_soc, -g, s_new)
        x_next = lc.step(x, u, dt)
        feas = (feas & ftb_ok(s_new, s, tau_).all(-1) & ftb_ok(y_new, y, tau_).all(-1)
                & s_new.isfinite().all(-1) & y_new.isfinite().all(-1)
                & x_next.isfinite().all(-1) & u.isfinite().all(-1)
                & lam_new.isfinite().all(-1))
        for o, v in zip(outs, (x_next, u, s_new, y_new, g, lam_new)):
            o.append(v)
        x = x_next
    X, U, Sn, Yn, G, Lam = (torch.stack(o, 1) for o in outs)
    return X, U, Sn, Yn, G, Lam, J, feas


def ip_forward(fc: ForwardConsts, *args):
    """CUDA tensors launch the kernel; CPU tensors run the plain version."""
    Xb = args[0]
    if Xb.device.type == "cpu":
        dispatch_log.plain("ip_forward" + fc.tag, Xb.shape[0])
        return ip_forward_plain(fc, *args)
    return _launch_forward(fc, *args)


def _launch_forward(fc: ForwardConsts, Xb, Ub, Y, S, ku, Ku, klam, Klam, lam,
                    ky, Ky, ks, Ks, x0, a_pr, a_du, tau, soc):
    from cddp_tpu_torch.ops.kernels import build

    Bsz, N, nx = Xb.shape
    nu, m = Ub.shape[-1], Y.shape[-1]
    soc = soc.to(Xb.dtype)
    ins = (Xb, Ub, Y, S, ku, Ku, klam, Klam, lam, ky, Ky, ks, Ks, x0, a_pr,
           a_du, tau, soc)
    tag = build.dtype_tag("ip_forward", ins, (
        (N, nx), (N, nu), (N, m), (N, m), (N, nu), (N, nu, nx), (N, nx),
        (N, nx, nx), (N, nx), (N, m), (N, m, nx), (N, m), (N, m, nx), (nx,),
        (), (), (), ()))
    last = [t.movedim(0, -1).contiguous() for t in ins]
    X, U, Sn, Yn, G, Lam = (Xb.new_empty(N, d, Bsz) for d in (nx, nu, m, m, m, nx))
    J, F = Xb.new_empty(Bsz), Xb.new_empty(Bsz)
    outs = [build.ptr(t) for t in last + [X, U, Sn, Yn, G, Lam, J, F]]
    tail = (build.doubles(fc.lane.host), build.doubles(fc.rows.host), N, Bsz,
            rollout_ops.INTEGRATORS.index(fc.lane.integrator), int(fc.slack_soc))
    if fc.cost is None:
        name = f"cddp_ip_forward_{fc.lane.entry.cuda_name}_m{m}{fc.lane.variant}_{tag}"
        err = build.function(name, _FWD_ARGTYPES)(
            *outs, fc.lane.refs_ptr(Xb), *tail, build.stream_ptr(Xb.device))
    else:
        # The lane kernel reads each instance's cost parameters batch-last,
        # (n_cp, B), and the cost lane's weights beside them.
        name = f"cddp_ip_forward_{fc.lane.entry.cuda_name}_{fc.cost.name}_m{m}_{tag}"
        cp = fc.cost.cp(Bsz, Xb).movedim(0, -1).contiguous()
        err = build.function(name, _FWD_LANE_ARGTYPES, fc.cost.header)(
            *outs, build.ptr(cp), cp.shape[0], build.doubles(fc.cost.weights), *tail,
            build.stream_ptr(Xb.device))
    build.check(err, name)
    dispatch_log.launched("ip_forward" + fc.tag, Bsz)
    return (*(t.movedim(-1, 0) for t in (X, U, Sn, Yn, G, Lam)), J, F > 0.5)
