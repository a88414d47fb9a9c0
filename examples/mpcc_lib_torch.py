"""MPCC racing-line tracking on the PyTorch + CUDA port (``cddp_tpu_torch``).

The port of ``examples/mpcc_lib.py``: the AIRCoM-style kinematic MPCC of
``examples/ipddp_mpcc_rc.py`` (a 7-state latch bicycle solved by IPDDP with a
13-residual Gauss-Newton cost against a closed track). Like the JAX file it
is a *user* of the lane registries: it registers the bicycle's model lane
(``ip_rollout.register_model_lane``), the Clenshaw-window cost lane of the
interior-point forward trial (``ip_rollout.register_cost_lane``) and the
Gauss-Newton residual lane of the whole IPDDP solve
(``mega_ipddp.register_gn_cost_lane``), each with its plain torch function
and its CUDA struct in ``examples/mpcc_lanes.cuh``.

- :class:`Track`: the closed track, evaluated by its truncated Fourier fit
  (gather-free; :func:`synthetic_track`, :func:`load_track_csv`).
- :class:`LocalTrack`: a per-tick Chebyshev window of the track around each
  car's progress, evaluated by the Clenshaw recurrence
  (:func:`local_track_fit`); with a leading instance axis on its tensors it
  is every car's own window, and the objective built on it is batched.
- :class:`KinematicBicycle7`, :class:`MpccConfig`, :class:`MpccObjective`.
- :func:`mpc_tick` / :func:`batched_mpcc_step_costs`: one cold-seeded IPDDP
  tick of a whole fleet in one batch-first solve; :func:`run_mpc` the closed
  loop; :func:`warm_fleet_init` / :func:`warm_fleet_step` the warm-started
  fleet (``IPDDPSolverState`` carried between ticks).

Every function takes and returns batch-first tensors on the device of its
inputs; the tracks are built on the CUDA card unless given ``device``.
"""

from __future__ import annotations

import csv
import dataclasses
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

import cddp_tpu_torch as tt
from cddp_tpu_torch import devices
from cddp_tpu_torch.costs.objective import ResidualObjective
from cddp_tpu_torch.models.base import DynamicalSystem, register_parameters
from cddp_tpu_torch.ops.kernels import ip_rollout, mega_ipddp
from cddp_tpu_torch.options import LineSearchOptions, RegularizationOptions
from cddp_tpu_torch.solvers import ipddp

IDX_X, IDX_Y, IDX_PSI, IDX_THETA = 0, 1, 2, 3
IDX_V_PREV, IDX_DELTA_PREV, IDX_V_THETA_PREV = 4, 5, 6
LANES_HEADER = Path(__file__).resolve().parent / "mpcc_lanes.cuh"


def _wrap_angle(a):
    """a wrapped to [-pi, pi): JAX's (a + pi) % 2 pi - pi by a floor taken
    off the tangent (its derivative is 0; torch.remainder's and
    torch.floor's forward-mode tangents turn float32 into float64)."""
    return a - (2.0 * math.pi) * torch.floor(((a + math.pi) / (2.0 * math.pi)).detach())


def _clip_unit(v):
    """clip(v, -1, 1) as max then min (jnp.clip's form; torch.clamp with
    scalar bounds turns float32 tangents into float64)."""
    one = torch.ones_like(v)
    return torch.minimum(torch.maximum(v, -one), one)


def _frame(heading):
    """(tangent, normal), each stacked on a leading axis of 2."""
    c, s = torch.cos(heading), torch.sin(heading)
    return torch.stack([c, s]), torch.stack([-s, c])


@dataclass(frozen=True)
class Track:
    """A closed track: the node samples extended by one wrap-around point,
    and the truncated Fourier fit (2K+1, 8) of [x, y, heading residual,
    curvature, v_ref, 0, 0, 0] against [1, cos(k theta), sin(k theta)],
    theta = 2 pi s / L, that ``interpolate`` evaluates
    (mpcc_lib.py:46-99)."""

    s_ext: torch.Tensor
    x_ext: torch.Tensor
    y_ext: torch.Tensor
    heading_ext: torch.Tensor  # unwrapped
    curvature_ext: torch.Tensor
    v_ref_ext: torch.Tensor
    width: torch.Tensor
    length: torch.Tensor
    fourier: torch.Tensor

    def wrap_progress(self, progress):
        return torch.remainder(progress, self.length)

    def interpolate(self, progress):
        """The reference at ``progress`` (any shape): x, y, heading,
        curvature, v_ref, tangent and normal (each (2, ...))."""
        w = self.wrap_progress(progress)
        K = (self.fourier.shape[0] - 1) // 2
        theta = (2.0 * math.pi) * (w / self.length)
        k = torch.arange(1, K + 1, dtype=theta.dtype, device=theta.device)
        ang = theta[..., None] * k
        basis = torch.cat([torch.ones_like(theta)[..., None], torch.cos(ang), torch.sin(ang)],
                          dim=-1)
        vals = basis @ self.fourier.to(theta.dtype)
        x, y, h_res, curvature, v_ref = (vals[..., i] for i in range(5))
        heading = theta + h_res
        tangent, normal = _frame(heading)
        return dict(x=x, y=y, heading=heading, curvature=curvature, v_ref=v_ref,
                    tangent=tangent, normal=normal)


@dataclass(frozen=True)
class LocalTrack:
    """A Chebyshev window of the track's fields [x, y, heading (unwrapped),
    curvature, v_ref] over the progress one solve can reach, evaluated by
    the Clenshaw recurrence (mpcc_lib.py:102-155). Its tensors may carry
    leading instance axes (one window per car), which broadcast against
    ``progress``."""

    coeffs: torch.Tensor  # (..., M, 5)
    center: torch.Tensor  # (...,)
    halfwidth: torch.Tensor
    width: torch.Tensor
    length: torch.Tensor

    def wrap_progress(self, progress):
        return progress

    def interpolate(self, progress):
        t = _clip_unit((progress - self.center) / self.halfwidth)
        coeffs = self.coeffs.to(t.dtype)
        M = coeffs.shape[-2]
        b1 = t.new_zeros(t.shape + (5,))
        b2 = t.new_zeros(t.shape + (5,))
        t2 = 2.0 * t[..., None]
        for k in range(M - 1, 0, -1):
            b1, b2 = t2 * b1 - b2 + coeffs[..., k, :], b1
        vals = t[..., None] * b1 - b2 + coeffs[..., 0, :]
        x, y, heading, curvature, v_ref = (vals[..., i] for i in range(5))
        tangent, normal = _frame(heading)
        return dict(x=x, y=y, heading=heading, curvature=curvature, v_ref=v_ref,
                    tangent=tangent, normal=normal)


def local_track_fit(track: Track, theta0, reach, margin=0.4, n_coeffs=32) -> LocalTrack:
    """The LocalTrack over [theta0 - margin, theta0 + reach + margin] from
    the Fourier track (mpcc_lib.py:158-191): the fit at the n_coeffs
    Chebyshev-Gauss nodes, projected by the DCT sum. ``theta0`` (...,)
    gives windows (..., M, 5), one per entry; width and length are
    broadcast to its shape."""
    theta0 = torch.as_tensor(theta0, dtype=track.fourier.dtype, device=track.fourier.device)
    lo = theta0 - margin
    hi = theta0 + reach + margin
    c = 0.5 * (lo + hi)
    h = 0.5 * (hi - lo)
    M = n_coeffs
    j = torch.arange(M, dtype=track.fourier.dtype, device=track.fourier.device)
    node_t = torch.cos(math.pi * (j + 0.5) / M)
    theta_nodes = c[..., None] + h[..., None] * node_t
    ref = track.interpolate(theta_nodes)
    resid = ref["heading"] - (2.0 * math.pi) * track.wrap_progress(theta_nodes) / track.length
    heading = (2.0 * math.pi) * theta_nodes / track.length + resid
    F = torch.stack([ref["x"], ref["y"], heading, ref["curvature"], ref["v_ref"]], dim=-1)
    k = j
    proj = (2.0 / M) * torch.cos(math.pi * k[:, None] * (j[None, :] + 0.5) / M)
    proj[0] = proj[0] * 0.5
    return LocalTrack(coeffs=proj @ F, center=c, halfwidth=h,
                      width=track.width.expand(theta0.shape),
                      length=track.length.expand(theta0.shape))


def _track_from_xy(x, y, width=0.18, *, device=None, dtype=torch.float64) -> Track:
    """The track of centerline points (mpcc_lib.py:194-246): arc length,
    unwrapped heading, curvature by gradient, the curvature-limited speed
    profile and the Fourier fit of K = 64 harmonics on a 2048-point grid,
    in numpy."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    dx = np.roll(x, -1) - x
    dy = np.roll(y, -1) - y
    ds = np.hypot(dx, dy)
    length = float(np.sum(ds))
    s = np.concatenate([[0.0], np.cumsum(ds[:-1])])
    heading = np.unwrap(np.arctan2(dy, dx))
    curvature = np.gradient(heading, s, edge_order=2)
    v_ref = np.clip(np.sqrt(1.35 / np.maximum(np.abs(curvature), 0.12)), 1.0, 2.2)
    v_ref = np.minimum(v_ref, np.roll(v_ref, -1) + 0.18)

    n_grid = 2048
    K = 64
    s_ext_np = np.concatenate([s, [length]])
    s_grid = np.linspace(0.0, length, n_grid, endpoint=False)
    heading_resid = heading - 2.0 * np.pi * s / length
    fields = [
        np.interp(s_grid, s_ext_np, np.concatenate([c, [c0]]))
        for c, c0 in ((x, x[0]), (y, y[0]), (heading_resid, heading_resid[0]),
                      (curvature, curvature[0]), (v_ref, v_ref[0]))
    ]
    fourier = np.zeros((2 * K + 1, 8))
    for col, f in enumerate(fields):
        F = np.fft.rfft(f) / n_grid
        fourier[0, col] = F[0].real
        fourier[1:K + 1, col] = 2.0 * F[1:K + 1].real
        fourier[K + 1:, col] = -2.0 * F[1:K + 1].imag

    t = lambda v: torch.as_tensor(np.asarray(v, float), dtype=dtype,  # noqa: E731
                                  device=devices.resolve(device))
    return Track(
        s_ext=t(s_ext_np), x_ext=t(np.concatenate([x, [x[0]]])),
        y_ext=t(np.concatenate([y, [y[0]]])),
        heading_ext=t(np.concatenate([heading, [heading[0] + 2.0 * np.pi]])),
        curvature_ext=t(np.concatenate([curvature, [curvature[0]]])),
        v_ref_ext=t(np.concatenate([v_ref, [v_ref[0]]])),
        width=t(width), length=t(length), fourier=t(fourier))


def load_track_csv(path, width: float = 0.18, coordinate_scale: float = 1.0, *,
                   device=None, dtype=torch.float64) -> Track:
    """The track of a CSV with the schema x,y,s,heading,curvature,v_ref."""
    with Path(path).open() as fh:
        rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(fh)]
    x = coordinate_scale * np.asarray([r["x"] for r in rows])
    y = coordinate_scale * np.asarray([r["y"] for r in rows])
    return _track_from_xy(x, y, width=width, device=device, dtype=dtype)


def synthetic_track(n_points: int = 480, width: float = 0.18, *, device=None,
                    dtype=torch.float64) -> Track:
    """A rounded rectangle with a chicane, about the bundled track's size
    (mpcc_lib.py:256-264)."""
    t = np.linspace(0.0, 2 * np.pi, n_points, endpoint=False)
    a, b, p = 1.1, 0.8, 4.0
    x = a * np.sign(np.cos(t)) * np.abs(np.cos(t)) ** (2 / p)
    y = b * np.sign(np.sin(t)) * np.abs(np.sin(t)) ** (2 / p)
    x = x + 0.08 * np.sin(3 * t)
    y = y + 0.06 * np.sin(2 * t + 0.7)
    return _track_from_xy(x, y, width=width, device=device, dtype=dtype)


class KinematicBicycle7(DynamicalSystem):
    """The 7-state latch bicycle (mpcc_lib.py:267-297): state [x, y, psi,
    theta, v_prev, delta_prev, v_theta_prev], control [v_w, delta,
    v_theta]; the latches follow d(latch)/dt = (u - latch) / dt, so that
    under Euler with step dt the next latch is u exactly."""

    state_dim = 7
    control_dim = 3

    def __init__(self, wheelbase: float = 0.062, dt: float = 0.05,
                 integration_type: str = "euler"):
        super().__init__(integration_type)
        register_parameters(self, wheelbase=wheelbase, dt=dt)

    def forward(self, x, u, t):
        psi = x[..., IDX_PSI]
        v_prev, delta_prev, v_theta_prev = x[..., 4], x[..., 5], x[..., 6]
        v_w, delta, v_theta = u[..., 0], u[..., 1], u[..., 2]
        inv_dt = 1.0 / self.dt
        return torch.stack([
            v_w * torch.cos(psi),
            v_w * torch.sin(psi),
            v_w * torch.tan(delta) / self.wheelbase,
            v_theta,
            (v_w - v_prev) * inv_dt,
            (delta - delta_prev) * inv_dt,
            (v_theta - v_theta_prev) * inv_dt,
        ], dim=-1)


@dataclass(frozen=True)
class MpccConfig:
    """ipddp_mpcc_rc.py:230-332's weights and bounds (mpcc_lib.py:300-347).
    The JAX file's ``matmul_precision`` has no counterpart: the port's
    float32 products stay exact float32 (TF32 off)."""

    dt: float = 0.05
    horizon: int = 20
    wheelbase: float = 0.062
    reference_speed: float = 1.0
    speed_min: float = 0.1
    speed_max: float = 2.2
    delta_max: float = 0.60
    v_theta_min: float = 0.0
    v_theta_max: float = 2.2
    w_contour: float = 200.0
    w_lag: float = 100.0
    w_speed: float = 5.0
    w_control: float = 0.1
    w_x: float = 0.0
    w_y: float = 0.0
    w_yaw: float = 0.0
    w_speed_w: float = 10.0
    w_dv: float = 300.0
    w_ddelta: float = 1000.0
    w_dv_theta: float = 100.0
    w_boundary: float = 200.0
    boundary_band: float = 0.85
    w_terminal: float = 50.0
    w_terminal_progress: float = 2.0
    max_iterations: int = 100
    tolerance: float = 1e-4
    acceptable_tolerance: float = 5e-4
    initial_regularization: float = 1e-4
    # The IPDDP Riccati engine: the port takes "sequential" only.
    lqr_backend: str = "sequential"
    line_search_iters: int = 12
    # "fourier": the full periodic fit at every lookup; "local": a per-tick
    # Chebyshev window (LocalTrack) of local_coeffs coefficients per car.
    track_eval: str = "fourier"
    local_coeffs: int = 32


def _sq(w, cfg):
    """sqrt(dt w), the residual scale of weight w, in Python floats."""
    return (cfg.dt * w) ** 0.5


@dataclass(frozen=True)
class MpccObjective(ResidualObjective):
    """The 13-residual MPCC cost (mpcc_lib.py:350-404): contour and lag
    errors, speed tracking, control effort, position and yaw (zero weights
    by default), control rates against the latches and a one-sided boundary
    band; terminal contour and lag residuals and the affine progress bonus
    -w_terminal_progress theta."""

    track: object = None
    cfg: MpccConfig = None

    def _tracking(self, x):
        ref = self.track.interpolate(x[IDX_THETA])
        dx = x[IDX_X] - ref["x"]
        dy = x[IDX_Y] - ref["y"]
        e_c = ref["normal"][0] * dx + ref["normal"][1] * dy
        e_l = ref["tangent"][0] * dx + ref["tangent"][1] * dy
        e_yaw = _wrap_angle(x[IDX_PSI] - ref["heading"])
        return e_c, e_l, e_yaw, ref["v_ref"], dx, dy

    def running_residuals(self, x, u, k):
        cfg = self.cfg
        e_c, e_l, e_yaw, v_ref_track, dx, dy = self._tracking(x)
        v_prev, delta_prev, v_theta_prev = x[4], x[5], x[6]
        v_w, delta, v_theta = u[0], u[1], u[2]
        v_target = torch.maximum(v_ref_track, v_ref_track.new_tensor(cfg.reference_speed))
        band = torch.abs(e_c) - cfg.boundary_band * self.track.width
        boundary = torch.maximum(band.new_zeros(()), band)
        return torch.stack([
            _sq(cfg.w_contour, cfg) * e_c,
            _sq(cfg.w_lag, cfg) * e_l,
            _sq(cfg.w_speed, cfg) * (v_theta - v_target),
            _sq(cfg.w_speed_w, cfg) * (v_w - v_target),
            _sq(cfg.w_control, cfg) * v_w,
            _sq(cfg.w_control, cfg) * delta,
            _sq(cfg.w_x, cfg) * dx,
            _sq(cfg.w_y, cfg) * dy,
            _sq(cfg.w_yaw, cfg) * e_yaw,
            _sq(cfg.w_dv, cfg) * (v_w - v_prev),
            _sq(cfg.w_ddelta, cfg) * (delta - delta_prev),
            _sq(cfg.w_dv_theta, cfg) * (v_theta - v_theta_prev),
            _sq(cfg.w_boundary, cfg) * boundary,
        ])

    def terminal_residuals(self, x):
        e_c, e_l, _, _, _, _ = self._tracking(x)
        w = self.cfg.w_terminal ** 0.5
        return torch.stack([w * e_c, w * e_l])

    def terminal_cost_extra(self, x):
        return -self.cfg.w_terminal_progress * x[IDX_THETA]


# --- the lanes (mpcc_lib.py:407-613) -------------------------------------------------
# Plain torch lane functions of the model and the forward trial's cost,
# batch-first: x (B, 7), u (B, 3), cp (B, n_cp) with cp = the window's
# coefficients (M, 5) row-major, then its center, halfwidth and width (n_cp
# = 5 M + 3). Their CUDA structs are in mpcc_lanes.cuh and write the same
# expressions: the clip as max/min, the where-form |e_c| and the
# floor-based angle wrapping. The GN lane's plain version is
# MpccObjective's own residuals, which the plain driver runs.


def _bicycle7_lane(x, u, p):
    wheelbase, latch_dt = p[0], p[1]
    psi = x[..., 2]
    inv_dt = 1.0 / latch_dt
    return torch.stack([
        u[..., 0] * torch.cos(psi),
        u[..., 0] * torch.sin(psi),
        u[..., 0] * torch.tan(u[..., 1]) / wheelbase,
        u[..., 2],
        (u[..., 0] - x[..., 4]) * inv_dt,
        (u[..., 1] - x[..., 5]) * inv_dt,
        (u[..., 2] - x[..., 6]) * inv_dt,
    ], dim=-1)


def track_params(obj: MpccObjective):
    """The LocalTrack's cost parameters (mpcc_lib.py:493-504): (n_cp,), or
    (B, n_cp) for a window per instance."""
    trk = obj.track
    lead = trk.center.shape
    return torch.cat([trk.coeffs.reshape(*lead, -1), trk.center[..., None],
                      trk.halfwidth[..., None], trk.width[..., None]], dim=-1)


def _clenshaw_lanes(x, cp, M, clip):
    """(rx, ry, heading, v_ref) of each instance's window at its theta; the
    clip to [-1, 1] as the lanes take it."""
    center, halfwidth = cp[:, 5 * M], cp[:, 5 * M + 1]
    t = clip((x[:, IDX_THETA] - center) / halfwidth)
    zero = torch.zeros_like(t)
    b1 = [zero] * 5
    b2 = [zero] * 5
    t2 = 2.0 * t
    for k in range(M - 1, 0, -1):
        b1, b2 = [t2 * b1[f] - b2[f] + cp[:, 5 * k + f] for f in range(5)], b1
    vals = [t * b1[f] - b2[f] + cp[:, f] for f in range(5)]
    return vals[0], vals[1], vals[2], vals[4]


def _errors(x, rx, ry, heading):
    sin_h, cos_h = torch.sin(heading), torch.cos(heading)
    dx = x[:, IDX_X] - rx
    dy = x[:, IDX_Y] - ry
    e_c = -sin_h * dx + cos_h * dy
    e_l = cos_h * dx + sin_h * dy
    a = x[:, IDX_PSI] - heading
    two_pi = 2.0 * math.pi
    e_yaw = a - two_pi * torch.floor(((a + math.pi) / two_pi).detach())
    return e_c, e_l, e_yaw, dx, dy


def _cost_lane_f(cfg, M):
    """The forward trial's running cost lane (``_mpcc_cost_factory``'s
    ``lane_f``): the weighted squares summed directly."""

    def lane_f(x, u, cp, t):
        rx, ry, heading, v_ref = _clenshaw_lanes(x, cp, M, _clip_unit)
        e_c, e_l, e_yaw, dx, dy = _errors(x, rx, ry, heading)
        width = cp[:, 5 * M + 2]
        v_prev, delta_prev, v_theta_prev = x[:, 4], x[:, 5], x[:, 6]
        v_w, delta, v_theta = u[:, 0], u[:, 1], u[:, 2]
        v_target = torch.maximum(v_ref, v_ref.new_tensor(cfg.reference_speed))
        band = torch.abs(e_c) - cfg.boundary_band * width
        boundary = torch.maximum(torch.zeros_like(band), band)
        w = lambda wt: cfg.dt * wt  # noqa: E731
        return (w(cfg.w_contour) * e_c * e_c
                + w(cfg.w_lag) * e_l * e_l
                + w(cfg.w_speed) * (v_theta - v_target) ** 2
                + w(cfg.w_speed_w) * (v_w - v_target) ** 2
                + w(cfg.w_control) * (v_w * v_w + delta * delta)
                + w(cfg.w_x) * dx * dx
                + w(cfg.w_y) * dy * dy
                + w(cfg.w_yaw) * e_yaw * e_yaw
                + w(cfg.w_dv) * (v_w - v_prev) ** 2
                + w(cfg.w_ddelta) * (delta - delta_prev) ** 2
                + w(cfg.w_dv_theta) * (v_theta - v_theta_prev) ** 2
                + w(cfg.w_boundary) * boundary * boundary)

    return lane_f


def _cost_weights(cfg):
    """The cost lane's constants as its CUDA struct reads them: the
    reference speed, the boundary band, then dt w of each of the 12
    weights in the lane's order."""
    ws = (cfg.w_contour, cfg.w_lag, cfg.w_speed, cfg.w_speed_w, cfg.w_control, cfg.w_x,
          cfg.w_y, cfg.w_yaw, cfg.w_dv, cfg.w_ddelta, cfg.w_dv_theta, cfg.w_boundary)
    return [cfg.reference_speed, cfg.boundary_band] + [cfg.dt * w for w in ws]


def _gn_weights(cfg):
    """The GN lane's constants as its CUDA struct reads them: the reference
    speed, the boundary band, the 13 residual scales sqrt(dt w) in residual
    order, sqrt(w_terminal) and w_terminal_progress."""
    ws = (cfg.w_contour, cfg.w_lag, cfg.w_speed, cfg.w_speed_w, cfg.w_control, cfg.w_control,
          cfg.w_x, cfg.w_y, cfg.w_yaw, cfg.w_dv, cfg.w_ddelta, cfg.w_dv_theta, cfg.w_boundary)
    return ([cfg.reference_speed, cfg.boundary_band] + [_sq(w, cfg) for w in ws]
            + [cfg.w_terminal ** 0.5, cfg.w_terminal_progress])


def _cost_factory(obj: MpccObjective):
    """The forward trial's cost lane over a LocalTrack window; a Fourier
    track declines (mpcc_lib.py:436)."""
    if not isinstance(obj.track, LocalTrack):
        return None
    M = int(obj.track.coeffs.shape[-2])
    return ip_rollout.CostLane(params=track_params(obj), lane_f=_cost_lane_f(obj.cfg, M),
                               weights=_cost_weights(obj.cfg))


def _gn_factory(obj: MpccObjective):
    """The whole solve's Gauss-Newton lane over a LocalTrack window; a
    Fourier track declines (mpcc_lib.py:519)."""
    if not isinstance(obj.track, LocalTrack):
        return None
    M = int(obj.track.coeffs.shape[-2])
    return mega_ipddp.GnCostEntry(cp_fn=track_params, spec=mega_ipddp.GnCostSpec(n_cp=5 * M + 3),
                                  weights=_gn_weights(obj.cfg))


def _register_lanes():
    ip_rollout.register_model_lane(
        KinematicBicycle7, 2, lambda m: [float(m.wheelbase), float(m.dt)], _bicycle7_lane,
        header=LANES_HEADER, struct="mpcc::Bicycle7", name="bicycle7")
    ip_rollout.register_cost_lane(MpccObjective, _cost_factory, header=LANES_HEADER,
                                  struct="mpcc::MpccCost", name="mpcc")
    mega_ipddp.register_gn_cost_lane(MpccObjective, _gn_factory, header=LANES_HEADER,
                                     struct="mpcc::MpccGn", name="mpcc_gn")


_register_lanes()


# --- problems and ticks ----------------------------------------------------------------


def initial_state(track: Track, cfg: MpccConfig):
    """The car on the centerline at s = 0, latches at cruise
    (ipddp_mpcc_rc.py:473-497), (7,)."""
    ref = track.interpolate(track.s_ext[0])
    cruise = float(np.clip(cfg.reference_speed, cfg.speed_min, cfg.speed_max))
    v_theta = float(np.clip(cruise, cfg.v_theta_min, cfg.v_theta_max))
    like = track.s_ext
    return torch.stack([ref["x"], ref["y"], ref["heading"], track.s_ext[0],
                        like.new_tensor(cruise), like.new_tensor(0.0), like.new_tensor(v_theta)])


def place(track: Track, s0):
    """Cars on the centerline at progress s0 (B,), cruising at 1
    (bench_mpcc.py:32-37), (B, 7)."""
    ref = track.interpolate(s0)
    one = torch.ones_like(s0)
    return torch.stack([ref["x"], ref["y"], ref["heading"], s0, one, 0.0 * one, one], dim=-1)


def seed_controls(track, cfg: MpccConfig, initial_progress):
    """The cold-start control seed rolled along the reference at v_ref
    (ipddp_mpcc_rc.py:500-521): (B, N, 3) from progress (B,)."""
    progress = initial_progress
    U = []
    for _ in range(cfg.horizon):
        ref = track.interpolate(progress)
        v_target = torch.clamp(torch.maximum(ref["v_ref"], ref["v_ref"].new_tensor(
            cfg.reference_speed)), cfg.speed_min, cfg.speed_max)
        steer = torch.clamp(torch.arctan(cfg.wheelbase * ref["curvature"]),
                            -cfg.delta_max, cfg.delta_max)
        v_theta = torch.clamp(v_target, cfg.v_theta_min, cfg.v_theta_max)
        U.append(torch.stack([v_target, steer, v_theta], dim=-1))
        progress = progress + cfg.dt * v_theta
    return torch.stack(U, dim=-2)


def build_problem(track, cfg: MpccConfig, x0):
    """The IPDDP problem of one tick from x0 (B, 7) on ``track``: a
    LocalTrack with a window per instance gives a batched objective."""
    device = x0.device
    model = KinematicBicycle7(wheelbase=cfg.wheelbase, dt=cfg.dt).to(device)
    batched = isinstance(track, LocalTrack) and track.center.dim() > 0
    objective = MpccObjective(batched=batched, track=track, cfg=cfg)
    prob = tt.problem(model, objective, x0, cfg.horizon, cfg.dt, device=device)
    lo = [cfg.speed_min, -cfg.delta_max, cfg.v_theta_min]
    hi = [cfg.speed_max, cfg.delta_max, cfg.v_theta_max]
    return prob.add_constraint("ControlConstraint", tt.control_constraint(
        lo, hi, device=device, dtype=x0.dtype))


def solver_options(cfg: MpccConfig) -> tt.CDDPOptions:
    if cfg.lqr_backend != "sequential":
        raise NotImplementedError(
            f"MpccConfig.lqr_backend={cfg.lqr_backend!r}: the port's IPDDP takes the "
            "sequential Riccati backward only")
    return tt.CDDPOptions(
        max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
        acceptable_tolerance=cfg.acceptable_tolerance,
        regularization=RegularizationOptions(initial_value=cfg.initial_regularization),
        line_search=LineSearchOptions(max_iterations=cfg.line_search_iters),
        use_ilqr=True, ipddp=tt.IPDDPOptions(lqr_backend=cfg.lqr_backend))


def solve_track(track: Track, cfg: MpccConfig, theta0):
    """What one tick's solves read: the Fourier track, or with
    ``track_eval="local"`` a LocalTrack window around each car's theta0
    (B,). Cast to theta0's dtype and device."""
    if cfg.track_eval == "local":
        reach = cfg.v_theta_max * cfg.horizon * cfg.dt
        trk = local_track_fit(track, theta0.to(track.fourier.dtype), reach,
                              n_coeffs=cfg.local_coeffs)
    else:
        trk = track
    return dataclasses.replace(trk, **{
        f.name: getattr(trk, f.name).to(dtype=theta0.dtype, device=theta0.device)
        for f in dataclasses.fields(trk)})


def _batched(x):
    return (x[None], True) if x.dim() == 1 else (x, False)


def mpc_tick(track: Track, cfg: MpccConfig, x_current, **solve_kw):
    """One cold-seeded IPDDP tick of a fleet (ipddp_mpcc_rc.py:629-661):
    x_current (B, 7) or (7,). Returns (the first controls, the Solution).
    ``solve_kw`` goes to ``ipddp.solve`` (``options=`` replaces the
    config's)."""
    x, single = _batched(x_current)
    trk = solve_track(track, cfg, x[:, IDX_THETA])
    prob = build_problem(trk, cfg, x)
    U0 = seed_controls(trk, cfg, x[:, IDX_THETA])
    options = solve_kw.pop("options", None) or solver_options(cfg)
    sol = ipddp.solve(prob, options, U0=U0, **solve_kw)
    if single:
        sol = sol.first()
        return sol.control_trajectory[0], sol
    return sol.control_trajectory[:, 0], sol


def run_mpc(track: Track, cfg: MpccConfig, n_ticks: int = 40):
    """The closed loop from ``initial_state``; (states, controls,
    iterations) as numpy arrays."""
    x = initial_state(track, cfg)
    model = KinematicBicycle7(wheelbase=cfg.wheelbase, dt=cfg.dt).to(x.device)
    xs, us, iters = [x.cpu().numpy()], [], []
    for _ in range(n_ticks):
        u, sol = mpc_tick(track, cfg, x)
        x = model.discrete_dynamics(x[None], u[None], 0.0, cfg.dt)[0]
        xs.append(x.cpu().numpy())
        us.append(u.cpu().numpy())
        iters.append(int(sol.iterations_completed))
    return np.stack(xs), np.stack(us), np.asarray(iters)


def batched_mpcc_step_costs(track: Track, cfg: MpccConfig, x_batch, **solve_kw):
    """A fleet tick: (u (B, 3), cost, iterations, status), one batch-first
    solve for the whole fleet."""
    u, sol = mpc_tick(track, cfg, x_batch, **solve_kw)
    return u, sol.final_objective, sol.iterations_completed, sol.status_code


def batched_mpc_step(track: Track, cfg: MpccConfig, x_batch):
    """A fleet tick: (u, cost, iterations)."""
    return batched_mpcc_step_costs(track, cfg, x_batch)[:3]


def mpc_tick_warm(track: Track, cfg: MpccConfig, x_current, U_prev, state,
                  options: Optional[tt.CDDPOptions] = None):
    """A warm-started tick (mpcc_lib.py:753-774): the previous plans shifted
    one step and the IPDDP state carried. Returns (u_apply, U_plan,
    new_state, iterations), batch-first."""
    trk = solve_track(track, cfg, x_current[:, IDX_THETA])
    prob = build_problem(trk, cfg, x_current)
    U0 = torch.cat([U_prev[:, 1:], U_prev[:, -1:]], dim=1)
    opts = (options or solver_options(cfg)).replace(warm_start=True)
    sol, st = ipddp.solve(prob, opts, U0=U0, state=state, return_state=True)
    U_plan = sol.control_trajectory
    return U_plan[:, 0], U_plan, st, sol.iterations_completed


def warm_fleet_step(track: Track, cfg: MpccConfig, x_batch, U_batch, states,
                    options: Optional[tt.CDDPOptions] = None):
    """One warm tick of the fleet and the plant's step (mpcc_lib.py:
    777-790): (x_next, U, states, iterations)."""
    model = KinematicBicycle7(wheelbase=cfg.wheelbase, dt=cfg.dt).to(x_batch.device)
    u, U_plan, st, iters = mpc_tick_warm(track, cfg, x_batch, U_batch, states, options)
    return model.discrete_dynamics(x_batch, u, 0.0, cfg.dt), U_plan, st, iters


def warm_fleet_init(track: Track, cfg: MpccConfig, x_batch,
                    options: Optional[tt.CDDPOptions] = None):
    """The warm fleet's first plans and solver states: one cold solve of the
    whole budget (mpcc_lib.py:793-798)."""
    trk = solve_track(track, cfg, x_batch[:, IDX_THETA])
    prob = build_problem(trk, cfg, x_batch)
    U0 = seed_controls(trk, cfg, x_batch[:, IDX_THETA])
    sol, st = ipddp.solve(prob, options or solver_options(cfg), U0=U0, return_state=True)
    return sol.control_trajectory, st
