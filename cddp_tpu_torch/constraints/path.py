"""Path constraints (port of ``cddp_tpu/constraints/path.py``).

Every constraint is the one-sided inequality of the reference
(constraint.hpp):

    g(x, u) <= ub            (lower bound -inf)

and the interior-point solvers work with the shifted value G = g - ub <= 0.
Each constraint gives ``evaluate``, ``upper_bound``, ``lower_bound``, its
Jacobians and Hessians and ``violation_from_value``. Batch-first: ``x`` is
(..., nx), ``u`` (..., nu), values (..., m), Jacobians (..., m, nx) and
(..., m, nu), Hessians (..., m, nx, nx), (..., m, nu, nu) and (..., m, nu, nx).
Jacobians and Hessians default to forward-mode autodiff of ``evaluate``
(``torch.func.jacfwd``, one point at a time under ``torch.func.vmap``);
analytic forms replace them where the reference has them.

Boxes (control and state) are affine: their Jacobians are the constant rows
-scale / +scale (``jacobian_rows``), their Hessians zero. CLDDP reads their
raw bounds for its BoxQP and clamps rollouts to them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.func import jacfwd, vmap

from cddp_tpu_torch import devices


def _lead(x, u):
    """The broadcast leading (batch, step) shape of x and u."""
    return torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])


def _per_point(fn, x, u):
    """``fn(x_i, u_i)`` of single points, over every leading index of
    (x, u)."""
    lead = _lead(x, u)
    xf = x.expand(*lead, x.shape[-1]).reshape(-1, x.shape[-1])
    uf = u.expand(*lead, u.shape[-1]).reshape(-1, u.shape[-1])
    out = vmap(fn)(xf, uf)
    return out.reshape(*lead, *out.shape[1:])


class PathConstraint:
    """Stagewise constraint g(x, u) <= ub (path.py:28-90)."""

    @property
    def dual_dim(self) -> int:
        raise NotImplementedError

    @property
    def is_affine(self) -> bool:
        """True when g is affine in (x, u): zero constraint Hessians, and
        the IPDDPOptions "auto" gates keep the slack SOC and the
        constraint-Hessian fold out. Curved unless a type says otherwise."""
        return False

    def evaluate(self, x, u):
        raise NotImplementedError

    def upper_bound(self):
        raise NotImplementedError

    def lower_bound(self):
        """-inf on every row: the relaxed log-barrier masks that side out."""
        return torch.full_like(self.upper_bound(), float("-inf"))

    def evaluate_shifted(self, x, u):
        """G = g - ub, (..., m)."""
        return self.evaluate(x, u) - self.upper_bound()

    def jacobian_rows(self, nx: int, nu: int):
        """The constant Jacobian rows ((m, nx), (m, nu)) of a constraint
        whose Jacobians do not depend on (x, u); None otherwise."""
        return None

    def _zeros(self, x, u, *inner):
        return x.new_zeros(*_lead(x, u), self.dual_dim, *inner)

    def state_jacobian(self, x, u):
        return _per_point(jacfwd(self.evaluate, argnums=0), x, u)

    def control_jacobian(self, x, u):
        return _per_point(jacfwd(self.evaluate, argnums=1), x, u)

    def jacobians(self, x, u):
        return self.state_jacobian(x, u), self.control_jacobian(x, u)

    def state_hessian(self, x, u):
        return _per_point(jacfwd(jacfwd(self.evaluate, argnums=0), argnums=0), x, u)

    def control_hessian(self, x, u):
        return _per_point(jacfwd(jacfwd(self.evaluate, argnums=1), argnums=1), x, u)

    def cross_hessian(self, x, u):
        """d2g / du dx, (..., m, nu, nx)."""
        return _per_point(jacfwd(jacfwd(self.evaluate, argnums=0), argnums=1),
                          x, u).transpose(-1, -2)

    def hessians(self, x, u):
        return self.state_hessian(x, u), self.control_hessian(x, u), self.cross_hessian(x, u)

    def violation_from_value(self, g):
        """Violation (...,) of raw values g (..., m): the sum of the
        positive parts of g - ub (the BoxConstraint rule,
        constraint.hpp:240-243)."""
        return torch.clamp(g - self.upper_bound(), min=0.0).sum(-1)


class _Affine(PathConstraint):
    """Affine constraints: constant Jacobian rows, zero Hessians."""

    @property
    def is_affine(self) -> bool:
        return True

    def state_jacobian(self, x, u):
        gx, _ = self.jacobian_rows(x.shape[-1], u.shape[-1])
        return gx.expand(*_lead(x, u), *gx.shape)

    def control_jacobian(self, x, u):
        _, gu = self.jacobian_rows(x.shape[-1], u.shape[-1])
        return gu.expand(*_lead(x, u), *gu.shape)

    def state_hessian(self, x, u):
        return self._zeros(x, u, x.shape[-1], x.shape[-1])

    def control_hessian(self, x, u):
        return self._zeros(x, u, u.shape[-1], u.shape[-1])

    def cross_hessian(self, x, u):
        return self._zeros(x, u, u.shape[-1], x.shape[-1])


@dataclass(frozen=True)
class _BoxConstraint(_Affine):
    """BoxConstraint<Var> (constraint.hpp:144-251): lower <= v <= upper as
    the doubled one-sided form g = scale * [-v; v] <= scale * [-lower; upper]."""

    lower: torch.Tensor  # (n,)
    upper: torch.Tensor  # (n,)
    scale_factor: float = 1.0

    @property
    def dual_dim(self) -> int:
        return 2 * self.upper.shape[0]

    def _var(self, x, u):
        raise NotImplementedError

    def clamp(self, v: torch.Tensor) -> torch.Tensor:
        """Project onto the raw box (constraint.hpp:225-228); NaN propagates,
        as in ``jnp.clip``."""
        return torch.minimum(torch.maximum(v, self.lower), self.upper)

    def evaluate(self, x, u):
        v = self._var(x, u)
        return torch.cat([-v, v], dim=-1) * self.scale_factor

    def upper_bound(self):
        return torch.cat([-self.lower, self.upper]) * self.scale_factor

    def _rows(self, n):
        """[-scale*I; scale*I], (2n, n): the Jacobian of g in its variable."""
        eye = torch.eye(n, dtype=self.upper.dtype, device=self.upper.device)
        eye = eye * self.scale_factor
        return torch.cat([-eye, eye], dim=0)

    def _no_rows(self, n):
        return self.upper.new_zeros(self.dual_dim, n)


class ControlConstraint(_BoxConstraint):
    """Control box bounds."""

    def _var(self, x, u):
        return u

    def jacobian_rows(self, nx: int, nu: int):
        return self._no_rows(nx), self._rows(nu)


class StateConstraint(_BoxConstraint):
    """State box bounds."""

    def _var(self, x, u):
        return x

    def jacobian_rows(self, nx: int, nu: int):
        return self._rows(nx), self._no_rows(nu)


@dataclass(frozen=True)
class LinearConstraint(_Affine):
    """A x <= b (constraint.hpp:253-311). ``scale_factor`` is stored and, as
    in the reference, never read."""

    A: torch.Tensor  # (m, nx)
    b: torch.Tensor  # (m,)
    scale_factor: float = 1.0

    @property
    def dual_dim(self) -> int:
        return self.b.shape[0]

    def evaluate(self, x, u):
        return x @ self.A.mT

    def upper_bound(self):
        return self.b

    def jacobian_rows(self, nx: int, nu: int):
        return self.A, self.A.new_zeros(self.A.shape[0], nu)

    def violation_from_value(self, g):
        # The reference's orientation, kept (constraint.hpp:303-306):
        # max(0, max(b - g)).
        return torch.clamp((self.b - g).amax(-1), min=0.0)


@dataclass(frozen=True)
class BallConstraint(PathConstraint):
    """Keep-out ball -scale ||x[:d] - c||^2 <= -scale r^2
    (constraint.hpp:313-404); d is the center's length."""

    radius: torch.Tensor  # ()
    center: torch.Tensor  # (d,)
    scale_factor: float = 1.0

    @property
    def dual_dim(self) -> int:
        return 1

    @property
    def dim(self) -> int:
        return self.center.shape[0]

    def evaluate(self, x, u):
        diff = x[..., :self.dim] - self.center
        return -self.scale_factor * (diff * diff).sum(-1, keepdim=True)

    def upper_bound(self):
        return -self.scale_factor * (self.radius * self.radius)[None]

    def state_jacobian(self, x, u):
        # Analytic (constraint.hpp:355-370).
        jac = self._zeros(x, u, x.shape[-1])
        jac[..., 0, :self.dim] = -2.0 * self.scale_factor * (x[..., :self.dim] - self.center)
        return jac

    def control_jacobian(self, x, u):
        return self._zeros(x, u, u.shape[-1])

    def state_hessian(self, x, u):
        # Analytic (constraint.hpp:380-392).
        H = self._zeros(x, u, x.shape[-1], x.shape[-1])
        eye = torch.eye(self.dim, dtype=x.dtype, device=x.device)
        H[..., 0, :self.dim, :self.dim] = -2.0 * self.scale_factor * eye
        return H

    def control_hessian(self, x, u):
        return self._zeros(x, u, u.shape[-1], u.shape[-1])

    def cross_hessian(self, x, u):
        return self._zeros(x, u, u.shape[-1], x.shape[-1])

    def violation_from_value(self, g):
        # Positive inside the keep-out ball: g - ub > 0.
        return torch.clamp(g[..., 0] - self.upper_bound()[0], min=0.0)


_AXES = {"x": 0, "X": 0, "y": 1, "Y": 1, "z": 2, "Z": 2}


@dataclass(frozen=True)
class PoleConstraint(PathConstraint):
    """Keep-out cylinder by signed distance, -scale sd(x[:3]) <= 0
    (constraint.hpp:406-623); its Jacobians and Hessians by autodiff."""

    center: torch.Tensor  # (3,)
    radius: torch.Tensor  # ()
    length: torch.Tensor  # ()
    axis_index: int = 2
    scale_factor: float = 1.0

    @property
    def dual_dim(self) -> int:
        return 1

    def evaluate(self, x, u):
        axis = torch.eye(3, dtype=x.dtype, device=x.device)[self.axis_index]
        diff = x[..., :3] - self.center
        d_axis = diff @ axis
        radial = diff - d_axis[..., None] * axis
        d_rad = torch.sqrt((radial * radial).sum(-1) + 1e-30)
        dx = d_rad - self.radius
        dy = d_axis.abs() - 0.5 * self.length
        zero = torch.zeros_like(dx)
        outside = torch.sqrt(torch.maximum(dx, zero) ** 2 + torch.maximum(dy, zero) ** 2)
        inside = torch.maximum(dx, dy)
        sd = torch.where((dx > 0.0) | (dy > 0.0), outside, inside)
        return (-self.scale_factor * sd)[..., None]

    def upper_bound(self):
        return self.center.new_zeros(1)

    def control_jacobian(self, x, u):
        return self._zeros(x, u, u.shape[-1])

    def violation_from_value(self, g):
        return torch.clamp(g[..., 0], min=0.0)


@dataclass(frozen=True)
class SecondOrderConeConstraint(PathConstraint):
    """cos(fov) sqrt(||p - o||^2 + eps) - (p - o) . axis <= 0, p = x[:3]
    (constraint.hpp:626-806); its Jacobians and Hessians by autodiff."""

    origin: torch.Tensor  # (3,)
    axis: torch.Tensor  # (3,), unit opening direction
    cos_fov: torch.Tensor  # ()
    epsilon: float = 1e-6

    @property
    def dual_dim(self) -> int:
        return 1

    def evaluate(self, x, u):
        v = x[..., :3] - self.origin
        reg_norm = torch.sqrt((v * v).sum(-1) + self.epsilon)
        return (reg_norm * self.cos_fov - v @ self.axis)[..., None]

    def upper_bound(self):
        return self.origin.new_zeros(1)

    def control_jacobian(self, x, u):
        return self._zeros(x, u, u.shape[-1])

    def violation_from_value(self, g):
        return torch.clamp(g[..., 0], min=0.0)


def _norm_hessian(u, epsilon):
    """(s I - u u') / s^1.5, s = ||u||^2 + eps: the Hessian of the
    eps-regularized norm, (..., nu, nu)."""
    s = (u * u).sum(-1)[..., None, None] + epsilon
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    return (s * eye - u[..., :, None] * u[..., None, :]) / s ** 1.5


@dataclass(frozen=True)
class ThrustMagnitudeConstraint(PathConstraint):
    """[min - ||u||; ||u|| - max] <= 0 (constraint.hpp:808-934); Jacobian
    and Hessian of the eps-regularized norm, as the reference takes them."""

    min_thrust: torch.Tensor  # ()
    max_thrust: torch.Tensor  # ()
    epsilon: float = 1e-6

    @property
    def dual_dim(self) -> int:
        return 2

    def evaluate(self, x, u):
        n = torch.linalg.vector_norm(u, dim=-1)
        return torch.stack([self.min_thrust - n, n - self.max_thrust], dim=-1)

    def upper_bound(self):
        return self.max_thrust.new_zeros(2)

    def state_jacobian(self, x, u):
        return self._zeros(x, u, x.shape[-1])

    def control_jacobian(self, x, u):
        row = u / torch.sqrt((u * u).sum(-1, keepdim=True) + self.epsilon)
        return torch.stack([-row, row], dim=-2).expand(*_lead(x, u), 2, u.shape[-1])

    def state_hessian(self, x, u):
        return self._zeros(x, u, x.shape[-1], x.shape[-1])

    def control_hessian(self, x, u):
        H = _norm_hessian(u, self.epsilon)
        return torch.stack([-H, H], dim=-3).expand(*_lead(x, u), 2, *H.shape[-2:])

    def cross_hessian(self, x, u):
        return self._zeros(x, u, u.shape[-1], x.shape[-1])

    def violation_from_value(self, g):
        return torch.clamp(g[..., 0], min=0.0) + torch.clamp(g[..., 1], min=0.0)


@dataclass(frozen=True)
class MaxThrustMagnitudeConstraint(PathConstraint):
    """||u|| - max <= 0 (constraint.hpp:936-1048)."""

    max_thrust: torch.Tensor  # ()
    epsilon: float = 1e-6

    @property
    def dual_dim(self) -> int:
        return 1

    def evaluate(self, x, u):
        return (torch.linalg.vector_norm(u, dim=-1) - self.max_thrust)[..., None]

    def upper_bound(self):
        return self.max_thrust.new_zeros(1)

    def state_jacobian(self, x, u):
        return self._zeros(x, u, x.shape[-1])

    def control_jacobian(self, x, u):
        row = u / torch.sqrt((u * u).sum(-1, keepdim=True) + self.epsilon)
        return row[..., None, :].expand(*_lead(x, u), 1, u.shape[-1])

    def state_hessian(self, x, u):
        return self._zeros(x, u, x.shape[-1], x.shape[-1])

    def control_hessian(self, x, u):
        H = _norm_hessian(u, self.epsilon)
        return H[..., None, :, :].expand(*_lead(x, u), 1, *H.shape[-2:])

    def cross_hessian(self, x, u):
        return self._zeros(x, u, u.shape[-1], x.shape[-1])

    def violation_from_value(self, g):
        return torch.clamp(g[..., 0], min=0.0)


# --- builders: tensors go to ``device``, the CUDA card when None ----------------


def _tensors(device, dtype, *values):
    device = devices.resolve(device)
    return [torch.as_tensor(v, device=device, dtype=dtype) for v in values]


def _box(cls, lower, upper, scale_factor, device, dtype):
    lower, upper = _tensors(device, dtype, lower, upper)
    return cls(lower=lower, upper=upper, scale_factor=float(scale_factor))


def control_constraint(lower, upper, scale_factor: float = 1.0, *, device=None,
                       dtype=None) -> ControlConstraint:
    """A control box."""
    return _box(ControlConstraint, lower, upper, scale_factor, device, dtype)


def state_constraint(lower, upper, scale_factor: float = 1.0, *, device=None,
                     dtype=None) -> StateConstraint:
    """A state box."""
    return _box(StateConstraint, lower, upper, scale_factor, device, dtype)


def linear_constraint(A, b, scale_factor: float = 1.0, *, device=None,
                      dtype=None) -> LinearConstraint:
    A, b = _tensors(device, dtype, A, b)
    return LinearConstraint(A=A, b=b, scale_factor=float(scale_factor))


def ball_constraint(radius, center, scale_factor: float = 1.0, *, device=None,
                    dtype=None) -> BallConstraint:
    radius, center = _tensors(device, dtype, radius, center)
    return BallConstraint(radius=radius, center=center, scale_factor=float(scale_factor))


def pole_constraint(center, direction: str, radius, length, scale_factor: float = 1.0,
                    *, device=None, dtype=None) -> PoleConstraint:
    if direction not in _AXES:
        raise ValueError("Direction must be 'x', 'y', or 'z'.")
    center, radius, length = _tensors(device, dtype, center, radius, length)
    return PoleConstraint(center=center, radius=radius, length=length,
                          axis_index=_AXES[direction], scale_factor=float(scale_factor))


def second_order_cone_constraint(cone_origin, opening_direction, cone_angle_fov,
                                 regularization_epsilon=1e-6, *, device=None,
                                 dtype=None) -> SecondOrderConeConstraint:
    if not 0.0 <= float(cone_angle_fov) <= math.pi:
        raise ValueError("Cone angle must be between 0 and PI.")
    if regularization_epsilon <= 0:
        raise ValueError("Regularization epsilon must be positive.")
    origin, d, fov = _tensors(device, dtype or torch.get_default_dtype(), cone_origin,
                              opening_direction, cone_angle_fov)
    n = torch.linalg.vector_norm(d)
    if float(n) == 0.0:
        raise ValueError("Opening direction cannot be zero vector.")
    return SecondOrderConeConstraint(origin=origin, axis=d / n, cos_fov=torch.cos(fov),
                                     epsilon=regularization_epsilon)


def thrust_magnitude_constraint(min_thrust_norm, max_thrust_norm, epsilon=1e-6, *,
                                device=None, dtype=None) -> ThrustMagnitudeConstraint:
    if float(min_thrust_norm) < 0.0:
        raise ValueError("min_thrust_norm must be non-negative.")
    if float(max_thrust_norm) < float(min_thrust_norm):
        raise ValueError("max_thrust_norm must be >= min_thrust_norm.")
    if epsilon <= 0.0:
        raise ValueError("epsilon must be positive.")
    lo, hi = _tensors(device, dtype, min_thrust_norm, max_thrust_norm)
    return ThrustMagnitudeConstraint(min_thrust=lo, max_thrust=hi, epsilon=epsilon)


def max_thrust_magnitude_constraint(max_thrust_norm, epsilon=1e-6, *, device=None,
                                    dtype=None) -> MaxThrustMagnitudeConstraint:
    if float(max_thrust_norm) < 0.0:
        raise ValueError("max_thrust_norm must be non-negative.")
    if epsilon <= 0.0:
        raise ValueError("epsilon must be positive.")
    (hi,) = _tensors(device, dtype, max_thrust_norm)
    return MaxThrustMagnitudeConstraint(max_thrust=hi, epsilon=epsilon)
