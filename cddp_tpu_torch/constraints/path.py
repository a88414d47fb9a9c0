"""Box path constraints (port of ``cddp_tpu/constraints/path.py:91-177``).

CLDDP reads the raw bounds for its BoxQP (clddp_solver.cpp:147-148) and
clamps rollouts to them (:237-240). The interior-point solvers see each box
as the one-sided inequality g(x, u) <= ub of the reference
(constraint.hpp:144-251):

    g = scale * [-v; v] <= scale * [-lower; upper],

and work with the shifted value G = g - ub <= 0, whose Jacobians are the
constant rows -scale / +scale. Batch-first: ``x`` is (B, nx), ``u`` (B, nu).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cddp_tpu_torch import devices


@dataclass(frozen=True)
class _BoxConstraint:
    lower: torch.Tensor  # (n,)
    upper: torch.Tensor  # (n,)
    scale_factor: float = 1.0

    is_affine = True

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

    def lower_bound(self):
        """-inf on every row of the doubled form (path.py:49-50): the
        relaxed log-barrier masks that side out."""
        return torch.full_like(self.upper_bound(), float("-inf"))

    def evaluate_shifted(self, x, u):
        """G = g - ub, (B, 2n)."""
        return self.evaluate(x, u) - self.upper_bound()

    def _rows(self, n):
        """[-scale*I; scale*I], (2n, n): the Jacobian of g in its variable."""
        eye = torch.eye(n, dtype=self.upper.dtype, device=self.upper.device)
        eye = eye * self.scale_factor
        return torch.cat([-eye, eye], dim=0)

    def _zeros(self, n):
        return self.upper.new_zeros(self.dual_dim, n)


class ControlConstraint(_BoxConstraint):
    """Control box bounds."""

    def _var(self, x, u):
        return u

    def state_jacobian(self, nx: int, nu: int):
        return self._zeros(nx)

    def control_jacobian(self, nx: int, nu: int):
        return self._rows(nu)


class StateConstraint(_BoxConstraint):
    """State box bounds."""

    def _var(self, x, u):
        return x

    def state_jacobian(self, nx: int, nu: int):
        return self._rows(nx)

    def control_jacobian(self, nx: int, nu: int):
        return self._zeros(nu)


def _box(cls, lower, upper, scale_factor, device, dtype):
    device = devices.resolve(device)
    return cls(lower=torch.as_tensor(lower, device=device, dtype=dtype),
               upper=torch.as_tensor(upper, device=device, dtype=dtype),
               scale_factor=float(scale_factor))


def control_constraint(lower, upper, scale_factor: float = 1.0, *, device=None,
                       dtype=None) -> ControlConstraint:
    """A control box; its tensors go to ``device``, the CUDA card when None."""
    return _box(ControlConstraint, lower, upper, scale_factor, device, dtype)


def state_constraint(lower, upper, scale_factor: float = 1.0, *, device=None,
                     dtype=None) -> StateConstraint:
    """A state box; its tensors go to ``device``, the CUDA card when None."""
    return _box(StateConstraint, lower, upper, scale_factor, device, dtype)
