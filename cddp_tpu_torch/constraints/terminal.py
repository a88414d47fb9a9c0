"""Terminal constraints on x_N (port of ``cddp_tpu/constraints/terminal.py``).

Rebuild of ``terminal_constraint.hpp``: IPDDP takes exactly these two types
and refuses others (``constraints/stack.py::TerminalStacker``,
ipddp_solver.cpp:56-67). Batch-first: ``x`` is (..., nx), values (..., p),
Jacobians (..., p, nx) and Hessians (..., p, nx, nx). Both types are
affine in x_N, so their Jacobians are constant rows (``jacobian_rows``) and
their Hessians zero; control derivatives are zero by construction
(terminal_constraint.hpp:29-60).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cddp_tpu_torch.constraints.path import _tensors


class TerminalConstraint:
    """Terminal constraint g(x_N) (terminal.py:16-38)."""

    is_equality = False

    @property
    def dual_dim(self) -> int:
        raise NotImplementedError

    def evaluate(self, x):
        raise NotImplementedError

    def jacobian_rows(self) -> torch.Tensor:
        """The constant Jacobian rows (p, nx)."""
        raise NotImplementedError

    def state_jacobian(self, x):
        rows = self.jacobian_rows().to(x.dtype)
        return rows.expand(*x.shape[:-1], *rows.shape)

    def state_hessian(self, x):
        n = x.shape[-1]
        return x.new_zeros(*x.shape[:-1], self.dual_dim, n, n)

    def upper_bound(self):
        return self.jacobian_rows().new_zeros(self.dual_dim)

    def violation_from_value(self, g):
        raise NotImplementedError

    def violation(self, x):
        return self.violation_from_value(self.evaluate(x))


@dataclass(frozen=True)
class TerminalEqualityConstraint(TerminalConstraint):
    """g(x_N) = x_N - target = 0 (terminal_constraint.hpp:62-158).
    Violation = ||g||_2."""

    target_state: torch.Tensor  # (nx,)
    is_equality = True

    @property
    def dual_dim(self) -> int:
        return self.target_state.shape[0]

    def evaluate(self, x):
        return x - self.target_state

    def jacobian_rows(self):
        n = self.target_state.shape[0]
        return torch.eye(n, dtype=self.target_state.dtype, device=self.target_state.device)

    def violation_from_value(self, g):
        return torch.linalg.vector_norm(g, dim=-1)


@dataclass(frozen=True)
class TerminalInequalityConstraint(TerminalConstraint):
    """g(x_N) = A x_N - b <= 0 (terminal_constraint.hpp:160-263).
    Violation = sum of positive parts."""

    A: torch.Tensor  # (m, nx)
    b: torch.Tensor  # (m,)

    @property
    def dual_dim(self) -> int:
        return self.A.shape[0]

    def evaluate(self, x):
        return x @ self.A.mT - self.b

    def jacobian_rows(self):
        return self.A

    def violation_from_value(self, g):
        return torch.clamp(g, min=0.0).sum(-1)


def terminal_equality_constraint(target_state, *, device=None,
                                 dtype=None) -> TerminalEqualityConstraint:
    """x_N = target_state; tensors go to ``device``, the CUDA card when None."""
    (target_state,) = _tensors(device, dtype, target_state)
    return TerminalEqualityConstraint(target_state=target_state)


def terminal_inequality_constraint(A_N, b_N, *, device=None,
                                   dtype=None) -> TerminalInequalityConstraint:
    """A_N x_N <= b_N; tensors go to ``device``, the CUDA card when None."""
    A_N, b_N = _tensors(device, dtype, A_N, b_N)
    if A_N.shape[0] != b_N.shape[0]:
        raise ValueError("TerminalInequalityConstraint: A_N rows and b_N size mismatch.")
    return TerminalInequalityConstraint(A=A_N, b=b_N)
