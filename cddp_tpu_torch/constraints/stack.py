"""Constraint stacking (port of ``cddp_tpu/constraints/stack.py``).

The reference's interior-point solvers iterate a name-sorted std::map and
concatenate each constraint's rows into one (m,) vector per step
(ipddp_solver.cpp:1365-1384). :class:`PathStacker` builds that layout once;
batch-first, its stacked values are (..., m), its Jacobians (..., m, nx) and
(..., m, nu) and its Hessians (..., m, nx, nx), (..., m, nu, nu) and
(..., m, nu, nx), one per (batch, step) point. A stack of affine items with
constant rows (boxes) gives its Jacobians as stride-0 broadcasts of one
copy, which the condensed backward kernel reads once.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _split_blocks(names, dims, stacked):
    out, off = {}, 0
    for name, d in zip(names, dims):
        out[name] = stacked[..., off:off + d]
        off += d
    return out


class PathStacker:
    """Stacked view of a problem's path constraints (static layout)."""

    def __init__(self, problem):
        self.items = problem.sorted_constraints()
        self.names: List[str] = [n for n, _ in self.items]
        self.dims: List[int] = [c.dual_dim for _, c in self.items]
        self.total_dim: int = sum(self.dims)

    def __bool__(self):
        return self.total_dim > 0

    @property
    def has_curved(self) -> bool:
        """True when a stacked constraint is non-affine (nonzero constraint
        Hessians): the trigger of the IPDDPOptions "auto" slack SOC and
        constraint-Hessian fold."""
        return any(not c.is_affine for _, c in self.items)

    def evaluate_shifted(self, x, u) -> torch.Tensor:
        """Stacked G = g(x, u) - ub, (B, m) (evaluateTrajectory,
        ipddp_solver.cpp:2252-2290); (B, 0) for an empty stack."""
        if not self.items:
            return x.new_zeros(*torch.broadcast_shapes(x.shape[:-1], u.shape[:-1]), 0)
        return torch.cat([c.evaluate_shifted(x, u) for _, c in self.items], dim=-1)

    def jacobian_rows(self, nx: int, nu: int):
        """Stacked constant (dG/dx (m, nx), dG/du (m, nu)) when every item's
        Jacobian is constant; None otherwise."""
        rows = [c.jacobian_rows(nx, nu) for _, c in self.items]
        if any(r is None for r in rows):
            return None
        return torch.cat([r[0] for r in rows]), torch.cat([r[1] for r in rows])

    def jacobians(self, x, u):
        """Stacked (dG/dx (..., m, nx), dG/du (..., m, nu)) at each point
        of x (..., nx), u (..., nu): broadcasts of ``jacobian_rows`` where
        those exist; zero rows for an empty stack."""
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        if not self.items:
            return x.new_zeros(*lead, 0, x.shape[-1]), x.new_zeros(*lead, 0, u.shape[-1])
        rows = self.jacobian_rows(x.shape[-1], u.shape[-1])
        if rows is not None:
            return tuple(r.expand(*lead, *r.shape) for r in rows)
        parts = [c.jacobians(x, u) for _, c in self.items]
        return (torch.cat([p[0] for p in parts], dim=-2),
                torch.cat([p[1] for p in parts], dim=-2))

    def hessians(self, x, u):
        """Stacked constraint Hessians at each point: (..., m, nx, nx),
        (..., m, nu, nu), (..., m, nu, nx)."""
        parts = [c.hessians(x, u) for _, c in self.items]
        return tuple(torch.cat([p[i] for p in parts], dim=-3) for i in range(3))

    def split(self, stacked: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-name blocks along the last axis (the Solution's dual and
        slack maps)."""
        return _split_blocks(self.names, self.dims, stacked)


class TerminalStacker:
    """Stacked terminal constraints, split into inequality and equality
    groups (getTerminalInequalityLayout / getTerminalEqualityLayout,
    ipddp_solver.cpp:52-117), each in name order. Refuses any other
    terminal type as the reference does (ipddp_solver.cpp:56-67). Values
    are (..., mT) and (..., p) at x_N (..., nx); both groups are affine, so
    their Jacobians are constant (mT, nx) and (p, nx) rows."""

    def __init__(self, problem):
        from cddp_tpu_torch.constraints.terminal import (
            TerminalEqualityConstraint,
            TerminalInequalityConstraint,
        )

        self.ineq_items, self.eq_items = [], []
        for name, c in problem.sorted_terminal_constraints():
            if isinstance(c, TerminalEqualityConstraint):
                self.eq_items.append((name, c))
            elif isinstance(c, TerminalInequalityConstraint):
                self.ineq_items.append((name, c))
            else:
                raise TypeError(
                    f"IPDDP: terminal constraint '{name}' has unsupported type. "
                    "Supported terminal constraints are TerminalEqualityConstraint "
                    "and TerminalInequalityConstraint.")
        self.ineq_names = [n for n, _ in self.ineq_items]
        self.ineq_dims = [c.dual_dim for _, c in self.ineq_items]
        self.ineq_dim = sum(self.ineq_dims)
        self.eq_names = [n for n, _ in self.eq_items]
        self.eq_dims = [c.dual_dim for _, c in self.eq_items]
        self.eq_dim = sum(self.eq_dims)

    @staticmethod
    def _evaluate(items, x):
        if not items:
            return x.new_zeros(*x.shape[:-1], 0)
        return torch.cat([c.evaluate(x) for _, c in items], dim=-1)

    @staticmethod
    def _rows(items, x):
        if not items:
            return x.new_zeros(0, x.shape[-1])
        return torch.cat([c.jacobian_rows() for _, c in items]).to(x.dtype)

    # --- inequalities: g_T(x_N) <= 0 stacked ------------------------------
    def ineq_evaluate(self, x) -> torch.Tensor:
        return self._evaluate(self.ineq_items, x)

    def ineq_jacobian(self, x) -> torch.Tensor:
        """The constant rows (mT, nx)."""
        return self._rows(self.ineq_items, x)

    def split_ineq(self, stacked) -> Dict[str, torch.Tensor]:
        return _split_blocks(self.ineq_names, self.ineq_dims, stacked)

    # --- equalities: h_T(x_N) = 0 stacked ---------------------------------
    def eq_evaluate(self, x) -> torch.Tensor:
        return self._evaluate(self.eq_items, x)

    def eq_jacobian(self, x) -> torch.Tensor:
        """The constant rows (p, nx)."""
        return self._rows(self.eq_items, x)

    def split_eq(self, stacked) -> Dict[str, torch.Tensor]:
        return _split_blocks(self.eq_names, self.eq_dims, stacked)
