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
        ipddp_solver.cpp:2252-2290)."""
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
        those exist."""
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
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
    """Stacked terminal constraints. The port carries none yet: building a
    stacker for a problem with terminal constraints raises."""

    ineq_dim = 0
    eq_dim = 0

    def __init__(self, problem):
        if getattr(problem, "terminal_constraints", None):
            raise NotImplementedError(
                "terminal constraints are not yet ported to cddp_tpu_torch")
