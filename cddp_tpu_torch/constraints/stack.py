"""Constraint stacking (port of ``cddp_tpu/constraints/stack.py``).

The reference's interior-point solvers iterate a name-sorted std::map and
concatenate each constraint's rows into one (m,) vector per step
(ipddp_solver.cpp:1365-1384). :class:`PathStacker` builds that layout once;
batch-first, its stacked values are (B, m) and its Jacobians, constant for
the box constraints the port carries, (m, nx) and (m, nu).
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
        """True when a stacked constraint is non-affine (none of the port's
        box constraints is)."""
        return any(not c.is_affine for _, c in self.items)

    def evaluate_shifted(self, x, u) -> torch.Tensor:
        """Stacked G = g(x, u) - ub, (B, m) (evaluateTrajectory,
        ipddp_solver.cpp:2252-2290)."""
        return torch.cat([c.evaluate_shifted(x, u) for _, c in self.items], dim=-1)

    def jacobians(self, nx: int, nu: int):
        """Stacked constant (dG/dx (m, nx), dG/du (m, nu))."""
        gx = torch.cat([c.state_jacobian(nx, nu) for _, c in self.items])
        gu = torch.cat([c.control_jacobian(nx, nu) for _, c in self.items])
        return gx, gu

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
