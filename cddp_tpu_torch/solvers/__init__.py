"""Solver registry (port of ``cddp_tpu/solvers/__init__.py``)."""

from __future__ import annotations

from typing import Callable


def get_solver(name: str) -> Callable:
    if name in ("CLDDP", "CLCDDP", "CDDP", "iLQR"):
        from cddp_tpu_torch.solvers import clddp

        return clddp.solve
    if name == "IPDDP":
        from cddp_tpu_torch.solvers import ipddp

        return ipddp.solve
    if name in ("LogDDP", "LOGDDP"):
        from cddp_tpu_torch.solvers import logddp

        return logddp.solve
    if name == "MSIPDDP":
        from cddp_tpu_torch.solvers import msipddp

        return msipddp.solve
    raise ValueError(
        f"Unknown solver {name!r}. Available: ['CLDDP', 'LogDDP', 'IPDDP', 'MSIPDDP']"
    )
