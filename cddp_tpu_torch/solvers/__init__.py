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
    if name in ("LogDDP", "LOGDDP", "MSIPDDP"):
        raise NotImplementedError(f"solver {name!r} is not yet ported to cddp_tpu_torch")
    raise ValueError(
        f"Unknown solver {name!r}. Available: ['CLDDP', 'LogDDP', 'IPDDP', 'MSIPDDP']"
    )
