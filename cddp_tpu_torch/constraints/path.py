"""Control box constraint (port of ``cddp_tpu/constraints/path.py:133,164``).

CLDDP reads the raw bounds for its BoxQP (clddp_solver.cpp:147-148) and
clamps rollouts to them (:237-240).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ControlConstraint:
    lower: torch.Tensor  # (nu,)
    upper: torch.Tensor  # (nu,)

    def clamp(self, u: torch.Tensor) -> torch.Tensor:
        """Project onto the box (constraint.hpp:225-228); NaN propagates,
        as in ``jnp.clip``."""
        return torch.minimum(torch.maximum(u, self.lower), self.upper)


def control_constraint(lower, upper, *, device=None,
                       dtype=None) -> ControlConstraint:
    return ControlConstraint(
        lower=torch.as_tensor(lower, device=device, dtype=dtype),
        upper=torch.as_tensor(upper, device=device, dtype=dtype),
    )
