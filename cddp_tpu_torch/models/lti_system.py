"""Discrete linear time-invariant system x+ = A x + B u.

Port of ``cddp_tpu/models/lti_system.py`` (reference ``lti_system.cpp``).
A and B are the discrete-time matrices, held as buffers. ``forward`` is
the finite difference (A x + B u - x) / timestep, from which the solvers'
Euler linearisation rebuilds A_d = I + dt Fx: close to A, but not its
bits, as in the JAX package. The system has no kernel lane (its shape
varies), so every kernel runs its plain version on it; shape-keyed
kernels (the Riccati backward) still take it.
"""

from __future__ import annotations

from typing import Optional

import torch

from cddp_tpu_torch import devices
from cddp_tpu_torch.models.base import DynamicalSystem


class LTISystem(DynamicalSystem):
    def __init__(self, A: torch.Tensor, B: torch.Tensor, timestep: float = 0.1,
                 integration_type: str = "euler"):
        super().__init__(integration_type)
        if A.dim() != 2 or A.shape[0] != A.shape[1]:
            raise ValueError("A matrix must be square")
        if B.dim() != 2 or B.shape[0] != A.shape[0]:
            raise ValueError("B matrix must have same number of rows as A")
        self.register_buffer("A", A)
        self.register_buffer("B", B)
        self.state_dim, self.control_dim = A.shape[0], B.shape[1]
        self.timestep = float(timestep)

    def discrete_dynamics(self, x, u, t, dt):
        return x @ self.A.mT + u @ self.B.mT

    def forward(self, x, u, t):
        return (self.discrete_dynamics(x, u, t, self.timestep) - x) / self.timestep


# The reference's fixed default system (lti_system.cpp:15-31): a
# skew-symmetric continuous A and its B.
_A_DEFAULT = [
    [0.0, 0.2473, -0.7933, 0.3470],
    [-0.2473, 0.0, -0.7667, 2.1307],
    [0.7933, 0.7667, 0.0, 0.3154],
    [-0.3470, -2.1307, -0.3154, 0.0],
]
_B_DEFAULT = [
    [-0.6387, -0.2026],
    [-0.4049, -0.1975],
    [2.3939, 1.5163],
    [-0.0496, -1.7322],
]


def lti_system(timestep: float, A=None, B=None, generator: Optional[torch.Generator] = None,
               state_dim: int = 4, control_dim: int = 2, device=None,
               dtype=None) -> LTISystem:
    """Build an LTISystem (lti_system.py:50-84 of the JAX package) on
    ``device``, the CUDA card when None, in ``dtype`` (float64 when None).

    - A and B given: taken as the already-discrete system (lti_system.cpp:33-44);
    - ``generator`` given: a random skew-symmetric continuous A, discretised
      by the matrix exponential, and B uniform in [-1, 1] scaled by dt, drawn
      from the generator (reproducible, unlike the reference's
      std::random_device);
    - neither: the reference's default 4x2 system, A = expm(dt A0), B = dt B0.
    """
    dev = devices.resolve(device)
    dtype = dtype or torch.float64
    if A is not None and B is not None:
        A, B = torch.as_tensor(A, dtype=dtype), torch.as_tensor(B, dtype=dtype)
    elif generator is not None:
        tri = torch.randn(state_dim, state_dim, generator=generator, dtype=torch.float64)
        skew = torch.triu(tri, 1)
        A = torch.linalg.matrix_exp(timestep * (skew - skew.T))
        B = timestep * (2.0 * torch.rand(state_dim, control_dim, generator=generator,
                                         dtype=torch.float64) - 1.0)
    else:
        A = torch.linalg.matrix_exp(timestep * torch.tensor(_A_DEFAULT, dtype=torch.float64))
        B = timestep * torch.tensor(_B_DEFAULT, dtype=torch.float64)
    return LTISystem(A.to(device=dev, dtype=dtype), B.to(device=dev, dtype=dtype), timestep)
