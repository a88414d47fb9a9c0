"""Relaxed log-barrier penalty (port of ``cddp_tpu/constraints/barrier.py:30-110``).

``RelaxedLogBarrier`` (barrier.hpp:37-301):

    beta_delta(z) = -log(z)                                        if z > delta
                    0.5*[((z - 2 delta)/delta)^2 - 1] - log(delta)  otherwise

applied to both sides of lower <= g(x, u) <= upper, infinite bounds masked
out. Batch-first: ``x`` is (..., nx), ``u`` (..., nu) and the barrier
coefficient broadcasts against the leading axes (one mu per instance).
LogDDP takes box stacks only, whose Jacobians are constant rows and whose
constraint Hessians are zero, so the curvature term beta' * d2g of the JAX
package's ``hessians`` vanishes and is not formed. ``log(delta)`` is taken in float64 on the host and rounded
once to the working type, as the whole-solve kernel takes it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def beta_derivatives(z, delta: float):
    """(beta, beta', beta'') of the relaxed log-barrier
    (barrier.hpp:calculate_beta_derivatives, :274-296), with the
    z <= 1e-12 guard on the log branch."""
    z_log = torch.clamp(z, min=1e-12)
    log_val = -torch.log(z_log)
    log_p = -1.0 / z_log
    log_pp = 1.0 / (z_log * z_log)

    term = (z - 2.0 * delta) / z.new_tensor(delta)
    quad_val = 0.5 * (term * term - 1.0) - math.log(delta)
    quad_p = term / z.new_tensor(delta)
    quad_pp = torch.full_like(z, 1.0) / z.new_tensor(delta * delta)

    use_log = z > delta
    return (torch.where(use_log, log_val, quad_val),
            torch.where(use_log, log_p, quad_p),
            torch.where(use_log, log_pp, quad_pp))


@dataclass(frozen=True)
class RelaxedLogBarrier:
    barrier_coeff: torch.Tensor  # mu, broadcast against the leading axes
    relaxation_delta: float = 1e-1

    def _sides(self, constraint, g):
        L = constraint.lower_bound()
        U = constraint.upper_bound()
        finite_L, finite_U = torch.isfinite(L), torch.isfinite(U)
        # Masked distances; masked-out entries use z = 1 and are zeroed after.
        s_L = torch.where(finite_L, g - L, torch.ones_like(g))
        s_U = torch.where(finite_U, U - g, torch.ones_like(g))
        bL = beta_derivatives(s_L, self.relaxation_delta)
        bU = beta_derivatives(s_U, self.relaxation_delta)
        return (bL, finite_L.to(g.dtype)), (bU, finite_U.to(g.dtype))

    def evaluate(self, constraint, x, u):
        """Total barrier penalty (barrier.hpp:61-91), (...,)."""
        g = constraint.evaluate(x, u)
        (bL, mL), (bU, mU) = self._sides(constraint, g)
        return self.barrier_coeff * (bL[0] * mL + bU[0] * mU).sum(-1)

    def _jacobians(self, constraint, x, u):
        return constraint.jacobian_rows(x.shape[-1], u.shape[-1])

    def gradients(self, constraint, x, u):
        """(dB/dx (..., nx), dB/du (..., nu)) through the constraint
        Jacobians (barrier.hpp:101-145)."""
        g = constraint.evaluate(x, u)
        Gx, Gu = self._jacobians(constraint, x, u)
        (bL, mL), (bU, mU) = self._sides(constraint, g)
        dcost_dg = bL[1] * mL - bU[1] * mU  # (..., m)
        mu = self.barrier_coeff[..., None]
        return mu * (dcost_dg @ Gx), mu * (dcost_dg @ Gu)

    def hessians(self, constraint, x, u):
        """(Hxx, Huu, Hux): the Gauss-Newton term beta'' J'J
        (barrier.hpp:152-235)."""
        g = constraint.evaluate(x, u)
        Gx, Gu = self._jacobians(constraint, x, u)
        (bL, mL), (bU, mU) = self._sides(constraint, g)
        term1 = (bL[2] * mL + bU[2] * mU)[..., None]  # beta'' coefficients
        mu = self.barrier_coeff[..., None, None]
        return (mu * (Gx.mT @ (term1 * Gx)), mu * (Gu.mT @ (term1 * Gu)),
                mu * (Gu.mT @ (term1 * Gx)))
