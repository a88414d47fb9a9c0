"""Objectives (port of ``cddp_tpu/costs/objective.py``).

**QuadraticObjective** (:131-206 of the JAX package).

cost_k = (x - xref_k)' Q (x - xref_k) + u' R u with Q and R pre-scaled by
the timestep at construction (objective.cpp:37-39) and no 1/2 factor; the
terminal cost tracks ``reference_state`` with the unscaled Qf. Batch-first:
``x`` is (..., nx).

``reference_states`` is the optional per-step reference trajectory, (N, nx)
or (N+1, nx), one trajectory shared by every instance of a batch: step k's
running cost tracks row k (rows 0..N-1 only), and without it every step
tracks ``reference_state``. The running-cost functions take the step ``k``
as an int, or as a slice for an ``x`` whose axis -2 is the step axis
(``evaluate``, ``solvers/base.py::running_cost_derivatives``); a tracking
objective raises when no step is given, so no per-step loop can quietly
track the goal.

**ResidualObjective** (:62-128), the nonlinear least-squares cost of the
MPCC racing example: cost = sum r(x, u, k)^2 + extra per step, with
Gauss-Newton derivatives (gradient 2 J'r, Hessian 2 J'J) and the residual
Jacobians by forward-mode AD. **NonlinearObjective** (:209-230) takes
user cost callables and differentiates them by AD. Both write their cost
functions for ONE instance (``x`` (nx,), ``u`` (nu,)); the methods map them
over the batch-first axes of their inputs with ``torch.func.vmap``. With
``batched=True`` every tensor of the objective carries a leading instance
axis (B, ...), as a leaf-batched JAX objective does under ``vmap``, and
instance b reads row b of each: a fleet of MPCC cars, each with its own
track window, is one objective.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from cddp_tpu_torch import devices


@dataclass(frozen=True)
class QuadraticObjective:
    Q: torch.Tensor  # (nx, nx), already scaled by dt
    R: torch.Tensor  # (nu, nu), already scaled by dt
    Qf: torch.Tensor  # (nx, nx), unscaled
    reference_state: torch.Tensor  # (nx,)
    reference_states: Optional[torch.Tensor] = None  # (N, nx) or (N+1, nx)

    def replace(self, **kw) -> "QuadraticObjective":
        return dataclasses.replace(self, **kw)

    def running_reference(self, k):
        """Step ``k``'s running reference: (nx,) for an int ``k``, (n, nx)
        rows for a slice."""
        if self.reference_states is None:
            return self.reference_state
        if k is None:
            raise ValueError("a tracking objective's running cost needs its step k")
        return self.reference_states[k]

    def running_cost(self, x, u, k=None):
        e = x - self.running_reference(k)
        return ((e @ self.Q) * e).sum(-1) + ((u @ self.R) * u).sum(-1)

    def terminal_cost(self, x):
        e = x - self.reference_state
        return ((e @ self.Qf) * e).sum(-1)

    def evaluate(self, X, U):
        """Total cost of (..., N+1, nx), (..., N, nu) trajectories."""
        steps = slice(0, U.shape[-2])
        return self.running_cost(X[..., :-1, :], U, steps).sum(-1) + self.terminal_cost(
            X[..., -1, :]
        )

    # Analytic derivatives (objective.cpp:103-160): gradients 2Qe / 2Ru,
    # Hessians 2Q / 2R, zero cross term.
    def running_cost_gradients(self, x, u, k=None):
        e = x - self.running_reference(k)
        return e @ (2.0 * self.Q).T, u @ (2.0 * self.R).T

    def terminal_cost_gradient(self, x):
        return (x - self.reference_state) @ (2.0 * self.Qf).T

    def running_cost_hessians(self, x, u, k=None):
        batch = x.shape[:-1]
        nx, nu = self.Q.shape[0], self.R.shape[0]
        return (
            (2.0 * self.Q).expand(*batch, nx, nx),
            (2.0 * self.R).expand(*batch, nu, nu),
            self.Q.new_zeros(*batch, nu, nx),
        )

    def terminal_cost_hessian(self, x):
        nx = self.Qf.shape[0]
        return (2.0 * self.Qf).expand(*x.shape[:-1], nx, nx)


def quadratic_objective(Q, R, Qf, reference_state, timestep: float,
                        reference_states=None, *, device=None,
                        dtype=None) -> QuadraticObjective:
    """Build a QuadraticObjective with the reference's dt pre-scaling of Q
    and R (objective.cpp:37-39). Raises on non-square matrices and on a
    reference trajectory whose last row differs from ``reference_state``
    (objective.cpp:41-64). The tensors go to ``device``, the CUDA card when
    None."""
    device = devices.resolve(device)
    Q, R, Qf, ref = (torch.as_tensor(v, device=device, dtype=dtype)
                     for v in (Q, R, Qf, reference_state))
    for name, M in (("Q", Q), ("R", R), ("Qf", Qf)):
        if M.shape[0] != M.shape[1]:
            raise ValueError(f"{name} matrix must be square")
    if reference_states is not None:
        reference_states = torch.as_tensor(reference_states, device=device, dtype=ref.dtype)
        if float(torch.linalg.norm(reference_states[-1] - ref)) > 1e-6:
            raise ValueError("Last reference state must be same as the reference state")
    return QuadraticObjective(Q=Q * timestep, R=R * timestep, Qf=Qf,
                              reference_state=ref, reference_states=reference_states)


# --- objectives written for one instance ----------------------------------------


def _leaves(obj) -> list:
    """The tensors of a dataclass tree, depth first in field order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in _leaves(getattr(obj, f.name))]
    return []


def _with_leaves(obj, leaves: list):
    """``obj`` with its tensors replaced, in ``_leaves`` order, by ``leaves``
    (consumed from the front)."""
    if isinstance(obj, torch.Tensor):
        return leaves.pop(0)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _with_leaves(getattr(obj, f.name), leaves)
                                           for f in dataclasses.fields(obj)
                                           if _leaves(getattr(obj, f.name))})
    return obj


@dataclass(frozen=True)
class Objective:
    """An objective whose cost functions are written for one instance; the
    derivatives default to AD (objective.py:24-59 of the JAX package)."""

    batched: bool = False  # every tensor leaf has a leading instance axis

    # Subclasses: the costs of one instance.
    def instance_running_cost(self, x, u, k):
        raise NotImplementedError

    def instance_terminal_cost(self, x):
        raise NotImplementedError

    def _map(self, fn, x, u, k=None):
        """``fn(obj, x_i, u_i, k_i)`` of one instance over the leading axes
        of batch-first ``x``, ``u``: (B, d), or (B, n, d) with a step axis
        whose step indices are ``k`` (a slice; an int or None is passed as
        it is). A batched objective's instance b reads its leaves' row b."""
        if x.dim() == 1:
            return fn(self, x, u, k)
        leaves, in0 = _leaves(self), (0 if self.batched else None)

        def call(lv, xi, ui, ki):
            return fn(_with_leaves(self, list(lv)), xi, ui, ki)

        vmap = torch.func.vmap
        if x.dim() == 2:
            return vmap(lambda lv, xi, ui: call(lv, xi, ui, k),
                        in_dims=(in0, 0, 0))(leaves, x, u)
        if x.dim() != 3:
            raise ValueError(f"expected (B, d) or (B, n, d) inputs, got {tuple(x.shape)}")
        if isinstance(k, slice):
            ks = torch.arange(x.shape[1], device=x.device)[k]
            return vmap(vmap(call, in_dims=(None, 0, 0, 0)),
                        in_dims=(in0, 0, 0, None))(leaves, x, u, ks)
        return vmap(vmap(lambda lv, xi, ui: call(lv, xi, ui, k), in_dims=(None, 0, 0)),
                    in_dims=(in0, 0, 0))(leaves, x, u)

    def _map_terminal(self, fn, x):
        if x.dim() == 1:
            return fn(self, x)
        return torch.func.vmap(lambda lv, xi: fn(_with_leaves(self, list(lv)), xi),
                               in_dims=(0 if self.batched else None, 0))(_leaves(self), x)

    def running_cost(self, x, u, k=None):
        return self._map(lambda o, xi, ui, ki: o.instance_running_cost(xi, ui, ki), x, u, k=k)

    def terminal_cost(self, x):
        return self._map_terminal(lambda o, xi: o.instance_terminal_cost(xi), x)

    def evaluate(self, X, U):
        """Total cost of (..., N+1, nx), (..., N, nu) trajectories."""
        steps = slice(0, U.shape[-2])
        return (self.running_cost(X[..., :-1, :], U, steps).sum(-1)
                + self.terminal_cost(X[..., -1, :]))

    # AD derivatives of one instance (objective.py:40-59).
    def instance_running_gradients(self, x, u, k):
        lx = torch.func.grad(lambda xx: self.instance_running_cost(xx, u, k))(x)
        lu = torch.func.grad(lambda uu: self.instance_running_cost(x, uu, k))(u)
        return lx, lu

    def instance_running_hessians(self, x, u, k):
        lxx = torch.func.hessian(lambda xx: self.instance_running_cost(xx, u, k))(x)
        luu = torch.func.hessian(lambda uu: self.instance_running_cost(x, uu, k))(u)
        lux = torch.func.jacfwd(lambda uu: torch.func.grad(
            lambda xx: self.instance_running_cost(xx, uu, k))(x))(u).mT
        return lxx, luu, lux

    def instance_terminal_gradient(self, x):
        return torch.func.grad(self.instance_terminal_cost)(x)

    def instance_terminal_hessian(self, x):
        return torch.func.hessian(self.instance_terminal_cost)(x)

    def running_cost_gradients(self, x, u, k=None):
        return self._map(lambda o, xi, ui, ki: o.instance_running_gradients(xi, ui, ki),
                         x, u, k=k)

    def running_cost_hessians(self, x, u, k=None):
        return self._map(lambda o, xi, ui, ki: o.instance_running_hessians(xi, ui, ki),
                         x, u, k=k)

    def terminal_cost_gradient(self, x):
        return self._map_terminal(lambda o, xi: o.instance_terminal_gradient(xi), x)

    def terminal_cost_hessian(self, x):
        return self._map_terminal(lambda o, xi: o.instance_terminal_hessian(xi), x)


def _jac(fn, x):
    """jacfwd of fn at x, in x's dtype: forward-mode tangents through a
    product with a Python float come back in float64 (torch 2.13)."""
    return torch.func.jacfwd(fn)(x).to(x.dtype)


@dataclass(frozen=True)
class ResidualObjective(Objective):
    """Nonlinear least squares with Gauss-Newton derivatives (objective.py:
    62-128 of the JAX package): cost = sum(running_residuals**2) +
    running_cost_extra per step, and likewise at the terminal; gradient 2
    J'r (+ the extra's), Hessian 2 J'J (+ the extra's), the residual
    Jacobians J by ``torch.func.jacfwd``. Subclasses write the residuals
    of one instance."""

    def running_residuals(self, x, u, k):
        raise NotImplementedError

    def terminal_residuals(self, x):
        return x.new_zeros(0)

    def running_cost_extra(self, x, u, k):
        return x.new_zeros(())

    def terminal_cost_extra(self, x):
        return x.new_zeros(())

    def _has(self, name):
        return getattr(type(self), name) is not getattr(ResidualObjective, name)

    def instance_running_cost(self, x, u, k):
        r = self.running_residuals(x, u, k)
        return (r * r).sum() + self.running_cost_extra(x, u, k)

    def instance_terminal_cost(self, x):
        r = self.terminal_residuals(x)
        return (r * r).sum() + self.terminal_cost_extra(x)

    def _jacobians(self, x, u, k):
        r = self.running_residuals(x, u, k)
        Jx = _jac(lambda xx: self.running_residuals(xx, u, k), x)
        Ju = _jac(lambda uu: self.running_residuals(x, uu, k), u)
        return r, Jx, Ju

    def instance_running_gradients(self, x, u, k):
        r, Jx, Ju = self._jacobians(x, u, k)
        lx, lu = 2.0 * (Jx.mT @ r), 2.0 * (Ju.mT @ r)
        if self._has("running_cost_extra"):
            lx = lx + torch.func.grad(lambda xx: self.running_cost_extra(xx, u, k))(x)
            lu = lu + torch.func.grad(lambda uu: self.running_cost_extra(x, uu, k))(u)
        return lx, lu

    def instance_running_hessians(self, x, u, k):
        _, Jx, Ju = self._jacobians(x, u, k)
        lxx, luu, lux = 2.0 * (Jx.mT @ Jx), 2.0 * (Ju.mT @ Ju), 2.0 * (Ju.mT @ Jx)
        if self._has("running_cost_extra"):
            lxx = lxx + torch.func.hessian(lambda xx: self.running_cost_extra(xx, u, k))(x)
            luu = luu + torch.func.hessian(lambda uu: self.running_cost_extra(x, uu, k))(u)
        return lxx, luu, lux

    def instance_terminal_gradient(self, x):
        r = self.terminal_residuals(x)
        J = _jac(self.terminal_residuals, x)
        g = 2.0 * (J.mT @ r)
        if self._has("terminal_cost_extra"):
            g = g + torch.func.grad(self.terminal_cost_extra)(x)
        return g

    def instance_terminal_hessian(self, x):
        J = _jac(self.terminal_residuals, x)
        H = 2.0 * (J.mT @ J)
        if self._has("terminal_cost_extra"):
            H = H + torch.func.hessian(self.terminal_cost_extra)(x)
        return H


@dataclass(frozen=True)
class NonlinearObjective(Objective):
    """User cost callables of one instance, differentiated by AD
    (objective.py:209-230 of the JAX package): ``running_fn(x, u, k[,
    params])`` and ``terminal_fn(x[, params])``, ``params`` an optional
    tensor (per instance with ``batched=True``)."""

    running_fn: Optional[Callable] = None
    terminal_fn: Optional[Callable] = None
    params: Optional[torch.Tensor] = None

    def instance_running_cost(self, x, u, k):
        if self.params is not None:
            return self.running_fn(x, u, k, self.params)
        return self.running_fn(x, u, k)

    def instance_terminal_cost(self, x):
        if self.params is not None:
            return self.terminal_fn(x, self.params)
        return self.terminal_fn(x)
