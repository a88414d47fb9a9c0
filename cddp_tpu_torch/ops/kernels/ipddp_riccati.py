"""Condensed IPDDP backward pass: CUDA kernel and plain version.

Replaces ``cddp_tpu/ops/pallas/ipddp_riccati.py::make_ipddp_backward_kernel``
(the streamed condensed backward over a (batch, time) grid). One step is
the path-constraint regime of ipddp_solver.cpp:1380-1509 with iLQR
Hessians: the Q-expansion with the dual term, the condensation
Sigma = clip(y / s_safe, 0, cap), the regularized gain solve with its
leading-minors positive-definiteness check (failed instances get zero
control gains, as ``linalg.solve_and_check`` gives), the closed-form dual
and slack gains and the value update. The CUDA kernel
(``ops/csrc/ipddp_backward.cu``, step in ``ops/csrc/ipddp_step.cuh``) gives
each instance one thread, which walks the horizon backwards with the value
function in registers. It reads every input where it lies, from its batch,
step and value strides (``operand_strides``): the wrapper copies nothing,
and an input broadcast over the batch (the cost Hessians, the constraint
Jacobians) is read from its one copy. Its outputs are batch-last arrays,
returned as batch-first views: the forward kernel, which reads the gains
next, takes them batch-last without a copy.

**Engine choice differs from the JAX package.** There this kernel is opt-in
(``backward_engine="fused"``): on the TPU the custom-call boundary inside
the solver loop cost more than the kernel saved. In the port
``backward_engine`` "auto" and "fused" both launch it on CUDA tensors and
"scan" runs the plain recursion; the per-pass driver has no such boundary
cost to avoid, and the plain recursion is ~100 small torch launches per step.

The barrier-ratio cap is 1e6 in float32 and 1e12 in float64
(``solvers/ipddp.py::max_ratio``), in the kernel as in the plain version.

Batch-first in and out: A (B,N,nx,nx), Bm (B,N,nx,nu), lx (B,N,nx), lu
(B,N,nu), lxx (B,N,nx,nx), luu (B,N,nu,nu), lux (B,N,nu,nx), Y/S/G (B,N,m),
Gx (B,N,m,nx), Gu (B,N,m,nu), Vx (B,nx), Vxx (B,nx,nx), mu/reg (B,) ->
(k_u (B,N,nu), K_u (B,N,nu,nx), k_y (B,N,m), K_y (B,N,m,nx), k_s, K_s,
Vx_seq (B,N,nx), Vxx_seq (B,N,nx,nx), stats (B,7) = [dV0, dV1, inf_du,
inf_pr, inf_comp, step_norm, ok]).
"""

from __future__ import annotations

import ctypes

import torch

from cddp_tpu_torch.ops import linalg
from cddp_tpu_torch.ops.kernels import dispatch_log, operands

EPS_SLACK = 1e-10
# (nx, nu, m) the kernel is instantiated for: the unicycle with a control
# box, a state box, both, or a control box and a keep-out ball (m = 5, whose
# per-step Jacobians and folded lxx the kernel reads materialised); the
# pendulum with its control box; the car with its control box (4x2, m = 4);
# the quadrotor (13x4) and QuadrotorRate (10x4) with their rotor or thrust
# and rate boxes (m = 8); the attitude trio with its torque box (6x3 and
# 7x3, m = 6); the spacecraft models with their control boxes (8x3x6,
# 10x3x6, 6x2x4; SpacecraftTwobody and HCW's box share 6x3x6); DubinsCar
# and the acrobot with their one control's box (3x1x2, 4x1x2; the bicycle
# and DreyfusRocket share 4x2x4 and 2x1x2).
# Never at m = 0: a problem without path constraints runs the plain
# recursion, as the JAX gate requires m > 0 (ipddp.py:547).
KERNEL_SHAPES = ((3, 2, 4), (3, 2, 5), (3, 2, 6), (3, 2, 10), (2, 1, 2), (4, 2, 4),
                 (13, 4, 8), (10, 4, 8), (6, 3, 6), (7, 3, 6), (8, 3, 6), (10, 3, 6),
                 (6, 2, 4), (3, 1, 2), (4, 1, 2))


def dispatch_name(nx: int, nu: int, m: int) -> str:
    """The kernel's ``dispatch_log`` name: "ipddp_backward", and
    "@<nx>x<nu>x<m>" after it for a shape other than the unicycle's."""
    return "ipddp_backward" + ("" if (nx, nu) == (3, 2) else f"@{nx}x{nu}x{m}")

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# Inputs with a step axis: (B, N, ...) for the first 12, (B, ...) after.
STEP_OPERANDS = 12


def max_ratio(dtype) -> float:
    """Barrier-ratio clip (ipddp.py:64-73): 1e12 in float64, else 1e6."""
    return 1e12 if dtype == torch.float64 else 1e6


def _mT(M):
    return M.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _sym(M):
    return 0.5 * (M + _mT(M))


def s_safe(s, mu):
    """max(s, max(mu * 1e-3, EPS_SLACK)), mu (B,) against s (B, m)."""
    return torch.maximum(s, torch.maximum(mu * 1e-3, mu.new_tensor(EPS_SLACK))[:, None])


def condense_path(y, s, g, mu):
    """Per-step condensation (ipddp.py:353-362): (s_safe, sigma, primal
    residual, complementarity residual, rhat, S^-1 rhat), rows (B, m)."""
    cap = max_ratio(y.dtype)
    ss = s_safe(s, mu)
    sigma = torch.clamp(y / ss, 0.0, cap)
    pr = g + s
    comp = y * s - mu[:, None]
    rhat = y * pr - comp
    return ss, sigma, pr, comp, rhat, torch.clamp(rhat / ss, -cap, cap)


def path_gains(y, ss, sigma, pr, rhat, Gx, Gu, k_u, K_u):
    """Closed-form dual and slack gains from the control gains
    (ipddp.py:365-375): (k_y, K_y, k_s, K_s)."""
    cap = max_ratio(y.dtype)
    temp = _mv(Gu, k_u)
    GuKu = Gu @ K_u
    k_y = torch.clamp((rhat + y * temp) / ss, -cap, cap)
    K_y = torch.clamp(sigma[..., None] * (Gx + GuKu), -cap, cap)
    return k_y, K_y, -pr - temp, -Gx - GuKu


def condensed_step(A, Bm, lx, lu, lxx, luu, lux, y, s, g, Gx, Gu, Vx, Vxx, mu, reg):
    """One condensed Riccati step for a batch (ipddp.py:416-464). Returns
    (k_u, K_u, k_y, K_y, k_s, K_s, Vx, Vxx, dV step (B,2), Qu_c, primal
    residual, complementarity residual, fail). Without path rows (m = 0)
    the condensation's terms are empty and are not formed: adding them
    would add exact zeros."""
    At, Bt = _mT(A), _mT(Bm)
    Qxx = lxx + At @ Vxx @ A
    Qux = lux + Bt @ Vxx @ A
    Quu = luu + Bt @ Vxx @ Bm
    eye_u = torch.eye(Bm.shape[-1], dtype=A.dtype, device=A.device)
    path = y.shape[-1] > 0
    if path:
        Gxt, Gut = _mT(Gx), _mT(Gu)
        Qx = lx + _mv(Gxt, y) + _mv(At, Vx)
        Qu = lu + _mv(Gut, y) + _mv(Bt, Vx)
        ss, sigma, pr, comp, rhat, sir = condense_path(y, s, g, mu)
        sGx, sGu = sigma[..., None] * Gx, sigma[..., None] * Gu
        Quu_reg = _sym(Quu) + Gut @ sGu + reg[:, None, None] * eye_u
        rhs_k = Qu + _mv(Gut, sir)
        rhs_K = Qux + Gut @ sGx
    else:
        Qx, Qu = lx + _mv(At, Vx), lu + _mv(Bt, Vx)
        pr = comp = y
        Quu_reg = _sym(Quu) + reg[:, None, None] * eye_u
        rhs_k, rhs_K = Qu, Qux
    kK, pd_ok = linalg.solve_and_check(Quu_reg, torch.cat([rhs_k[..., None], rhs_K], -1))
    k_u, K_u = -kK[..., 0], -kK[..., 1:]
    # Condensed expansions folded back (ipddp_solver.cpp:1488-1509).
    Qu_c, Qux_c = rhs_k, rhs_K
    if path:
        k_y, K_y, k_s, K_s = path_gains(y, ss, sigma, pr, rhat, Gx, Gu, k_u, K_u)
        Qx_c = Qx + _mv(Gxt, sir)
        Qxx_c = Qxx + Gxt @ sGx
        Quu_c = Quu + Gut @ sGu
    else:
        k_y, K_y, k_s, K_s = y, Gx, y, Gx
        Qx_c, Qxx_c, Quu_c = Qx, Qxx, Quu
    dV = torch.stack([(k_u * Qu_c).sum(-1),
                      (_mv(_mT(Quu_c), 0.5 * k_u) * k_u).sum(-1)], dim=-1)
    Kt = _mT(K_u)
    Vx_new = Qx_c + _mv(Kt, Qu_c) + _mv(_mT(Qux_c), k_u) + _mv(Kt @ Quu_c, k_u)
    Vxx_new = _sym(Qxx_c + Kt @ Qux_c + _mT(Qux_c) @ K_u + Kt @ Quu_c @ K_u)
    return (k_u, K_u, k_y, K_y, k_s, K_s, Vx_new, Vxx_new, dV, Qu_c, pr, comp,
            ~pd_ok)


def maxabs(v):
    """The largest |entry| over the last axis, 0 where it is empty
    (ipddp.py:93-97 of the JAX package)."""
    return v.abs().amax(-1) if v.shape[-1] else v.new_zeros(v.shape[:-1])


def ipddp_backward_plain(A, Bm, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu, Vx, Vxx,
                         mu, reg):
    """Reverse recursion of ``ipddp.py::_condensed_scan_single``, batch-first;
    at m = 0 (no path constraints) the plain Riccati recursion."""
    Bsz, N = A.shape[0], A.shape[1]
    outs = [[None] * N for _ in range(8)]
    zero = A.new_zeros(Bsz)
    dV = A.new_zeros(Bsz, 2)
    inf_du, inf_pr, inf_comp, step_norm = zero, zero, zero, zero
    ok = torch.ones(Bsz, dtype=torch.bool, device=A.device)
    for t in reversed(range(N)):
        (k_u, K_u, k_y, K_y, k_s, K_s, Vx, Vxx, dV_t, Qu_c, pr, comp,
         fail) = condensed_step(A[:, t], Bm[:, t], lx[:, t], lu[:, t], lxx[:, t],
                                luu[:, t], lux[:, t], Y[:, t], S[:, t], G[:, t],
                                Gx[:, t], Gu[:, t], Vx, Vxx, mu, reg)
        for o, v in zip(outs, (k_u, K_u, k_y, K_y, k_s, K_s, Vx, Vxx)):
            o[t] = v
        dV = dV + dV_t
        inf_du = torch.maximum(inf_du, Qu_c.abs().amax(-1))
        inf_pr = torch.maximum(inf_pr, maxabs(pr))
        inf_comp = torch.maximum(inf_comp, maxabs(comp))
        step_norm = torch.maximum(step_norm, k_u.abs().amax(-1))
        ok = ok & ~fail
    stats = torch.stack([dV[:, 0], dV[:, 1], inf_du, inf_pr, inf_comp, step_norm,
                         ok.to(A.dtype)], dim=-1)
    return tuple(torch.stack(o, 1) for o in outs) + (stats,)


def ipddp_backward(*args):
    """CUDA tensors launch the kernel; CPU tensors run the plain version."""
    A = args[0]
    if A.device.type == "cpu":
        dispatch_log.plain(dispatch_name(A.shape[-1], args[1].shape[-1], args[7].shape[-1]),
                           A.shape[0])
        return ipddp_backward_plain(*args)
    return _launch(*args)


def inner_shapes(nx, nu, m):
    """Each input's shape after its batch (and step) axis."""
    return ((nx, nx), (nx, nu), (nx,), (nu,), (nx, nx), (nu, nu), (nu, nx), (m,), (m,),
            (m,), (m, nx), (m, nu), (nx,), (nx, nx), (), ())


def operand_strides(ins):
    """The kernel's view of its 16 inputs (``operands.operand_strides``):
    each one's (batch stride, step stride, value stride) in elements, the
    step stride 0 for Vx, Vxx, mu and reg, which have no step axis. A batch
    or step stride of 0 is a broadcast, read from one copy; the value
    stride is 1 for a dense batch-first tensor and B for a batch-last view
    (``movedim`` of a (..., B) tensor, as the forward kernel returns its
    duals and slacks). Raises ValueError where the values of one instance
    and step are not evenly spaced."""
    return operands.operand_strides("ipddp_backward", ins, STEP_OPERANDS)


def _launch(A, Bm, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu, Vx, Vxx, mu, reg):
    from cddp_tpu_torch.ops.kernels import build

    ins = (A, Bm, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu, Vx, Vxx, mu, reg)
    Bsz, N, nx = A.shape[0], A.shape[1], A.shape[2]
    nu, m = Bm.shape[-1], Y.shape[-1]
    shapes = inner_shapes(nx, nu, m)
    tag = build.dtype_tag("ipddp_backward", ins, [
        ((N,) if k < STEP_OPERANDS else ()) + s for k, s in enumerate(shapes)])
    strides = operand_strides(ins)
    name = f"cddp_ipddp_backward_{nx}x{nu}x{m}_{tag}"
    fn = build.function(name, _ARGTYPES)
    outs = [A.new_empty(*shape, Bsz) for shape in (
        (N, nu), (N, nu, nx), (N, m), (N, m, nx), (N, m), (N, m, nx), (N, nx),
        (N, nx, nx), (7,))]
    err = fn(operands.pointers(ins), operands.strides_array(strides), operands.pointers(outs),
             N, Bsz, build.stream_ptr(A.device))
    build.check(err, name)
    dispatch_log.launched(dispatch_name(nx, nu, m), Bsz)
    return tuple(t.movedim(-1, 0) for t in outs)
