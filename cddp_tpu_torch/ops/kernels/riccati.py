"""Control-limited Riccati backward pass: CUDA kernel and plain version.

Replaces ``cddp_tpu/ops/pallas/riccati.py::make_backward_kernel`` (the
streamed backward over a (batch, time) grid). The CUDA kernel walks each
instance's horizon backwards in one of two forms. Where one thread's step
fits its registers (``KERNEL_SHAPES`` but ``TEAM_SHAPES``;
``ops/csrc/riccati_backward.cuh``) each instance takes one thread, its
value function in registers; at the small shapes (nx nu <= 8) the block
stages four steps of its instances' operands at a time in shared memory,
at nu = 3 each thread reads its own in place. Where one thread spilled its
step to local memory (``TEAM_SHAPES``: 13x4, 10x4, 10x3;
``ops/csrc/riccati_team.cuh``) each instance takes a team of 16 lanes of
one warp: lane r owns row r of Vxx, Qxx and the value update, the
products go through shared memory, and the 3^nu BoxQP active sets are
dealt to the lanes, the first valid one taken as the serial walk takes it.

The wrapper copies nothing (``operands.operand_strides``): the kernel
reads every input where it lies, from its batch, step and value strides,
and an input broadcast over the batch (the quadratic cost's Hessians, the
terminal Hessian) from its one copy. Its outputs are batch-last arrays,
returned as batch-first views: the line-search rollout reads them
batch-last without a copy. An input whose values are not evenly spaced
raises ValueError. On an NVIDIA H100 the wrapper's time is the kernel's
(PERF.md §6).

Both entry points take batch-first tensors: A (B,N,nx,nx), Bm (B,N,nx,nu),
lx (B,N,nx), lu (B,N,nu), lxx (B,N,nx,nx), luu (B,N,nu,nu), lux (B,N,nu,nx),
lb/ub (B,N,nu) (bounds already shifted by -u), Vx (B,nx), Vxx (B,nx,nx),
reg (B,); and return (k (B,N,nu), K (B,N,nu,nx), dV (B,2), Qu_err (B,),
norm_Vx without the terminal |Vx|_1 (B,), ok (B,) bool).
"""

from __future__ import annotations

import ctypes

import torch

from cddp_tpu_torch.ops.boxqp import BoxQPStatus, boxqp_solve_enum, solve_masked_free
from cddp_tpu_torch.ops.kernels import dispatch_log, operands

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# Inputs with a step axis: (B, N, ...) for the first 9, (B, ...) after.
STEP_OPERANDS = 9
# (nx, nu) the kernel is instantiated for: the unicycle, the pendulum and
# the cart-pole of the model registry, the car's and the default
# LTISystem's 4x2, the quadrotor's 13x4, QuadrotorRate's 10x4, and the
# attitude trio's 6x3 (Euler angles, MRPs) and 7x3 (the quaternion), and the
# spacecraft models' 8x3 (SpacecraftLinearFuel), 10x3 (SpacecraftNonlinear)
# and 6x2 (SpacecraftLanding2D; HCW shares 6x3), and DubinsCar's 3x1 (the
# bicycle, DreyfusRocket and the acrobot share 4x2, 2x1 and 4x1). The
# kernel reads A and B, so any model of these shapes takes it (the JAX gate
# is nu <= 4 alone, riccati.py:491-497) but those of LEFT_OUT_MODELS.
KERNEL_SHAPES = ((3, 2), (2, 1), (4, 1), (4, 2), (13, 4), (10, 4), (6, 3), (7, 3), (8, 3),
                 (10, 3), (6, 2), (3, 1))
# The shapes whose step one thread spilled to local memory (ptxas on an
# NVIDIA H100: 12,944 bytes a thread at 13x4, 1,488 at 10x4, 1,240 at
# 10x3), and the lanes of the team that takes each instance there. At 8x3
# one thread took 16 bytes, the frame of float division's slow path, and
# stays one thread: its team took 1.3x its time (PERF.md §6).
TEAM_SHAPES = {(13, 4): 16, (10, 4): 16, (10, 3): 16}
# Registered models (``rollout.ModelEntry.cuda_name``) whose CLDDP runs the
# plain Riccati recursion although their shape is in KERNEL_SHAPES: float32
# cannot carry SpacecraftTwobody's recursion (states near 7000 km, velocity
# weights of 1e4) even at its MPC horizon N = 20. On 1,024 of its fleet's
# operands on an NVIDIA H100 80GB HBM3 the kernel left float64 by more than
# 1e-2 (scaled) on 34.2% of the instances at N = 20 and 100% at N = 100,
# the plain version on 32.2% and 100%, where the kernel is held to 2%
# (ROADMAP C.13).
LEFT_OUT_MODELS = ("sc_twobody",)


def dispatch_name(nx: int, nu: int) -> str:
    """The kernel's ``dispatch_log`` name at (nx, nu): "riccati_backward",
    and "@<nx>x<nu>" after it for every shape but the unicycle's."""
    return "riccati_backward" + ("" if (nx, nu) == (3, 2) else f"@{nx}x{nu}")


def _mT(M):
    return M.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def q_expansion(A, Bm, lx, lu, lxx, luu, lux, Vx, Vxx):
    """(Qx, Qu, Qxx, Qux, Quu) of one step, batch-first (clddp_solver.cpp:115-121)."""
    return (lx + _mv(_mT(A), Vx), lu + _mv(_mT(Bm), Vx),
            lxx + _mT(A) @ Vxx @ A, lux + _mT(Bm) @ Vxx @ A,
            luu + _mT(Bm) @ Vxx @ Bm)


def value_update(Qx, Qu, Qxx, Qux, Quu, k, K):
    """(dV step (B,2), Vx, Vxx) after the gains k, K (clddp_solver.cpp:180-193)."""
    dV = torch.stack([(Qu * k).sum(-1), (_mv(_mT(Quu), 0.5 * k) * k).sum(-1)], dim=-1)
    Vx = Qx + _mv(_mT(K) @ Quu, k) + _mv(_mT(Qux), k) + _mv(_mT(K), Qu)
    Vxx = Qxx + _mT(K) @ Quu @ K + _mT(Qux) @ K + _mT(K) @ Qux
    return dV, Vx, 0.5 * (Vxx + _mT(Vxx))


def riccati_backward_plain(A, Bm, lx, lu, lxx, luu, lux, lb, ub, Vx, Vxx, reg):
    """Reverse recursion with the exact enum BoxQP; port of
    ``riccati.py::_scan_backward_single`` (clddp_solver.cpp:96-203)."""
    Bsz, N = A.shape[0], A.shape[1]
    nu = Bm.shape[-1]
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
    ks, Ks = [None] * N, [None] * N
    dV = A.new_zeros(Bsz, 2)
    qerr = A.new_zeros(Bsz)
    nvx = A.new_zeros(Bsz)
    ok = torch.ones(Bsz, dtype=torch.bool, device=A.device)
    for t in reversed(range(N)):
        Qx, Qu, Qxx, Qux, Quu = q_expansion(
            A[:, t], Bm[:, t], lx[:, t], lu[:, t], lxx[:, t], luu[:, t],
            lux[:, t], Vx, Vxx)
        qp = boxqp_solve_enum(Quu + reg[:, None, None] * eye_u, Qu, lb[:, t], ub[:, t])
        fail = (qp.status == BoxQPStatus.HESSIAN_NOT_PD) | (
            qp.status == BoxQPStatus.NO_DESCENT
        )
        ks[t], Ks[t] = qp.x, -solve_masked_free(qp.Hfree, Qux, qp.free)
        dV_t, Vx, Vxx = value_update(Qx, Qu, Qxx, Qux, Quu, ks[t], Ks[t])
        dV = dV + dV_t
        qerr = torch.maximum(qerr, Qu.abs().amax(-1))
        nvx = nvx + Vx.abs().sum(-1)
        ok = ok & ~fail
    return torch.stack(ks, 1), torch.stack(Ks, 1), dV, qerr, nvx, ok


def riccati_backward(A, Bm, lx, lu, lxx, luu, lux, lb, ub, Vx, Vxx, reg):
    """CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if A.device.type == "cpu":
        dispatch_log.plain(dispatch_name(A.shape[-1], Bm.shape[-1]), A.shape[0])
        return riccati_backward_plain(A, Bm, lx, lu, lxx, luu, lux, lb, ub,
                                      Vx, Vxx, reg)
    return _launch(A, Bm, lx, lu, lxx, luu, lux, lb, ub, Vx, Vxx, reg)


def operand_strides(ins):
    """The kernel's view of its 12 inputs (``operands.operand_strides``):
    each one's (batch, step, value) strides, the step stride 0 for Vx, Vxx
    and reg; raises ValueError where the values of one instance and step
    are not evenly spaced."""
    return operands.operand_strides("riccati_backward", ins, STEP_OPERANDS)


def _launch(A, Bm, lx, lu, lxx, luu, lux, lb, ub, Vx, Vxx, reg):
    from cddp_tpu_torch.ops.kernels import build

    ins = (A, Bm, lx, lu, lxx, luu, lux, lb, ub, Vx, Vxx, reg)
    Bsz, N, nx = A.shape[0], A.shape[1], A.shape[2]
    nu = Bm.shape[-1]
    tag = build.dtype_tag("riccati_backward", ins, (
        (N, nx, nx), (N, nx, nu), (N, nx), (N, nu), (N, nx, nx), (N, nu, nu),
        (N, nu, nx), (N, nu), (N, nu), (nx,), (nx, nx), ()))
    strides = operand_strides(ins)
    name = f"cddp_riccati_backward_{nx}x{nu}_{tag}"
    fn = build.function(name, _ARGTYPES)
    k, K, dV, stats = (A.new_empty(*shape, Bsz) for shape in ((N, nu), (N, nu, nx), (2,), (3,)))
    err = fn(operands.pointers(ins), operands.strides_array(strides),
             operands.pointers((k, K, dV, stats)), N, Bsz, build.stream_ptr(A.device))
    build.check(err, name)
    dispatch_log.launched(dispatch_name(nx, nu), Bsz)
    return (k.movedim(-1, 0), K.movedim(-1, 0), dV.movedim(-1, 0), stats[0],
            stats[1], stats[2] > 0.5)
