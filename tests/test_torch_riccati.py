"""The port's plain Riccati backward pass (the CUDA kernel's plain version)
against the JAX streamed backward kernel in interpret mode and its scan
reference (CPU, float64), and the kernel's view of its operands
(``riccati.operand_strides``) on the per-pass CLDDP driver's real inputs,
whose cost Hessians are broadcasts with stride 0, on batch-last views and
on an operand whose values are not evenly spaced (which raises)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.ops.pallas.riccati import _scan_backward_single, clddp_backward_fused
from cddp_tpu.solvers import base as jbase
import cddp_tpu_torch as tt
from cddp_tpu_torch.ops.kernels import build, dispatch_log, riccati
from cddp_tpu_torch.ops.kernels.riccati import riccati_backward, riccati_backward_plain
from test_torch_foundation import flagship_jax, port_problem

torch.set_num_threads(1)

B, N = 4, 8


def _inputs(seed, reg_scale):
    """Stage data linearized about random trajectories of the flagship
    problem, batch-first, as numpy arrays."""
    prob = flagship_jax(horizon=N)
    cc = prob.get_constraint("ControlConstraint")
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.uniform(-1.0, 2.0, size=(B, N + 1, 3)))
    U = jnp.asarray(rng.uniform(-1.5, 1.5, size=(B, N, 2)))

    def one(Xi, Ui):
        A, Bm = jbase.discrete_jacobians(prob, Xi, Ui)
        lx, lu, lxx, luu, lux = jbase.running_cost_derivatives(prob, Xi, Ui)
        return (A, Bm, lx, lu, lxx, luu, lux, cc.lower - Ui, cc.upper - Ui,
                prob.objective.terminal_cost_gradient(Xi[-1]),
                prob.objective.terminal_cost_hessian(Xi[-1]))

    args = [np.asarray(a) for a in jax.vmap(one)(X, U)]
    reg = reg_scale * rng.uniform(0.5, 2.0, size=B)
    return args + [reg]


@pytest.mark.parametrize("reg_scale", [1e-6, 1e-2, -3.0], ids=["reg1e-6", "reg1e-2", "indefinite"])
def test_plain_backward_matches_jax_kernel_and_scan(reg_scale):
    args = _inputs(seed=int(abs(reg_scale) * 1e6) % 97, reg_scale=reg_scale)
    got = riccati_backward_plain(*(torch.as_tensor(a) for a in args))
    kern = clddp_backward_fused(*(jnp.asarray(a) for a in args), interpret=True)
    scan = jax.vmap(_scan_backward_single)(*(jnp.asarray(a) for a in args))
    for want in (kern, scan):
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 5:  # ok flags
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                           atol=1e-9, err_msg=f"output {i}")
    if reg_scale < 0:
        assert not got[5].any()  # the indefinite case reaches the failure path
    else:
        assert got[5].all()


def test_wrapper_runs_plain_on_cpu_and_never_falls_back():
    args = [torch.as_tensor(a) for a in _inputs(seed=3, reg_scale=1e-6)]
    dispatch_log.reset()
    got = riccati_backward(*args)
    assert not dispatch_log.launches  # plain version, no kernel
    for g, w in zip(got, riccati_backward_plain(*args)):
        assert torch.equal(g, w)
    # Any other device must launch the kernel or raise: never the plain path.
    with pytest.raises(ValueError, match="CUDA"):
        riccati_backward(*(a.to("meta") for a in args))


# --- the kernel's view of its operands ---------------------------------------------

# lxx and luu: the quadratic cost's Hessians, which the objective expands
# (both strides 0); Vxx: the terminal Hessian (batch stride 0).
BROADCAST = (4, 5)


def driver_inputs(shape=(3, 2), seed=5):
    """The Riccati backward's inputs as the per-pass CLDDP driver builds them
    (``clddp._backward_pass``) about random trajectories, float64, CPU: the
    unicycle's box fleet, or at (13, 4) the quadrotor's rotor box."""
    from cddp_tpu_torch.solvers import base

    kw = dict(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    if shape == (3, 2):
        prob = port_problem(flagship_jax(horizon=N))
    else:
        model = tt.quadrotor(1.0, [[0.01, 0, 0], [0, 0.01, 0], [0, 0, 0.02]], 0.2, "euler",
                             device="cpu", dtype=torch.float64)
        obj = tt.quadratic_objective(torch.eye(13), torch.eye(4) * 0.1, torch.eye(13) * 10.0,
                                     [0.0] * 13, 0.02, **kw)
        prob = tt.problem(model, obj, torch.zeros(13), N, 0.02, {
            "ControlConstraint": tt.control_constraint([0.0] * 4, [4.0] * 4, **kw)}, **kw)
    nx, nu = shape
    X = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, N + 1, nx)))
    U = torch.as_tensor(rng.uniform(0.5, 1.5, (B, N, nu)))
    cc = prob.get_constraint("ControlConstraint")
    A, Bm = base.discrete_jacobians(prob, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(prob, X, U)
    return (A, Bm, lx, lu, lxx, luu, lux, cc.lower - U, cc.upper - U,
            prob.objective.terminal_cost_gradient(X[:, -1]),
            prob.objective.terminal_cost_hessian(X[:, -1]),
            torch.as_tensor(rng.uniform(1e-6, 1e-4, B)))


SHAPES = [(3, 2), (13, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_driver_operands_are_read_where_they_lie(shape):
    # The cost Hessians are one copy (both strides 0) and the terminal
    # Hessian one copy for the batch; every other input is per instance,
    # dense batch-first, so the kernel stages its rows block-cooperatively.
    ins = driver_inputs(shape)
    strides = riccati.operand_strides(ins)
    for k, (t, (bs, ts, vs)) in enumerate(zip(ins, strides)):
        if k in BROADCAST:
            assert (bs, ts) == (0, 0), k
        elif k == 10:
            assert bs == 0, k
        else:
            assert bs != 0, k
        assert ts == (0 if k >= riccati.STEP_OPERANDS else t.stride(1)), k
        assert vs == 1, k


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_batch_last_views_are_read_in_place(shape):
    # A batch-last view (movedim of an (N, ..., B) tensor, as the kernels
    # return their outputs): batch stride 1, values B apart.
    ins = [t.movedim(0, -1).contiguous().movedim(-1, 0) for t in driver_inputs(shape)]
    nx, nu = shape
    strides = riccati.operand_strides(ins)
    assert strides[0] == (1, nx * nx * B, B)
    assert strides[9] == (1, 0, B) and strides[11] == (1, 0, 1)
    dense = riccati.riccati_backward_plain(*(t.contiguous() for t in ins))
    for a, b in zip(riccati.riccati_backward_plain(*ins), dense):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [0, 4, 6, 10], ids=["A", "lxx", "lux", "Vxx"])
def test_operand_with_unevenly_spaced_values_raises(k):
    ins = list(t.contiguous() for t in driver_inputs())
    ins[k] = ins[k].transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="evenly spaced"):
        riccati.operand_strides(ins)
    ins[k] = ins[k].contiguous()
    riccati.operand_strides(ins)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_gives_same_bits_on_broadcast_and_materialised(shape):
    ins = driver_inputs(shape)
    broadcast = riccati.riccati_backward_plain(*ins)
    dense = riccati.riccati_backward_plain(*(t.contiguous() for t in ins))
    for a, b in zip(broadcast, dense):
        assert torch.equal(a, b)
    assert bool(broadcast[-1].all())


def test_launch_hands_the_kernel_every_input_where_it_lies(monkeypatch):
    """``_launch`` passes each input's own address and strides (no copy) and
    returns the batch-last outputs as batch-first views."""
    ins = driver_inputs()
    seen = {}

    def fake(ptrs, strides, outs, n_steps, batch, stream):
        seen.update(ptrs=list(ptrs), strides=list(strides), outs=list(outs),
                    n=(n_steps, batch))
        return 0

    monkeypatch.setattr(build, "dtype_tag", lambda kernel, tensors, shapes: "f64")
    monkeypatch.setattr(build, "function", lambda name, argtypes, header=None: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda device: None)
    dispatch_log.reset()
    k, K, dV, qerr, nvx, ok = riccati._launch(*ins)
    assert seen["ptrs"] == [t.data_ptr() for t in ins]
    assert seen["strides"] == [s for st in riccati.operand_strides(ins) for s in st]
    assert seen["n"] == (N, B)
    assert k.shape == (B, N, 2) and k.stride() == (1, 2 * B, B)
    assert K.shape == (B, N, 2, 3) and K.stride() == (1, 6 * B, 3 * B, B)
    assert seen["outs"][:2] == [k.data_ptr(), K.data_ptr()]
    assert dispatch_log.launches == {"riccati_backward": 1}
