"""The condensed IPDDP backward's plain version (the CUDA kernel's
reference, ``ops/kernels/ipddp_riccati.py``) against the JAX package's
``jax.vmap(_condensed_scan_single)`` on random stage data (CPU, float64,
rtol 1e-9 and atol 1e-11: the tolerance of tests/test_ipddp_pallas.py),
the kernel wrapper's dispatch, and the kernel's view of its operands
(``operand_strides``) on the per-pass driver's real inputs, whose cost
Hessians and constraint Jacobians are broadcasts with stride 0, and on
the batch-last views the forward kernel hands on."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu_torch as tt
from cddp_tpu.solvers.ipddp import _condensed_scan_single
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.models import Unicycle
from cddp_tpu_torch.ops.kernels import dispatch_log, ipddp_riccati
from cddp_tpu_torch.solvers import ipddp
from test_ipddp_pallas import _random_stage_data

torch.set_num_threads(1)

NAMES = ("k_u", "K_u", "k_y", "K_y", "k_s", "K_s", "Vx", "Vxx", "stats")
# One batch and horizon for every case, so the JAX scan compiles once per m.
B, N = 6, 8
_jax_scan = jax.jit(jax.vmap(_condensed_scan_single))


def _data(seed, m):
    return list(_random_stage_data(jax.random.PRNGKey(seed), B=B, N=N, nx=3, nu=2,
                                   m=m, dtype=jnp.float64))


def _both(args):
    want = _jax_scan(*args)
    targs = [torch.as_tensor(np.asarray(a)) for a in args]
    dispatch_log.reset()
    got = ipddp_riccati.ipddp_backward(*targs)
    assert not dispatch_log.launches  # CPU tensors: the plain version
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-11,
                                   err_msg=name)
    return got


@pytest.mark.parametrize("m", [4, 10], ids=["box_fleet_m4", "two_boxes_m10"])
def test_backward_matches_jax_scan(m):
    stats = _both(_data(0, m))[-1]
    assert bool((stats[:, 6] == 1.0).all())


def test_indefinite_batch_mixes_ok_and_failed():
    # A negative regularization on half of the batch makes the condensed
    # Quu indefinite there: those instances fail the leading-minors check,
    # with zero control gains at the failing steps, as in the JAX scan.
    args = _data(1, 4)
    args[-1] = jnp.asarray([1e-6, -50.0] * (B // 2))
    stats = _both(args)[-1]
    ok = stats[:, 6].numpy()
    assert ok.min() == 0.0 and ok.max() == 1.0


def test_barrier_ratio_cap_is_1e12_in_float64():
    # Tiny slacks push y / s_safe past 1e6: the float64 cap is 1e12, as in
    # the JAX scan (ipddp.py:64-73), and 1e6 in float32.
    args = _data(2, 4)
    args[8] = jnp.full_like(args[8], 1e-9)  # S
    args[14] = jnp.full_like(args[14], 1e-9)  # mu
    _both(args)
    assert ipddp_riccati.max_ratio(torch.float64) == 1e12
    assert ipddp_riccati.max_ratio(torch.float32) == 1e6


# m: a control box (4), a state box (6) or both (10) on the unicycle.
BOXES = {4: ("ControlConstraint",), 6: ("StateConstraint",),
         10: ("ControlConstraint", "StateConstraint")}
BROADCAST = (4, 5, 10, 11)  # lxx, luu, Gx, Gu


def driver_inputs(m, seed=3):
    """The condensed backward's inputs as the per-pass driver builds them
    (``ipddp.backward_inputs``) about random trajectories, float64, CPU."""
    kw = dict(device="cpu", dtype=torch.float64)
    obj = tt.quadratic_objective(torch.eye(3) * 0.1, torch.eye(2) * 0.05, torch.eye(3) * 100.0,
                                 [2.0, 2.0, math.pi / 2], 0.05, **kw)
    boxes = {"ControlConstraint": tt.control_constraint([-2.0, -math.pi], [2.0, math.pi], **kw),
             "StateConstraint": tt.state_constraint([-5.0, -5.0, -2 * math.pi],
                                                    [5.0, 5.0, 2 * math.pi], **kw)}
    prob = tt.problem(Unicycle(), obj, torch.zeros(3), N, 0.05,
                      {n: boxes[n] for n in BOXES[m]}, **kw)
    stk = PathStacker(prob)
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, N + 1, 3)))
    U = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, N, 2)))
    Y, S = (torch.as_tensor(rng.uniform(0.1, 1.0, (B, N, m))) for _ in range(2))
    mu = torch.as_tensor(rng.uniform(0.01, 0.1, B))
    reg = torch.full((B,), 1e-6, dtype=torch.float64)
    return ipddp.backward_inputs(prob, stk, X, U, Y, S, ipddp._eval_path(stk, X, U), mu, reg)


@pytest.mark.parametrize("m", sorted(BOXES))
def test_driver_operands_are_read_where_they_lie(m):
    # The cost Hessians and constraint Jacobians are one copy (both strides
    # 0, as objective.py and ipddp.py expand them); every other input is
    # per instance, so the kernel stages it per thread.
    ins = driver_inputs(m)
    strides = ipddp_riccati.operand_strides(ins)
    for k, (t, (bs, ts, vs)) in enumerate(zip(ins, strides)):
        if k in BROADCAST:
            assert (bs, ts) == (0, 0), k
        else:
            assert bs != 0, k
        assert ts == (0 if k >= ipddp_riccati.STEP_OPERANDS else t.stride(1)), k
        assert vs == 1, k


@pytest.mark.parametrize("m", sorted(BOXES))
def test_materialised_operands_are_dense_batch_first(m):
    ins = [t.contiguous() for t in driver_inputs(m)]
    shapes = ipddp_riccati.inner_shapes(3, 2, m)
    for k, (st, inner) in enumerate(zip(ipddp_riccati.operand_strides(ins), shapes)):
        block = math.prod(inner)
        if k < ipddp_riccati.STEP_OPERANDS:
            assert st == (N * block, block, 1), k
        else:
            assert st == (block, 0, 1), k


@pytest.mark.parametrize("m", sorted(BOXES))
def test_batch_last_views_are_read_in_place(m):
    # The per-pass driver hands the forward kernel's duals, slacks and
    # constraint values on as movedim views of (N, m, B) tensors: batch
    # stride 1, values B apart.
    ins = list(driver_inputs(m))
    for k in (7, 8, 9):
        ins[k] = ins[k].movedim(0, -1).contiguous().movedim(-1, 0)
    strides = ipddp_riccati.operand_strides(ins)
    for k in (7, 8, 9):
        assert strides[k] == (1, m * B, B), k
    dense = ipddp_riccati.ipddp_backward_plain(*(t.contiguous() for t in ins))
    for name, a, b in zip(NAMES, ipddp_riccati.ipddp_backward_plain(*ins), dense):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("k", [0, 10, 13], ids=["A_transposed", "Gx_transposed",
                                                 "Vxx_transposed"])
def test_operand_with_unevenly_spaced_values_raises(k):
    ins = list(driver_inputs(4))
    ins[k] = ins[k].transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="evenly spaced"):
        ipddp_riccati.operand_strides(ins)
    ins[k] = ins[k].contiguous()
    ipddp_riccati.operand_strides(ins)


@pytest.mark.parametrize("m", sorted(BOXES))
def test_plain_gives_same_bits_on_broadcast_and_materialised(m):
    ins = driver_inputs(m)
    broadcast = ipddp_riccati.ipddp_backward_plain(*ins)
    dense = ipddp_riccati.ipddp_backward_plain(*(t.contiguous() for t in ins))
    for name, a, b in zip(NAMES, broadcast, dense):
        assert torch.equal(a, b), name
    assert bool(broadcast[-1][:, 6].all())
