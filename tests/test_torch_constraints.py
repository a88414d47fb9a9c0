"""The port's path-constraint types and the IPDDP stall detector against the
JAX package on CPU in float64: for every type, ``evaluate``,
``upper_bound``, ``lower_bound``, both Jacobians, the three Hessians and
``violation_from_value`` at 1e-12, on seeded points (batch-first in the
port, one point at a time in JAX); the builders' validation errors; the
stacker's per-point Jacobians and Hessians; and ``stall_detector_update``
on the crafted commit sequences of tests/test_norm_constraint_soc.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddp_tpu as ct
import cddp_tpu_torch as tt
from cddp_tpu.constraints import path as jpath
from cddp_tpu.solvers import ipddp as jipddp
from cddp_tpu_torch.constraints import path
from cddp_tpu_torch.constraints.stack import PathStacker
from cddp_tpu_torch.interop import problem_from_arrays
from cddp_tpu_torch.solvers import ipddp

torch.set_num_threads(1)

NX, NU, POINTS = 3, 2, 6
TOL = 1e-12
KINDS = ("BallConstraint", "ControlConstraint", "LinearConstraint",
         "MaxThrustMagnitudeConstraint", "PoleConstraint", "SecondOrderConeConstraint",
         "StateConstraint", "ThrustMagnitudeConstraint")


def _builders(rng):
    """type name -> (JAX constraint, port constraint), built from the same
    seeded parameters by each package's builder."""
    kw = dict(device="cpu", dtype=torch.float64)
    r, c = rng.uniform(0.2, 0.8), rng.normal(size=2)
    A, b = rng.normal(size=(4, NX)), rng.normal(size=4)
    pc, pr, pl = rng.normal(size=3), rng.uniform(0.2, 0.6), rng.uniform(0.5, 2.0)
    o, d, fov = rng.normal(size=3), rng.normal(size=3), rng.uniform(0.3, 1.2)
    lo, hi = rng.uniform(0.1, 0.5), rng.uniform(0.8, 1.5)
    box_lo, box_hi = -rng.uniform(0.5, 2.0, NU), rng.uniform(0.5, 2.0, NU)
    sbox_lo, sbox_hi = -rng.uniform(0.5, 2.0, NX), rng.uniform(0.5, 2.0, NX)
    sf = rng.uniform(0.5, 3.0)
    return {
        "BallConstraint": (ct.ball_constraint(jnp.asarray(r), jnp.asarray(c), sf),
                           tt.ball_constraint(r, c, sf, **kw)),
        "LinearConstraint": (ct.linear_constraint(jnp.asarray(A), jnp.asarray(b), sf),
                             tt.linear_constraint(A, b, sf, **kw)),
        "PoleConstraint": (jpath.pole_constraint(jnp.asarray(pc), "y", jnp.asarray(pr),
                                                 jnp.asarray(pl), sf),
                           tt.pole_constraint(pc, "y", pr, pl, sf, **kw)),
        "SecondOrderConeConstraint": (
            jpath.second_order_cone_constraint(jnp.asarray(o), jnp.asarray(d), fov, 1e-3),
            tt.second_order_cone_constraint(o, d, fov, 1e-3, **kw)),
        "ThrustMagnitudeConstraint": (jpath.thrust_magnitude_constraint(lo, hi, 1e-4),
                                      tt.thrust_magnitude_constraint(lo, hi, 1e-4, **kw)),
        "MaxThrustMagnitudeConstraint": (jpath.max_thrust_magnitude_constraint(hi, 1e-4),
                                         tt.max_thrust_magnitude_constraint(hi, 1e-4, **kw)),
        "ControlConstraint": (ct.control_constraint(jnp.asarray(box_lo), jnp.asarray(box_hi),
                                                    sf),
                              tt.control_constraint(box_lo, box_hi, sf, **kw)),
        "StateConstraint": (ct.state_constraint(jnp.asarray(sbox_lo), jnp.asarray(sbox_hi), sf),
                            tt.state_constraint(sbox_lo, sbox_hi, sf, **kw)),
    }


def _points(rng):
    return rng.normal(size=(POINTS, NX)) * 1.5, rng.normal(size=(POINTS, NU))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_constraint_matches_jax(kind, seed):
    rng = np.random.default_rng(seed)
    jc, c = _builders(rng)[kind]
    x, u = _points(rng)
    X, U = torch.as_tensor(x), torch.as_tensor(u)
    assert c.dual_dim == jc.dual_dim and c.is_affine == jc.is_affine
    _close(c.upper_bound(), jc.upper_bound(), "upper_bound")
    _close(c.lower_bound(), jc.lower_bound(), "lower_bound")
    per_point = {
        "evaluate": (c.evaluate, jc.evaluate),
        "state_jacobian": (c.state_jacobian, jc.state_jacobian),
        "control_jacobian": (c.control_jacobian, jc.control_jacobian),
        "state_hessian": (c.state_hessian, jc.state_hessian),
        "control_hessian": (c.control_hessian, jc.control_hessian),
        "cross_hessian": (c.cross_hessian, jc.cross_hessian),
    }
    for what, (mine, theirs) in per_point.items():
        got = mine(X, U)
        want = np.stack([np.asarray(theirs(jnp.asarray(a), jnp.asarray(v)))
                         for a, v in zip(x, u)])
        assert tuple(got.shape) == want.shape, what
        _close(got, want, what)
    # Values around the bound, so that both sides of each max(0, .) show.
    g = c.evaluate(X, U) + torch.as_tensor(rng.normal(size=(POINTS, c.dual_dim)))
    want = np.stack([np.asarray(jc.violation_from_value(jnp.asarray(v))) for v in g.numpy()])
    _close(c.violation_from_value(g), want, "violation_from_value")


def test_linear_constraint_keeps_the_reference_quirks():
    """``scale_factor`` is stored and unused, and the violation reads
    max(0, max(b - g)), as in the reference (constraint.hpp:303-306)."""
    A, b = np.eye(3)[:2], np.array([1.0, 2.0])
    c = tt.linear_constraint(A, b, 7.0, device="cpu", dtype=torch.float64)
    x = torch.tensor([[0.5, 0.5, 9.0]], dtype=torch.float64)
    np.testing.assert_array_equal(c.evaluate(x, x[:, :2]).numpy(), [[0.5, 0.5]])
    np.testing.assert_array_equal(c.violation_from_value(torch.tensor([0.5, 0.5])).numpy(), 1.5)


# (builder, arguments, message): each package's builder raises ValueError
# with the same message.
BAD = {
    "pole_direction": ("pole_constraint", ([0.0, 0.0, 0.0], "w", 1.0, 1.0), "Direction must"),
    "cone_angle": ("second_order_cone_constraint", ([0.0] * 3, [0.0, 0.0, 1.0], 4.0),
                   "Cone angle"),
    "cone_epsilon": ("second_order_cone_constraint", ([0.0] * 3, [0.0, 0.0, 1.0], 1.0, 0.0),
                     "Regularization epsilon"),
    "cone_direction": ("second_order_cone_constraint", ([0.0] * 3, [0.0, 0.0, 0.0], 1.0),
                       "Opening direction"),
    "thrust_min": ("thrust_magnitude_constraint", (-1.0, 1.0), "min_thrust_norm"),
    "thrust_order": ("thrust_magnitude_constraint", (2.0, 1.0), "max_thrust_norm"),
    "thrust_epsilon": ("thrust_magnitude_constraint", (0.0, 1.0, 0.0), "epsilon"),
    "max_thrust": ("max_thrust_magnitude_constraint", (-1.0,), "max_thrust_norm"),
    "max_thrust_epsilon": ("max_thrust_magnitude_constraint", (1.0, -1e-3), "epsilon"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_builders_refuse_what_jax_refuses(case):
    name, args, message = BAD[case]
    jargs = tuple(jnp.asarray(a) if isinstance(a, list) else a for a in args)
    with pytest.raises(ValueError, match=message) as want:
        getattr(jpath, name)(*jargs)
    with pytest.raises(ValueError) as got:
        getattr(path, name)(*args, device="cpu", dtype=torch.float64)
    assert str(got.value) == str(want.value)


def _stack_pair():
    """The obstacle stack with a max-thrust row, in both packages (the
    port's through ``interop``): m = 6, one curved ball, one curved norm."""
    from test_mega_ipddp import _unicycle_obstacle

    jp = _unicycle_obstacle(horizon=4).add_constraint(
        "MaxThrust", jpath.max_thrust_magnitude_constraint(1.5))
    ball, thrust = jp.constraints["BallConstraint"], jp.constraints["MaxThrust"]
    cc = jp.constraints["ControlConstraint"]
    o = jp.objective
    p = problem_from_arrays(
        "Unicycle", [], o.Q, o.R, o.Qf, o.reference_state, cc.lower, cc.upper, jp.x0,
        jp.horizon, jp.timestep, "euler", device="cpu", dtype=torch.float64,
        constraints={
            "BallConstraint": ("BallConstraint", dict(
                radius=np.asarray(ball.radius), center=np.asarray(ball.center),
                scale_factor=ball.scale_factor)),
            "MaxThrust": ("MaxThrustMagnitudeConstraint", dict(
                max_thrust=np.asarray(thrust.max_thrust), epsilon=thrust.epsilon)),
        })
    return jp, p


def test_stacker_per_point_jacobians_and_hessians():
    from cddp_tpu.constraints.stack import PathStacker as JPathStacker

    jp, p = _stack_pair()
    stk, jstk = PathStacker(p), JPathStacker(jp)
    assert stk.names == jstk.names and stk.total_dim == jstk.total_dim == 6
    assert stk.has_curved and stk.jacobian_rows(NX, NU) is None
    rng = np.random.default_rng(3)
    x, u = rng.normal(size=(2, 4, NX)), rng.normal(size=(2, 4, NU))
    X, U = torch.as_tensor(x), torch.as_tensor(u)
    gx, gu = stk.jacobians(X, U)
    hess = stk.hessians(X, U)
    assert tuple(gx.shape) == (2, 4, 6, NX) and tuple(hess[2].shape) == (2, 4, 6, NU, NX)
    for i in range(2):
        for t in range(4):
            a, v = jnp.asarray(x[i, t]), jnp.asarray(u[i, t])
            jgx, jgu = jstk.jacobians(a, v)
            _close(gx[i, t], jgx, "Gx")
            _close(gu[i, t], jgu, "Gu")
            for k, (name, h) in enumerate(zip(("hxx", "huu", "hux"), hess)):
                want = np.concatenate([np.asarray(c.hessians(a, v)[k])
                                       for _, c in jstk.items])
                _close(h[i, t], want, name)
    _close(stk.evaluate_shifted(X, U)[1, 2], jstk.evaluate_shifted(
        jnp.asarray(x[1, 2]), jnp.asarray(u[1, 2])), "evaluate_shifted")


def test_fold_terms_match_the_jax_fold():
    """The y-weighted Hessian fold (ipddp.py:596-627) on the stack above,
    armed and unarmed: the unarmed weight adds exact zeros."""
    _, p = _stack_pair()
    stk = PathStacker(p)
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.normal(size=(3, 5, NX)))
    U = torch.as_tensor(rng.normal(size=(3, 4, NU)))
    Y = torch.as_tensor(rng.uniform(0.1, 2.0, size=(3, 4, 6)))
    w = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float64)
    txx, tuu, tux = ipddp.fold_terms(stk, X, U, Y, w)
    hxx, huu, hux = stk.hessians(X[:, :-1], U)
    for t, h in ((txx, hxx), (tuu, huu), (tux, hux)):
        want = (Y[..., None, None] * w[:, None, None, None, None] * h).sum(2)
        _close(t, want, "fold")
        assert bool((t[1] == 0).all())
    assert bool((txx[0, :, 0, 0] == Y[0, :, 0] * -2.0).all())  # the ball row, scale 1


def _sequences():
    """(mu, inf_pr) commit sequences of tests/test_norm_constraint_soc.py
    (tolerance 1e-5): a creeping mu, a stuck mu, a healthy solve, and a
    plateau below the far bar."""
    n = 40
    creep = ([10.0 * 0.995 ** i for i in range(n)],
             [0.6 + 0.5 * ((3 * i) % 7) for i in range(n)])
    stuck = ([10.0] * 20, [0.6 + 0.5 * ((3 * i) % 7) for i in range(20)])
    mus, prs, mu, ipr = [10.0], [5.0], 10.0, 5.0
    for i in range(30):
        if i % 3 == 2:
            mu *= 0.2
        ipr *= 0.7
        mus.append(mu)
        prs.append(ipr)
    plateau = ([1e-4 * 0.9 ** i for i in range(30)], [5e-4] * 30)
    return {"mu_creep": creep, "mu_stuck": stuck, "healthy": (mus, prs),
            "plateau": plateau}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(_sequences()))
def test_stall_detector_matches_jax(case, dtype):
    """Both detectors fed the same sequence commit by commit, in one dtype:
    every (count, armed, best_inf_pr) equal. The arming commits are those
    of the JAX tests (at most 15 for the creep, 8 for the stuck mu, never
    for the other two)."""
    mus, prs = _sequences()[case]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jc, ja, jb = jnp.asarray(0, jnp.int32), jnp.asarray(False), jnp.asarray(jnp.inf, jd)
    c = torch.zeros(1, dtype=torch.int32)
    a, b = torch.zeros(1, dtype=torch.bool), torch.full((1,), float("inf"), dtype=td)
    armed_at = None
    for i in range(1, len(mus)):
        jc, ja, jb = jipddp.stall_detector_update(
            jnp.asarray(mus[i - 1], jd), jnp.asarray(mus[i], jd), jnp.asarray(prs[i], jd), jb,
            jc, ja, 1e-5, 8)
        c, a, b = ipddp.stall_detector_update(
            torch.tensor([mus[i - 1]], dtype=td), torch.tensor([mus[i]], dtype=td),
            torch.tensor([prs[i]], dtype=td), b, c, a, 1e-5, 8)
        assert (int(c), bool(a)) == (int(jc), bool(ja)), i
        assert float(b) == float(jb), i
        if armed_at is None and bool(a):
            armed_at = i
    want = {"mu_creep": lambda v: v is not None and v <= 15, "mu_stuck": lambda v: v == 8,
            "healthy": lambda v: v is None, "plateau": lambda v: v is None}[case]
    assert want(armed_at), armed_at


def test_soc_and_fold_gates():
    """soc_traced / chess_mode against the JAX functions: "auto" traces on
    curved stacks only, explicit values win."""
    jp, p = _stack_pair()
    from cddp_tpu.constraints.stack import PathStacker as JPathStacker

    box_j = jp.replace(constraints={"ControlConstraint": jp.constraints["ControlConstraint"]})
    box_p = p.replace(constraints={"ControlConstraint": p.constraints["ControlConstraint"]})
    for soc in ("auto", True, False):
        for chess in ("auto", True, False):
            jo = ct.CDDPOptions(ipddp=ct.IPDDPOptions(slack_soc=soc,
                                                      use_constraint_hessians=chess))
            o = tt.CDDPOptions(ipddp=tt.IPDDPOptions(slack_soc=soc,
                                                     use_constraint_hessians=chess))
            for jprob, prob in ((jp, p), (box_j, box_p)):
                js, s = JPathStacker(jprob), PathStacker(prob)
                assert ipddp.soc_traced(o, s) == jipddp.soc_traced(jo, js)
                assert ipddp.chess_mode(o, s) == jipddp.chess_mode(jo, js)


def test_dataclass_fields_carry_across():
    """Every ported type has the JAX type's fields (but ``dual_dim``), so
    ``interop`` carries a JAX constraint across field by field."""
    for name in ("BallConstraint", "LinearConstraint", "PoleConstraint",
                 "SecondOrderConeConstraint", "ThrustMagnitudeConstraint",
                 "MaxThrustMagnitudeConstraint"):
        mine = {f.name for f in dataclasses.fields(getattr(path, name))}
        theirs = {f.name for f in dataclasses.fields(getattr(jpath, name))} - {"dual_dim"}
        assert mine == theirs, name

