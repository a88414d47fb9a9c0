"""The MPCC racing example on the port (``examples/mpcc_lib_torch.py``)
against the JAX package's (``examples/mpcc_lib.py``), CPU, float64, inputs
made with numpy from a seed: the Fourier tracks (synthetic and the CSV
circuit), the Chebyshev windows and their Clenshaw lookup (1e-12); the
latch bicycle and its CUDA struct built for the host against autograd; the
plain cost lane and the CUDA cost and Gauss-Newton lanes built for the host
against the JAX lanes; a fleet tick and a
warm tick, the port's plain driver on both dispatch paths against the JAX
ticks (statuses and iterations equal, X, U and cost within 1e-8); kernel
7's route gate against the JAX gate; the lane registries and the lane
library's instantiations."""

import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "examples"))

import mpcc_lib as J  # noqa: E402
import mpcc_lib_torch as T  # noqa: E402

from cddp_tpu.ops.pallas import mega_ipddp as jmega  # noqa: E402
from cddp_tpu.solvers.ipddp import IPDDPSolverState as JState  # noqa: E402
from cddp_tpu_torch.constraints.stack import PathStacker  # noqa: E402
from cddp_tpu_torch.interop import solver_state_from_arrays, track_from_arrays  # noqa: E402
from cddp_tpu_torch.ops.kernels import build, dispatch_log, ip_rollout, mega_ipddp  # noqa: E402
from cddp_tpu_torch.ops.kernels import rollout as rollout_ops  # noqa: E402

torch.set_num_threads(1)

CSV = REPO / "examples" / "data" / "mpcc_racing_track.csv"
TRACKS = {"synthetic": (lambda: J.synthetic_track(n_points=240),
                        lambda: T.synthetic_track(n_points=240, device="cpu")),
          "csv": (lambda: J.load_track_csv(str(CSV)), lambda: T.load_track_csv(CSV, device="cpu"))}
THETA0 = np.array([0.3, 1.7, 4.0])


def _close(a, b, tol=1e-12, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("kind", sorted(TRACKS))
def test_fourier_track_matches_jax(kind):
    """The track's samples and Fourier matrix, and its lookup over one and a
    half laps; ``interop.track_from_arrays`` carries the JAX track over."""
    jt, pt = (f() for f in TRACKS[kind])
    for f in dataclasses.fields(T.Track):
        _close(getattr(pt, f.name).numpy(), getattr(jt, f.name), msg=f.name)
    s = np.random.default_rng(1).uniform(0.0, 1.5 * float(jt.length), 64)
    a, b = jt.interpolate(jnp.asarray(s)), pt.interpolate(torch.as_tensor(s))
    carried = track_from_arrays(T.Track, {f.name: np.asarray(getattr(jt, f.name))
                                          for f in dataclasses.fields(T.Track)}, device="cpu")
    c = carried.interpolate(torch.as_tensor(s))
    for k in ("x", "y", "heading", "curvature", "v_ref", "tangent", "normal"):
        _close(b[k].numpy(), a[k], msg=k)
        torch.testing.assert_close(c[k], b[k], rtol=0, atol=0)


@pytest.mark.parametrize("M", [16, 64])
def test_local_track_fit_matches_jax(M):
    """One Chebyshev window per car (the port's batched fit against the JAX
    fit vmapped over theta0), and the Clenshaw lookup across each window
    and past its ends (the clip)."""
    jt, pt = (f() for f in TRACKS["synthetic"])
    reach = 2.2 * 20 * 0.05
    jw = jax.vmap(lambda t: J.local_track_fit(jt, t, reach, n_coeffs=M))(jnp.asarray(THETA0))
    pw = T.local_track_fit(pt, torch.as_tensor(THETA0), reach, n_coeffs=M)
    for f in dataclasses.fields(T.LocalTrack):
        _close(getattr(pw, f.name).numpy(), getattr(jw, f.name), msg=f.name)
    s = THETA0[:, None] + np.linspace(-1.0, reach + 1.0, 50)[None]
    a = jax.vmap(lambda w, si: w.interpolate(si))(jw, jnp.asarray(s))
    b = dataclasses.replace(pw, **{f.name: getattr(pw, f.name)[:, None]
                                   for f in dataclasses.fields(T.LocalTrack)
                                   if f.name != "coeffs"},
                            coeffs=pw.coeffs[:, None]).interpolate(torch.as_tensor(s))
    for k in ("x", "y", "heading", "curvature", "v_ref"):
        _close(b[k].numpy(), a[k], msg=k)
    for k in ("tangent", "normal"):
        _close(b[k].numpy(), np.moveaxis(np.asarray(a[k]), 1, 0), msg=k)


def _states(B=16, seed=2):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-1, 1, (B, 3)), rng.uniform(0.0, 5.0, (B, 1)),
                        rng.uniform(0.1, 2.0, (B, 3))], 1)
    u = np.stack([rng.uniform(0.1, 2.2, B), rng.uniform(-0.6, 0.6, B), rng.uniform(0, 2.2, B)], 1)
    return x, u


def test_bicycle7_matches_jax():
    """The latch bicycle's dynamics, AD Jacobians and Euler step (the
    latches land on u exactly)."""
    x, u = _states()
    jm, pm = J.KinematicBicycle7(), T.KinematicBicycle7()
    X, U = torch.as_tensor(x), torch.as_tensor(u)
    _close(pm(X, U, None).numpy(), jax.vmap(lambda a, b: jm.continuous_dynamics(a, b, 0.0))(
        jnp.asarray(x), jnp.asarray(u)))
    Fx, Fu = pm.jacobians(X, U, 0.0)
    jFx, jFu = jax.vmap(lambda a, b: jm.jacobians(a, b, 0.0))(jnp.asarray(x), jnp.asarray(u))
    _close(Fx.numpy(), jFx)
    _close(Fu.numpy(), jFu)
    x1 = pm.discrete_dynamics(X, U, 0.0, 0.05)
    np.testing.assert_allclose(x1[:, 4:].numpy(), u, rtol=1e-12)


_HOST = r"""
#include "mpcc_lanes.cuh"
using namespace cddp;
using namespace cddp::mpcc;
extern "C" {
void eval_bicycle7(const double* x, const double* u, const double* p, double* dx, double* Fx,
                   double* Fu, int B) {
  for (int b = 0; b < B; ++b) {
    double xb[7], ub[3], d[7], A[7][7], G[7][3];
    for (int i = 0; i < 7; ++i) xb[i] = x[b * 7 + i];
    for (int i = 0; i < 3; ++i) ub[i] = u[b * 3 + i];
    Bicycle7::f(xb, ub, p, d);
    Bicycle7::fxfu(xb, ub, p, A, G);
    for (int i = 0; i < 7; ++i) {
      dx[b * 7 + i] = d[i];
      for (int j = 0; j < 7; ++j) Fx[(b * 7 + i) * 7 + j] = A[i][j];
      for (int j = 0; j < 3; ++j) Fu[(b * 7 + i) * 3 + j] = G[i][j];
    }
  }
}
// The lanes on batch-last cp (n, B): the cost lane, the GN residuals and
// their Jacobian columns by dual numbers, the terminal residuals and extra.
void eval_lanes(const double* x, const double* u, const double* cp, int n, const double* wc,
                const double* wg, double* cost, double* res, double* jac, double* tres,
                double* textra, int B) {
  double wcost[MpccCost::NW], wgn[MpccGn::NW];
  for (int i = 0; i < MpccCost::NW; ++i) wcost[i] = wc[i];
  for (int i = 0; i < MpccGn::NW; ++i) wgn[i] = wg[i];
  for (int b = 0; b < B; ++b) {
    LaneParams<double> p{cp, size_t(B), b, n};
    double xb[7], ub[3], r[13], rt[2];
    for (int i = 0; i < 7; ++i) xb[i] = x[b * 7 + i];
    for (int i = 0; i < 3; ++i) ub[i] = u[b * 3 + i];
    cost[b] = MpccCost::cost(xb, ub, p, wcost, 0);
    MpccGn::res(xb, ub, p, wgn, 0, r);
    for (int k = 0; k < 13; ++k) res[b * 13 + k] = r[k];
    for (int j = 0; j < 10; ++j) {
      Dual<double> xd[7], ud[3], rd[13];
      for (int i = 0; i < 7; ++i) xd[i] = Dual<double>{xb[i], i == j ? 1.0 : 0.0};
      for (int i = 0; i < 3; ++i) ud[i] = Dual<double>{ub[i], i + 7 == j ? 1.0 : 0.0};
      MpccGn::res(xd, ud, p, wgn, 0, rd);
      for (int k = 0; k < 13; ++k) jac[(b * 13 + k) * 10 + j] = rd[k].d;
    }
    MpccGn::tres(xb, p, wgn, rt);
    tres[b * 2] = rt[0];
    tres[b * 2 + 1] = rt[1];
    textra[b] = MpccGn::textra(xb, p, wgn);
  }
}
}
"""


@pytest.fixture(scope="module")
def host_lanes(tmp_path_factory):
    """examples/mpcc_lanes.cuh compiled for the host with g++
    (``-ffp-contract=off``, as the float64 build's ``--fmad=false``)
    against the stand-in ``cuda_runtime.h`` of ``torch_host_kernel.py``."""
    from torch_host_kernel import STAND_IN

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA lanes for the host")
    d = tmp_path_factory.mktemp("host_lanes")
    (d / "cuda_runtime.h").write_text(STAND_IN)
    (d / "eval.cpp").write_text(_HOST)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                    "-DCDDP_F64", f"-I{d}", f"-I{build.CSRC}", f"-I{T.LANES_HEADER.parent}",
                    str(d / "eval.cpp"), "-o", str(d / "eval.so")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(d / "eval.so"))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_bicycle7_struct_matches_autograd(host_lanes):
    """The model struct's f and analytic fxfu against the plain model's
    forward and its forward-mode AD Jacobians (1e-12: the host libm's sin,
    cos and tan against torch's)."""
    x, u = _states(64, seed=4)
    model = T.KinematicBicycle7()
    p = np.asarray(ip_rollout.model_lane(model).params(model))
    B = x.shape[0]
    dx, Fx, Fu = np.zeros((B, 7)), np.zeros((B, 7, 7)), np.zeros((B, 7, 3))
    host_lanes.eval_bicycle7(_ptr(x), _ptr(u), _ptr(p), _ptr(dx), _ptr(Fx), _ptr(Fu),
                             ctypes.c_int(B))
    X, U = torch.as_tensor(x), torch.as_tensor(u)
    want_Fx, want_Fu = model.jacobians(X, U, 0.0)
    _close(dx, model(X, U, None).numpy())
    _close(Fx, want_Fx.numpy())
    _close(Fu, want_Fu.numpy())


def _lane_case(M=16, B=24, seed=6):
    """A window at theta0 = 1.7, states around the centerline and over and
    past the window's ends, the config; both packages' objectives."""
    jt, pt = (f() for f in TRACKS["synthetic"])
    jcfg = J.MpccConfig(track_eval="local", local_coeffs=M)
    cfg = T.MpccConfig(track_eval="local", local_coeffs=M)
    jw = J.solve_track(jt, jcfg, jnp.asarray(1.7))
    pw = T.solve_track(pt, cfg, torch.tensor([1.7], dtype=torch.float64))
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 4.5, B)
    ref = pt.interpolate(torch.as_tensor(s))
    x = np.stack([ref["x"].numpy() + rng.normal(0, 0.1, B), ref["y"].numpy()
                  + rng.normal(0, 0.1, B), ref["heading"].numpy() + rng.normal(0, 3.0, B), s,
                  *rng.uniform(0.0, 2.0, (3, B))], 1)
    u = _states(B, seed)[1]
    return jw, jcfg, pw, cfg, x, u


def test_lanes_match_jax(host_lanes):
    """The plain cost lane against ``_mpcc_cost_factory``'s lane_f and the
    parameter vectors against ``_mpcc_track_params`` (1e-12); the CUDA
    lanes built for the host: the cost lane against the plain one, the GN
    lane's residuals against ``_mpcc_gn_factory``'s res_f, tres_f and
    textra_f and against ``MpccObjective``'s own residuals (the GN lane's
    plain version, which the plain driver runs), and its Jacobian columns
    by dual numbers against torch.func.jacfwd of those residuals
    (1e-12)."""
    M = 16
    jw, jcfg, pw, cfg, x, u = _lane_case(M)
    jobj, pobj = J.MpccObjective(track=jw, cfg=jcfg), T.MpccObjective(
        batched=True, track=pw, cfg=cfg)
    jcp = np.asarray(J._mpcc_track_params(jobj))
    cp1 = T.track_params(pobj)
    _close(cp1[0].numpy(), jcp)
    B = x.shape[0]
    cp = cp1.expand(B, -1)
    lane = ip_rollout.cost_lane(pobj)
    gn = mega_ipddp.gn_cost_lane(pobj)
    xl, ul, pl = [jnp.asarray(x[:, i]) for i in range(7)], [jnp.asarray(u[:, i]) for i in
                                                           range(3)], list(jnp.asarray(jcp))
    X, U = torch.as_tensor(x), torch.as_tensor(u)
    _close(lane.lane_f(X, U, cp, 0).numpy(), J._mpcc_cost_factory(jobj)[2](xl, ul, pl, 0))
    # The CUDA lanes on the host.
    cpl = np.ascontiguousarray(cp.numpy().T)
    wc, wg = np.asarray(lane.weights), np.asarray(gn.weights)
    out = {k: np.zeros(s) for k, s in (("cost", B), ("res", (B, 13)), ("jac", (B, 13, 10)),
                                       ("tres", (B, 2)), ("textra", B))}
    xc, uc = np.ascontiguousarray(x), np.ascontiguousarray(u)
    host_lanes.eval_lanes(_ptr(xc), _ptr(uc), _ptr(cpl), ctypes.c_int(cpl.shape[0]), _ptr(wc),
                          _ptr(wg), *(_ptr(out[k]) for k in ("cost", "res", "jac", "tres",
                                                              "textra")), ctypes.c_int(B))
    _close(out["cost"], lane.lane_f(X, U, cp, 0).numpy())
    jgn = J._mpcc_gn_factory(jobj).spec
    _close(out["res"], np.stack(jgn.res_f(xl, ul, pl, 0), -1))
    _close(out["tres"], np.stack(jgn.tres_f(xl, pl), -1))
    _close(out["textra"], jgn.textra_f(xl, pl))
    one = T.MpccObjective(track=dataclasses.replace(
        pw, **{f.name: getattr(pw, f.name)[0] for f in dataclasses.fields(T.LocalTrack)}),
        cfg=cfg)
    vmap = torch.func.vmap
    _close(out["res"], vmap(lambda xi, ui: one.running_residuals(xi, ui, 0))(X, U).numpy())
    _close(out["tres"], vmap(one.terminal_residuals)(X).numpy())
    _close(out["textra"], vmap(one.terminal_cost_extra)(X).numpy())
    jac = vmap(torch.func.jacfwd(lambda xu: one.running_residuals(xu[:7], xu[7:], 0)))(
        torch.cat([X, U], 1))
    _close(out["jac"], jac.numpy())


def _fleet(M=16, iters=8):
    jt, pt = (f() for f in TRACKS["synthetic"])
    jcfg = J.MpccConfig(max_iterations=iters, track_eval="local", local_coeffs=M)
    cfg = T.MpccConfig(max_iterations=iters, track_eval="local", local_coeffs=M)
    x0 = T.place(pt, torch.as_tensor(THETA0))
    return jt, jcfg, pt, cfg, x0


def _assert_ticks_match(sol, jsol):
    np.testing.assert_array_equal(sol.status_code.numpy(), np.asarray(jsol.status_code))
    np.testing.assert_array_equal(sol.iterations_completed.numpy(),
                                  np.asarray(jsol.iterations_completed))
    for a, b in ((sol.state_trajectory, jsol.state_trajectory),
                 (sol.control_trajectory, jsol.control_trajectory),
                 (sol.final_objective, jsol.final_objective)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-8)


def test_fleet_tick_matches_jax(caplog):
    """bench_mpcc.py's cold tick at M = 16, 8 iterations, three cars at
    different progress: the port's plain driver, through the whole-solve
    dispatch (which CPU tensors take to the plain driver kernel 7 is held
    to) and the per-pass engine (the plain versions of kernels 4, 5 and 6,
    with the cost lane), against the JAX ``mpc_tick`` vmapped."""
    import logging

    jt, jcfg, pt, cfg, x0 = _fleet()
    _, jsol = jax.jit(jax.vmap(lambda x: J.mpc_tick(jt, jcfg, x)))(jnp.asarray(x0.numpy()))
    for engine, logged in (("auto", "ipddp_solve_mpcc_gn@bicycle7"),
                           ("xla", "ip_forward_mpcc@bicycle7")):
        dispatch_log.reset()
        with caplog.at_level(logging.INFO, logger="cddp_tpu_torch.dispatch"):
            caplog.clear()
            _, sol = T.mpc_tick(pt, cfg, x0, options=T.solver_options(cfg).replace(
                solve_engine=engine))
        assert not dispatch_log.launches  # CPU tensors: the plain versions
        assert any(f"{logged}: plain torch" in r.getMessage() for r in caplog.records), engine
        assert any("open_loop_rollout@bicycle7: plain" in r.getMessage() for r in caplog.records)
        _assert_ticks_match(sol, jsol)
    assert int(np.asarray(jsol.iterations_completed).min()) == 8


def test_warm_tick_matches_jax():
    """One warm tick (the plans shifted, the IPDDP state carried, 3
    iterations) from the port's cold solves, against the JAX warm tick from
    the same plans and state (``IPDDPSolverState`` carried over as arrays)."""
    jt, jcfg, pt, cfg, x0 = _fleet(iters=4)
    U, st = T.warm_fleet_init(pt, cfg, x0)
    cfg_w = dataclasses.replace(cfg, max_iterations=3)
    jcfg_w = dataclasses.replace(jcfg, max_iterations=3)
    x1, U1, st1, it1 = T.warm_fleet_step(pt, cfg_w, x0, U, st)
    jst = JState(*(jnp.asarray(getattr(st, f).numpy()) for f in JState._fields))
    jx1, jU1, jst1, jit1 = jax.jit(lambda x, u, s: J.warm_fleet_step(jt, jcfg_w, x, u, s))(
        jnp.asarray(x0.numpy()), jnp.asarray(U.numpy()), jst)
    np.testing.assert_array_equal(it1.numpy(), np.asarray(jit1))
    for a, b in ((x1, jx1), (U1, jU1), (st1.Y, jst1.Y), (st1.S, jst1.S), (st1.k_u, jst1.k_u)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-8)
    back = solver_state_from_arrays(jst1, device="cpu")
    torch.testing.assert_close(back.Y, torch.as_tensor(np.asarray(jst1.Y)))


def _longest(M, opts):
    """The longest horizon JAX's gate takes the MPCC problem at (N <= 40)."""
    jt = TRACKS["synthetic"][0]()
    out = 0
    for N in range(20, 41):
        cfg = J.MpccConfig(max_iterations=15, track_eval="local", local_coeffs=M, horizon=N)
        th = jnp.asarray(0.3)
        ref = jt.interpolate(th)
        x0 = jnp.stack([ref["x"], ref["y"], ref["heading"], th, 1.0, 0.0, 1.0])
        if jmega.mega_eligible(J.build_problem(J.solve_track(jt, cfg, th), cfg, x0),
                               J.solver_options(cfg)):
            out = N
    return out


@pytest.mark.parametrize("M", [16, 32, 64])
def test_whole_solve_horizons_follow_jax_gates(M):
    """``rollout.WHOLE_MAX_HORIZON["ipddp_solve_gn"]`` holds, for the MPCC
    lane at n_cp = 5 M + 3, the longest horizon the JAX gate takes its
    problem at; the port's gate takes it at N = 20 and 23 and follows JAX's
    at 24 and 26 (``mega_ipddp.gn_route``); a Fourier track runs per pass
    in both."""
    limit = _longest(M, None)
    assert rollout_ops.WHOLE_MAX_HORIZON["ipddp_solve_gn"]["bicycle7"][5 * M + 3] == limit
    pt = TRACKS["synthetic"][1]()
    for N in (20, 23, 24, 26):
        cfg = T.MpccConfig(max_iterations=15, track_eval="local", local_coeffs=M, horizon=N)
        x0 = T.place(pt, torch.tensor([0.3], dtype=torch.float64))
        p = T.build_problem(T.solve_track(pt, cfg, x0[:, 3]), cfg, x0)
        assert mega_ipddp.mega_eligible(p, T.solver_options(cfg)) == (N <= limit), N
    cfg = T.MpccConfig(max_iterations=15)
    p = T.build_problem(pt, cfg, x0)
    assert not mega_ipddp.mega_eligible(p, T.solver_options(cfg))
    assert mega_ipddp.gn_route(p) is None and ip_rollout.cost_lane(p.objective) is None


def test_lane_registries_match_exact_classes():
    """The registries match by exact class, as the JAX package's: a subclass
    of the bicycle or of the objective keeps the plain paths; the MPCC
    problem resolves kernel 5's cost lane on its control box (m = 6), and
    its header's lane library instantiates kernels 4, 5 and 7 for it."""
    class Sub(T.KinematicBicycle7):
        pass

    @dataclasses.dataclass(frozen=True)
    class SubObjective(T.MpccObjective):
        pass

    assert rollout_ops.model_entry(T.KinematicBicycle7()).cuda_name == "bicycle7"
    assert rollout_ops.model_entry(Sub()) is None
    _, _, pw, cfg, x, _ = _lane_case()
    obj = T.MpccObjective(batched=True, track=pw, cfg=cfg)
    assert ip_rollout.cost_lane(SubObjective(batched=True, track=pw, cfg=cfg)) is None
    assert mega_ipddp.gn_cost_lane(SubObjective(batched=True, track=pw, cfg=cfg)) is None
    x0 = torch.as_tensor(x[:1])
    p = T.build_problem(pw, cfg, x0)
    fc = ip_rollout.resolve_ip_forward(p, T.solver_options(cfg), PathStacker(p))
    assert fc.cost.name == "mpcc" and fc.rows.m == 6 and fc.tag == "_mpcc@bicycle7"
    assert mega_ipddp.gn_route(p).name == "mpcc_gn" and ip_rollout.cost_lane(obj) is not None
    assert mega_ipddp.dispatch_name(p) == "ipddp_solve_mpcc_gn@bicycle7"
    units = "\n".join(build.lane_units(T.LANES_HEADER).values())
    for line in ("CDDP_OPEN_LOOP_ROLLOUT(bicycle7, mpcc::Bicycle7)",
                 "CDDP_IP_FORWARD_LANE(bicycle7, mpcc::Bicycle7, mpcc, mpcc::MpccCost, 6)",
                 "CDDP_IPDDP_SOLVE_GN(bicycle7, mpcc::Bicycle7, mpcc_gn, mpcc::MpccGn, 6)"):
        assert line in units
    assert build.lane_library_path(T.LANES_HEADER).name.startswith("liblanes_mpcc_lanes_")


def test_lane_kernels_launch_as_their_bounds_say():
    """The lane library's kernels, expanded from their macros in the
    generated units, are launched and registered with the block size their
    ``__launch_bounds__`` names (``tests/test_torch_build.py``'s rule), and
    every launcher exported is registered."""
    from test_torch_build import launch_shape_faults, launch_shapes, expanded
    import re

    heads = "\n".join((build.CSRC / h).read_text() for h in
                      ("open_loop_rollout.cuh", "ip_forward.cuh", "ipddp_solve.cuh"))
    text = heads + "\n" + "\n".join(build.lane_units(T.LANES_HEADER).values())
    shapes = launch_shapes(text)
    assert launch_shape_faults(shapes) == []
    body = expanded(text)
    exported = set(re.findall(r"CDDP_EXPORT\((\w+)\)", body))
    registered = set(re.findall(r"CDDP_REGISTER\((\w+),", body))
    want = {"cddp_open_loop_rollout_bicycle7", "cddp_ip_forward_bicycle7_mpcc_m6",
            "cddp_ipddp_solve_bicycle7_mpcc_gn_m6"}
    assert want <= exported and want <= registered
