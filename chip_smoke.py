#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (``cddp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a nonzero exit:

1. start: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device -> exit nonzero with no result (no CPU fallback);
2. build: compile the three CUDA kernels from ``cddp_tpu_torch/ops/csrc``;
3. kernel vs plain PyTorch on the card, at the flagship problem's shapes
   (N=20, nx=3, nu=2) with B=4096: the Riccati and rollout kernels in
   float64 (atol 1e-9) and float32 (as accurate as the plain version against
   float64, per time step; see ``check``), the whole-solve kernel
   against the plain driver (float64: every status and iteration count equal,
   X, U and cost within 1e-8; float32: status, iterations and cost within
   rel 1e-4 equal on >= 99% of instances); in float64 also the branches the
   flagship does not reach: an indefinite Riccati case, the regularization
   limit (status 3), the early exit (1) and the acceptable exit (2), held
   exactly, and a 30-iteration run into last-bit ties, held as an envelope
   (see ``phase_branches``);
4. the flagship fleet (the workload of ``bench.py``: cold control-limited
   unicycle MPC, H=20, CLDDP, 10 iterations, float32, B=262144) through
   ``batched_solve``: the launch counts prove the whole-solve kernel ran it
   (and the Riccati and rollout kernels the per-pass engine); costs must be
   finite and fall; solves/s of the whole-solve kernel, the per-pass kernels
   and the plain driver on the card.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

B_CHECK = 4096
B_MAIN = 262144
HORIZON = 20
DT = 0.05
SEED = 0


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def flagship_problem(tt, dtype, device, horizon=HORIZON):
    """The problem of ``__graft_entry__._flagship_problem``, built on the card."""
    from cddp_tpu_torch.models import Unicycle

    kw = dict(device=device, dtype=dtype)
    obj = tt.quadratic_objective(
        torch.eye(3) * 0.1, torch.eye(2) * 0.05, torch.eye(3) * 100.0,
        [2.0, 2.0, math.pi / 2], DT, **kw,
    )
    prob = tt.problem(Unicycle(), obj, torch.zeros(3), horizon, DT, **kw)
    return prob.add_constraint(
        "ControlConstraint",
        tt.control_constraint([-2.0, -math.pi], [2.0, math.pi], **kw),
    )


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def stage_inputs(prob, B, gen):
    """Backward- and forward-pass inputs as the per-pass driver builds them,
    linearized about random nominal trajectories of the flagship problem."""
    from cddp_tpu_torch.models import rollout
    from cddp_tpu_torch.solvers import base

    dev, dtype = prob.x0.device, prob.x0.dtype
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=dtype)  # noqa: E731
    cc = prob.get_constraint("ControlConstraint")
    x0 = rand(B, 3) - 0.5
    U = (2.0 * rand(B, HORIZON, 2) - 1.0) * cc.upper * 0.75
    X = rollout(prob.model, x0, U, DT)
    A, Bm = base.discrete_jacobians(prob, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(prob, X, U)
    Vx = prob.objective.terminal_cost_gradient(X[:, -1])
    Vxx = prob.objective.terminal_cost_hessian(X[:, -1])
    reg = 10.0 ** (-6.0 + 4.0 * rand(B))
    back = (A, Bm, lx, lu, lxx, luu, lux, cc.lower - U, cc.upper - U, Vx, Vxx, reg)
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125], device=dev, dtype=dtype)
    alpha = alphas[torch.randint(0, 4, (B,), generator=gen, device=dev)]
    return X, U, back, alpha


def step_scale(w):
    """|w| reduced to the scale of one instance and time step: the largest
    |entry| of w[b, t] for (B, N, ...) tensors, of w[b] for (B, n), the entry
    itself for (B,)."""
    a = w.abs()
    if a.dim() >= 3:
        return a.flatten(2).amax(-1).reshape(a.shape[:2] + (1,) * (a.dim() - 2))
    if a.dim() == 2:
        return a.amax(-1, keepdim=True)
    return a


def consts_f64(consts):
    """The rollout's problem constants in float64."""
    return dataclasses.replace(consts, **{
        f: getattr(consts, f).double() for f in ("Q", "R", "Qf", "goal", "lower", "upper")
        if getattr(consts, f) is not None})


def abs_err(a, b):
    """|a - b| in float64, with NaN meeting NaN counted as 0."""
    a, b = a.double(), b.double()
    return torch.where(a.isnan() & b.isnan(), torch.zeros_like(b), (a - b).abs())


def check(name, got, want, truth=None):
    """Hold a kernel's outputs against its plain version's; returns the max
    abs error between them. Flags must be equal everywhere.

    float64 (no ``truth``): |got - want| <= 1e-9, NaN meeting NaN.

    float32: ``truth`` is the plain version run in float64 on the same
    inputs. Both float32 results are measured against it, per instance and
    time step, e(x) = max |x - truth| / (|truth| + step_scale(truth)), and
    the kernel must be as accurate as its plain version within a factor 2:
    e(got) <= 2 e(want) + 1e-6. (The backward recursion amplifies float32
    rounding in k to ~5e-4 of the step scale in both, so a fixed rtol
    between the two cannot be met.)"""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if not g.is_floating_point():
            if not bool((g == w).all()):
                raise AssertionError(f"{name}[{i}]: {int((g != w).sum())} flags differ")
            continue
        err = abs_err(g, w)
        worst = max(worst, float(err.max()))
        if truth is None:
            if not bool((err <= 1e-9).all()):
                raise AssertionError(f"{name}[{i}]: {int((~(err <= 1e-9)).sum())} "
                                     f"entries off, max abs err {float(err.max())}")
            continue
        t = truth[i].double()
        scale = t.abs() + step_scale(t)
        e_got = float((abs_err(g, t) / scale).nan_to_num(0.0).max())
        e_want = float((abs_err(w, t) / scale).nan_to_num(0.0).max())
        print(f"[kernels float32] {name}[{i}] scaled error against float64: "
              f"kernel {e_got:.3e}, plain {e_want:.3e}")
        if not e_got <= 2.0 * e_want + 1e-6:
            raise AssertionError(f"{name}[{i}]: kernel error {e_got:.3e} against "
                                 f"float64 exceeds 2x the plain version's {e_want:.3e}")
    return worst


def solve_pair(tt, p, opts):
    """The whole-solve kernel and the plain driver from cold seeds, as
    ``solve`` seeds them; returns (kernel Solution, plain Solution)."""
    from cddp_tpu_torch.ops.kernels import mega_clddp
    from cddp_tpu_torch.solvers import clddp

    x0, N, nu = p.x0, p.horizon, p.control_dim
    U0 = x0.new_zeros(x0.shape[0], N, nu)
    seeds = (x0[:, None].expand(-1, N + 1, -1).contiguous(), U0, U0.clone(),
             x0.new_zeros(x0.shape[0], N, nu, x0.shape[1]))
    return (mega_clddp._launch(p, opts, *seeds),
            clddp._solve(p, opts.replace(backward_engine="scan"), *seeds))


def check_solve_f64(label, kern, plain, min_share=1.0, traj_tol=1e-8):
    """float64: status and iteration count equal on at least ``min_share``
    of instances (all, unless a case allows ties), X and U within
    ``traj_tol`` where they are equal, and the cost within 1e-8 on every
    instance. Returns the status counts."""
    same = ((kern.status_code == plain.status_code)
            & (kern.iterations_completed == plain.iterations_completed))
    share = float(same.double().mean())
    if share < min_share:
        raise AssertionError(f"clddp_solve f64 {label}: status/iterations differ "
                             f"on {int((~same).sum())} instances")
    errs = {}
    for nm, g, w, tol in (
            ("X", kern.state_trajectory[same], plain.state_trajectory[same], traj_tol),
            ("U", kern.control_trajectory[same], plain.control_trajectory[same], traj_tol),
            ("cost", kern.final_objective, plain.final_objective, 1e-8)):
        errs[nm] = float((g - w).abs().max())
        if not errs[nm] <= tol:
            raise AssertionError(f"clddp_solve f64 {label} {nm}: max abs err "
                                 f"{errs[nm]} > {tol}")
    counts = torch.bincount(kern.status_code.long(), minlength=4).tolist()
    print(f"[kernels float64] clddp_solve {label}: status and iterations equal "
          f"on {int(same.sum())} of {same.numel()}; statuses {counts}; max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return counts


def phase_branches(tt, dev):
    """float64 cases that reach the kernels' other branches (phase 3): the
    BoxQP's failure exit under an indefinite Hessian, the regularization
    limit through the backward retry loop (status 3), the early exit on
    inf_du (status 1), and the acceptable-cost exit (status 2) beside the
    line-search regularization limit (3). At B=4096: the cases of
    tests/test_torch_clddp.py, and one at the flagship horizon."""
    from cddp_tpu_torch.ops.kernels import riccati
    from cddp_tpu_torch.options import RegularizationOptions

    dtype = torch.float64
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prob = flagship_problem(tt, dtype, dev)
    _, _, back, _ = stage_inputs(prob, B_CHECK, gen)
    # A negative shift makes Quu + reg*I indefinite on part of the batch.
    back = back[:-1] + (-torch.rand(B_CHECK, generator=gen, device=dev, dtype=dtype),)
    got = riccati._launch(*back)
    err = check("riccati_backward indefinite", got, riccati.riccati_backward_plain(*back))
    ok_share = float(got[-1].double().mean())
    print(f"[kernels float64] riccati_backward, reg in (-1, 0]: max abs err "
          f"{err:.3e}; ok on {ok_share:.4%}")
    if not 0.0 < ok_share < 1.0:
        raise AssertionError("the indefinite case must mix ok and failed instances")

    x0 = torch.rand(B_CHECK, 3, generator=gen, device=dev, dtype=dtype) - 0.5
    limit = flagship_problem(tt, dtype, dev, horizon=8)
    limit = limit.replace(x0=x0, objective=limit.objective.replace(
        R=-5.0 * torch.eye(2, device=dev, dtype=dtype)))
    opts = tt.CDDPOptions(max_iterations=4, regularization=RegularizationOptions(
        initial_value=1e-6, update_factor=10.0, max_value=1e-2))
    counts = check_solve_f64("regularization limit", *solve_pair(tt, limit, opts))
    if counts[3] != B_CHECK:
        raise AssertionError(f"regularization limit: statuses {counts}, not all 3")

    # The long H=6 run reaches its minimum to the last bit by iteration 2.
    # From then on its acceptable exit (0 < dJ < 1e-6) and its line search
    # are decided by one-ulp cost changes, whose sign differs where the two
    # engines' cost sums round apart, and at that flat minimum one ulp of
    # cost moves X and U by about sqrt(eps) ~ 1.5e-8. It is held to 99% equal
    # statuses, every cost within 1e-8 and X, U within 1e-6. The H=20 case
    # reaches statuses 2 and 3 before any such tie and is held exactly.
    cases = (
        ("early exit", 12, dict(max_iterations=8, tolerance=9.65), (1,), {}),
        ("acceptable and limit, long", 6, dict(max_iterations=30, tolerance=1e-3),
         (2, 3), dict(min_share=0.99, traj_tol=1e-6)),
        ("acceptable and limit", HORIZON, dict(
            max_iterations=10, tolerance=1e-4, acceptable_tolerance=1.0,
            regularization=RegularizationOptions(max_value=1e-4)), (0, 2, 3), {}),
    )
    for label, horizon, kw, reached, envelope in cases:
        p = flagship_problem(tt, dtype, dev, horizon=horizon).replace(x0=x0)
        counts = check_solve_f64(label, *solve_pair(tt, p, tt.CDDPOptions(**kw)),
                                 **envelope)
        if not all(counts[s] > 0 for s in reached):
            raise AssertionError(f"{label}: statuses {counts} miss {reached}")


def phase_kernels(tt, dev):
    """Each kernel against its plain version on the card (phase 3)."""
    from cddp_tpu_torch.ops.kernels import riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        prob = flagship_problem(tt, dtype, dev)
        X, U, back, alpha = stage_inputs(prob, B_CHECK, gen)

        # float32 is held against the plain version in float64 on the same
        # (float32) inputs; float64 against the plain version directly.
        exact = dtype == torch.float64
        got = riccati._launch(*back)
        want = riccati.riccati_backward_plain(*back)
        truth = None if exact else riccati.riccati_backward_plain(*(t.double() for t in back))
        err_r = check("riccati_backward", got, want, truth)
        k, K = want[0], want[1]
        consts = rollout_ops.lane_consts(prob)
        fwd = (consts, X[:, :-1], U, k, K, X[:, 0], alpha)
        truth = None if exact else rollout_ops.forward_rollout_plain(
            consts_f64(consts), *(t.double() for t in fwd[1:]))
        err_f = check("forward_rollout", rollout_ops._launch(*fwd),
                      rollout_ops.forward_rollout_plain(*fwd), truth)
        print(f"[kernels {tag}] riccati_backward max abs err {err_r:.3e}; "
              f"forward_rollout max abs err {err_f:.3e}")

        opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
        kern, plain = solve_pair(tt, prob.replace(x0=X[:, 0]), opts)
        same = ((kern.status_code == plain.status_code)
                & (kern.iterations_completed == plain.iterations_completed))
        share = float(same.double().mean())
        cost_err = float((kern.final_objective - plain.final_objective)[same].abs().max())
        if exact:
            check_solve_f64("flagship", kern, plain)
            phase_branches(tt, dev)
        else:
            # A float32 line-search fork (the Armijo ratio of some iteration
            # within rounding of its threshold) can leave status and iteration
            # count equal but move the cost well past 1e-4; it counts against
            # the 1% fork allowance like a status fork.
            rel = ((kern.final_objective - plain.final_objective).abs()
                   / plain.final_objective.abs())
            close = same & (rel <= 1e-4)
            share = float(close.double().mean())
            if share < 0.99:
                raise AssertionError(
                    f"clddp_solve f32: status, iterations and cost (rel 1e-4) "
                    f"agree on {share:.4f} of instances (need >= 0.99)")
            print(f"[kernels {tag}] clddp_solve: {int((same & ~close).sum())} "
                  f"instances with equal status and iterations forked in cost "
                  f"(max rel {float(rel[same].max()):.3e}); median rel cost err "
                  f"{float(rel.median()):.3e}")
        print(f"[kernels {tag}] clddp_solve vs plain driver: agree on "
              f"{share:.4%} of {B_CHECK}; max abs cost err where status and "
              f"iterations agree {cost_err:.3e}")
        results[tag] = dict(riccati_backward=err_r, forward_rollout=err_f,
                            clddp_solve=cost_err, clddp_solve_agreement=share)
    return results


def main():
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); the port has no CPU fallback here")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 must stay off (float32 matmul precision 'highest')")

    import cddp_tpu_torch as tt
    from cddp_tpu_torch.ops.kernels import build, dispatch_log, mega_clddp, riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
    from cddp_tpu_torch.parallel.batch import batched_solve
    from cddp_tpu_torch.solvers import base, clddp

    # --- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    fresh = not build.library_path().exists()
    build.library()
    print(f"[build] {'built' if fresh else 'loaded'} {build.library_path().name} "
          f"in {time.perf_counter() - t0:.1f} s")
    log = build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"[ptxas] {line.strip()}")

    # --- phase 3: kernels against their plain versions -----------------------
    errs = phase_kernels(tt, dev)

    # --- phase 4: the flagship fleet through batched_solve -------------------
    prob = flagship_problem(tt, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.rand(B_MAIN, 3, generator=gen, device=dev) - 0.5
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    engines = {
        "whole-solve kernel": opts,
        "per-pass kernels": opts.replace(solve_engine="xla"),
        "plain driver": opts.replace(backward_engine="scan"),
    }

    # Each engine's launch counts, zeroed just before its own run.
    sols, counts = {}, {}
    for name, o in engines.items():
        dispatch_log.reset()
        sols[name] = batched_solve(prob, x0, "CLDDP", o)
        torch.cuda.synchronize()
        counts[name] = dict(dispatch_log.launches)
        print(f"[main] launches of the {name} run: {counts[name]}")
    if counts["whole-solve kernel"] != {"clddp_solve": 1}:
        raise AssertionError(f"the default solve did not run as one whole-solve "
                             f"kernel launch: {counts['whole-solve kernel']}")
    per_pass = counts["per-pass kernels"]
    if ("clddp_solve" in per_pass or per_pass.get("riccati_backward", 0) < 1
            or per_pass.get("forward_rollout", 0) < 1):
        raise AssertionError(f"the per-pass engine did not run on the Riccati and "
                             f"rollout kernels alone: {per_pass}")
    if counts["plain driver"]:
        raise AssertionError(f"the plain driver launched kernels: {counts['plain driver']}")
    launches = {**counts["whole-solve kernel"], **per_pass}

    X0 = x0[:, None].expand(-1, HORIZON + 1, -1)
    cost0 = base.compute_cost(prob.replace(x0=x0), X0, torch.zeros(B_MAIN, HORIZON, 2, device=dev))
    whole = sols["whole-solve kernel"]
    cost = whole.final_objective
    if not bool(torch.isfinite(cost).all()):
        raise AssertionError("non-finite costs from the whole-solve kernel")
    if not float(cost.mean()) < float(cost0.mean()):
        raise AssertionError(f"mean cost {float(cost.mean())} did not fall below "
                             f"the initial {float(cost0.mean())}")
    if tuple(whole.control_trajectory.shape) != (B_MAIN, HORIZON, 2):
        raise AssertionError(f"control trajectory shape {tuple(whole.control_trajectory.shape)}")
    print(f"[main] B={B_MAIN}: mean cost {float(cost0.mean()):.4f} -> "
          f"{float(cost.mean()):.4f}; statuses "
          f"{torch.bincount(whole.status_code.long(), minlength=4).tolist()}")
    plain_cost = sols["plain driver"].final_objective
    rel = (cost - plain_cost).abs() / plain_cost.abs()
    close = float((rel <= 1e-4).double().mean())
    print(f"[main] whole-solve kernel cost within rel 1e-4 of the plain driver's "
          f"on {close:.4%} of {B_MAIN} (median rel {float(rel.median()):.3e})")
    if close < 0.99:
        raise AssertionError(f"whole-solve kernel and plain driver costs agree on "
                             f"{close:.4%} of instances (need >= 99%)")

    reps = {"whole-solve kernel": 20, "per-pass kernels": 3, "plain driver": 2}
    rates = {}
    for name, o in engines.items():
        def run(o=o):
            return batched_solve(prob, x0, "CLDDP", o).final_objective

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps[name]):
            run()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps[name]
        rates[name] = B_MAIN / dt
        agree = float((sols[name].status_code == whole.status_code).double().mean())
        print(f"[main] {name}: {rates[name]:.1f} solves/s ({dt * 1e3:.2f} ms per "
              f"B={B_MAIN} solve, {reps[name]} reps); status agrees with the "
              f"whole-solve kernel on {agree:.4%}  [{smi}]")

    # Kernel times at the main path's batch against their plain versions.
    X, U, back, alpha = stage_inputs(prob, B_MAIN, torch.Generator(device=dev).manual_seed(SEED))
    k, K = riccati.riccati_backward_plain(*back)[:2]
    consts = rollout_ops.lane_consts(prob)
    fwd = (consts, X[:, :-1], U, k, K, X[:, 0], alpha)
    seeds = (X0.contiguous(), torch.zeros(B_MAIN, HORIZON, 2, device=dev),
             torch.zeros(B_MAIN, HORIZON, 2, device=dev),
             torch.zeros(B_MAIN, HORIZON, 2, 3, device=dev))
    p = prob.replace(x0=x0)
    plain_opts = engines["plain driver"]
    timing = {
        "riccati_backward": (cuda_ms(lambda: riccati._launch(*back), 20),
                             cuda_ms(lambda: riccati.riccati_backward_plain(*back), 2)),
        "forward_rollout": (cuda_ms(lambda: rollout_ops._launch(*fwd), 20),
                            cuda_ms(lambda: rollout_ops.forward_rollout_plain(*fwd), 2)),
        "clddp_solve": (cuda_ms(lambda: mega_clddp._launch(p, opts, *seeds), 20),
                        cuda_ms(lambda: clddp._solve(p, plain_opts, *seeds), 1)),
    }
    for name, (ms, plain_ms) in timing.items():
        print(f"[timing] {name} at B={B_MAIN}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms  [{smi}]")

    sources = {
        "riccati_backward": ("cddp_tpu_torch/ops/csrc/riccati_backward.cu",
                             "cddp_tpu/ops/pallas/riccati.py:236"),
        "forward_rollout": ("cddp_tpu_torch/ops/csrc/forward_rollout.cu",
                            "cddp_tpu/ops/pallas/rollout.py:616"),
        "clddp_solve": ("cddp_tpu_torch/ops/csrc/clddp_solve.cu",
                        "cddp_tpu/ops/pallas/mega_clddp.py:303"),
    }
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs["float32"][name],
         "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name, (src, rep) in sources.items()
    ]}
    print(f"[card] {smi}; solves/s: " + ", ".join(
        f"{n} {r:.1f}" for n, r in rates.items()))
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
