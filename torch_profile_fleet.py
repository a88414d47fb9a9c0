#!/usr/bin/env python3
"""Where the time goes in the port's fleet solves, on one NVIDIA GPU.

    python3 torch_profile_fleet.py [--batch 262144] [--solver CLDDP|IPDDP|LogDDP|MSIPDDP|all ...]
                                   [--engine whole|per-pass|plain|all ...] [--sass] [--boxqp]
                                   [--problem box|obstacle|tracking|terminal_ineq|terminal_eq]
    python3 torch_profile_fleet.py --save-outputs PATH [--batch B]
    python3 torch_profile_fleet.py --compare-outputs A B
    python3 torch_profile_fleet.py --compare-sass TREE_A TREE_B
    python3 torch_profile_fleet.py --model-kernels [--batch 262144]

For the flagship fleet (cold control-limited unicycle MPC, H=20, 10
iterations, tolerance 1e-4, float32, x0 ~ U(-0.5, 0.5)) under each solver
and engine (whole-solve kernel, per-pass kernels, plain driver; LogDDP and
MSIPDDP have no per-pass kernels, and their ``solve_engine="xla"`` engine
is the plain driver seeded by the open-loop rollout kernel), or with
``--problem obstacle`` for the IPDDP obstacle fleet
(``chip_smoke.obstacle_problem``: the control box and a keep-out ball, dt =
0.03; IPDDP only, the other solvers take box stacks only), or with
``--problem tracking`` for the tracking fleet (``chip_smoke.tracking_problem``:
the unicycle tracking a per-step arc reference, which runs the kernels'
tracking variants), or with ``--problem terminal_ineq`` / ``terminal_eq``
for the terminal-constraint fleets (``chip_smoke.terminal_problem``: the box
fleet with A x_N <= b, kernel 7's ``m4_ti2``, or x_N = target, ``m4_te3``;
IPDDP only, the only solver that reads terminal constraints), it prints:
the host-clock ms of one ``batched_solve`` (after a warm-up, ending in a
synchronize); under ``torch.profiler`` the device busy time (the sum over
the CUDA kernel rows, which do not overlap on one stream), the profiled
wall, the launch count and the eight kernels with the most device time;
and the peak device memory of the solve. For the whole-solve kernel it also
prints the work the kernel reports per instance (backward attempts and
sweeps, ``mega_*.launch_counting_work``) and its warp divergence, so that
two builds whose solves take different paths compare per unit of work; for
the per-pass IPDDP engine, each kernel's wrapper ms a call (CUDA events,
layout copies included) beside its device ms a launch.
First it prints what the card reports of every kernel (registers, spill
bytes, shared memory, resident blocks per SM); with ``--sass``, the loops
of the four whole-solve kernels and the condensed IPDDP backward (float32,
m = 4) in the compiled SASS
(``cuobjdump``): each backward branch's body with its instruction count
and its loads, stores and floating-point instructions. With ``--boxqp``,
how many of the enumerated BoxQP's nine active sets the CLDDP fleet's
backward steps evaluate when the search stops at the first valid one, per
instance and per warp of 32 consecutive instances (its slowest lane), from
the plain driver's selections on the card (``boxqp_first_valid``). Imports
nothing of JAX.

A/B of two source trees: run it in each tree's own checkout (each builds
its own ``.torch_ext_build/``), in turns, in one call on one card, and
compare the profiler's row of the kernel (device time without the wrapper's
layout copies). ``--save-outputs PATH`` instead saves the default engine's
solutions of the fleets without terminal constraints (the box and tracking
problems under the four solvers, the obstacle problem under IPDDP; 10
iterations, tolerance 1e-4, float32 and float64) with ``torch.save``, and ``--compare-outputs A B`` says of two
such files whether every field holds the same bits (exit status 1 if not):
run the first in each tree, the second once. ``--compare-sass TREE_A
TREE_B`` says whether every kernel of the first tree's built library
compiles to the same SASS instructions in the second's (``cuobjdump``;
exit status 1 if not).

``--model-kernels`` profiles the model-lane kernels 2 and 4 of the models
past the unicycle alone, in a process that runs nothing else: the line-search
rollout (kernel 2) on the pendulum's and the cart-pole's fleets in the goal
and the tracking forms and on the car's, the open-loop rollout (kernel 4)
on the pendulum, the cart-pole, HCW and the car, on the
operands ``chip_smoke.py`` times them on (``stage_inputs`` about the
fleet's problem; random controls in the box; the car's fleet at
``chip_smoke.CAR_B``). Each kernel's device ms a launch by the profiler,
its wrapper ms by CUDA events, and its bound from the same operands.
"""

import argparse
import re
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

import chip_smoke


SOLVERS = ("CLDDP", "IPDDP", "LogDDP", "MSIPDDP")
ENGINES = {"whole": "whole-solve kernel", "per-pass": "per-pass kernels", "plain": "plain driver"}
WHOLE_SOLVE = {"CLDDP": "clddp_solve", "IPDDP": "ipddp_solve", "LogDDP": "logddp_solve",
               "MSIPDDP": "msipddp_solve"}


def engines(tt, solver):
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    plain = {"CLDDP": opts.replace(backward_engine="scan"),
             "IPDDP": chip_smoke.plain_ip_options(tt, opts)}.get(
        solver, opts.replace(solve_engine="xla", backward_engine="scan"))
    return {"whole-solve kernel": opts, "per-pass kernels": opts.replace(solve_engine="xla"),
            "plain driver": plain}


def whole_solve_work(solver, prob, x0, opts):
    """The work rows the whole-solve kernel reports for this fleet, from the
    seeds ``solve`` builds: (B,) tensors of backward attempts, sweeps, ..."""
    from cddp_tpu_torch.ops.kernels import mega_clddp, mega_ipddp, mega_logddp, mega_msipddp

    p = prob.replace(x0=x0)
    if solver == "CLDDP":
        B, N = x0.shape[0], p.horizon
        U0 = x0.new_zeros(B, N, 2)
        seeds = (x0[:, None].expand(-1, N + 1, -1).contiguous(), U0, U0.clone(),
                 x0.new_zeros(B, N, 2, 3))
        return mega_clddp.launch_counting_work(p, opts, *seeds)[-1]
    if solver == "IPDDP":
        pw, seeds = chip_smoke.ip_seeds(prob, opts, x0)
        return mega_ipddp.launch_counting_work(pw, opts, *seeds)[-1]
    mega = mega_logddp if solver == "LogDDP" else mega_msipddp
    return mega.launch_counting_work(p, opts, *chip_smoke.barrier_seeds(solver, p, opts))[-1]


# The per-pass IPDDP engine's kernel wrappers, as the driver looks them up:
# (module, attribute, kernel name).
PER_PASS_WRAPPERS = {"IPDDP": (("ipddp_riccati", "ipddp_backward", "ipddp_backward"),
                               ("ip_rollout", "ip_forward", "ip_forward"))}


def per_pass_wrapper_ms(solver, prob, x0, opts, prof, smi):
    """For a per-pass engine, each kernel's wrapper ms a call (CUDA events
    around the wrapper in one more solve, its layout copies included) beside
    its device ms a launch (the profiler's kernel rows of ``prof``), so the
    cost of the wrapper around the kernel shows on the fleet itself."""
    import importlib

    from cddp_tpu_torch.parallel.batch import batched_solve

    for module, attr, kernel in PER_PASS_WRAPPERS.get(solver, ()):
        mod = importlib.import_module(f"cddp_tpu_torch.ops.kernels.{module}")
        wrapper, events = getattr(mod, attr), []

        def timed(*args, wrapper=wrapper, events=events):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = wrapper(*args)
            stop.record()
            events.append((start, stop))
            return out

        setattr(mod, attr, timed)
        try:
            batched_solve(prob, x0, solver, opts)
            torch.cuda.synchronize()
        finally:
            setattr(mod, attr, wrapper)
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and f"cddp::{kernel}_kernel<" in e.key]
        launches = sum(e.count for e in rows)
        dev_ms = sum(e.self_device_time_total for e in rows) / max(launches, 1) / 1e3
        wrap_ms = sum(a.elapsed_time(b) for a, b in events) / max(len(events), 1)
        print(f"    {kernel}: {len(events)} calls, wrapper {wrap_ms:.3f} ms a call (CUDA "
              f"events), device {dev_ms:.3f} ms a launch over {launches} (profiler)  [{smi}]")


# Kernels whose SASS loops ``--sass`` prints: the four whole solves and the
# condensed IPDDP backward.
SASS_KERNELS = tuple(WHOLE_SOLVE.values()) + ("ipddp_backward",)


def sass_loops(smi):
    """Print the loops of ``SASS_KERNELS`` (float32, m = 4) in the library's
    SASS: for each backward branch, its body's instruction count and its
    global loads (LDG), cp.async copies (LDGSTS), global stores (STG),
    shared loads and stores (LDS, STS), local loads and stores (LDL, STL:
    spills), barriers (BAR), floating-point instructions (F*), and branches
    (BRA)."""
    from cddp_tpu_torch.ops.kernels import build

    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    kinds = ("LDG", "LDGSTS", "STG", "LDS", "STS", "LDL", "STL", "BAR", "F", "BRA")
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        wanted = [k for k in SASS_KERNELS if f"{len(k) + 7}{k}_kernelIf" in name]
        if not wanted or ("logddp" in wanted[0] or "ipddp" in wanted[0]) and "Li4E" not in name:
            continue
        if "Lb1E" in name:  # a tracking variant (TRACK = true): the goal form's loops only
            continue
        ins = []  # (address, opcode, branch target or None)
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", fn):
            tgt = re.search(r"(0x[0-9a-f]+)", m.group(3)) if m.group(2).startswith("BRA") else None
            ins.append((int(m.group(1), 16), m.group(2), int(tgt.group(1), 16) if tgt else None))
        print(f"[sass] {wanted[0]} f32: {len(ins)} instructions  [{smi}]")
        for addr, _, tgt in ins:
            if tgt is None or tgt >= addr:
                continue
            body = Counter()
            for a, o, _ in ins:
                if tgt <= a <= addr:
                    base = o.split(".")[0]
                    body["all"] += 1
                    body[base if base in kinds else ("F" if base[0] == "F" else "other")] += 1
            print(f"    loop {tgt:#07x}-{addr:#07x}: {body['all']} instructions, "
                  + ", ".join(f"{k} {body[k]}" for k in kinds))


def boxqp_first_valid(prob, x0, opts, smi):
    """Run the plain CLDDP driver on the fleet and record, for every backward
    step of every instance, the index in product order of the active set
    its BoxQP took (all of them when none was valid); print how many
    configurations a search that stops at the first valid one evaluates,
    per lane and per warp (its slowest lane), and how often the all-free
    configuration 0 is taken. The lanes of a warp stay in step through the
    backward passes here: every instance makes one attempt per iteration."""
    from cddp_tpu_torch.ops.kernels import riccati
    from cddp_tpu_torch.parallel.batch import batched_solve

    seen = []
    enum = riccati.boxqp_solve_enum

    def recording(H, g, lower, upper):
        qp = enum(H, g, lower, upper)
        nu = g.shape[-1]
        digit = torch.where(qp.free, 0, torch.where(qp.x == lower, 1,
                                                    torch.where(qp.x == upper, 2, 3)))
        place = 3 ** torch.arange(nu - 1, -1, -1, device=g.device)
        first = (digit.clamp(max=2) * place).sum(-1) + 1
        seen.append(torch.where((digit == 3).any(-1), torch.full_like(first, 3 ** nu), first))
        return qp

    riccati.boxqp_solve_enum = recording
    try:
        batched_solve(prob, x0, "CLDDP", opts.replace(backward_engine="scan"))
    finally:
        riccati.boxqp_solve_enum = enum
    ev = torch.stack(seen).double()  # (backward steps, B)
    warps = ev[:, : ev.shape[1] // 32 * 32].reshape(ev.shape[0], -1, 32)
    print(f"[boxqp] CLDDP fleet, {ev.shape[0]} backward steps x {ev.shape[1]} instances: "
          f"configurations evaluated up to the first valid one, mean per lane "
          f"{float(ev.mean()):.4f}, mean per warp of its slowest lane "
          f"{float(warps.amax(-1).mean()):.4f} (of 9); configuration 0 taken by "
          f"{float((ev == 1).double().mean()):.4%} of lane steps, by all 32 lanes in "
          f"{float((warps == 1).all(-1).double().mean()):.4%} of warp steps  [{smi}]")


def save_outputs(path, batch, smi):
    """Save the default engine's solutions of the box, obstacle and
    tracking fleets, float32 and float64, from x0 ~ U(-0.5, 0.5) (seed ``chip_smoke.SEED``), to
    ``path``: {"<problem>/<solver>/<dtype>/<field>": CPU tensor}."""
    import cddp_tpu_torch as tt
    from cddp_tpu_torch.parallel.batch import batched_solve

    dev = torch.device("cuda", 0)
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    out = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
        x0 = (torch.rand(batch, 3, generator=gen, device=dev) - 0.5).to(dtype)
        for label, make, solvers in (("box", chip_smoke.flagship_problem, SOLVERS),
                                     ("obstacle", chip_smoke.obstacle_problem, ("IPDDP",)),
                                     ("tracking", chip_smoke.tracking_problem, SOLVERS)):
            prob = make(tt, dtype, dev)
            for solver in solvers:
                sol = batched_solve(prob, x0, solver, opts)
                fields = {f: getattr(sol, f) for f in SAVED_FIELDS}
                for kind in ("dual_trajectories", "slack_trajectories"):
                    named = getattr(sol, kind) or {}
                    fields.update({f"{kind}[{k}]": v for k, v in named.items()})
                for f, v in fields.items():
                    if v is not None:
                        out[f"{label}/{solver}/{str(dtype)[6:]}/{f}"] = v.detach().cpu()
    torch.save(out, path)
    print(f"[outputs] saved {len(out)} fields of B={batch} fleets to {path}  [{smi}]")


SAVED_FIELDS = ("state_trajectory", "control_trajectory", "feedforward_gains",
                "feedback_gains", "final_objective", "iterations_completed", "status_code",
                "inf_du", "inf_pr", "barrier_mu", "costate_trajectory")


def compare_outputs(a, b):
    """Whether two ``save_outputs`` files hold the same bits, fleet by fleet;
    returns 1 if any field differs or is missing from one of them."""
    A, B = torch.load(a), torch.load(b)
    fleets = sorted({k.rsplit("/", 1)[0] for k in A} | {k.rsplit("/", 1)[0] for k in B})
    differ = 0
    for fleet in fleets:
        keys = sorted({k for k in A if k.startswith(fleet + "/")}
                      | {k for k in B if k.startswith(fleet + "/")})
        bad = [k.rsplit("/", 1)[1] for k in keys
               if k not in A or k not in B or not torch.equal(A[k], B[k])]
        differ += bool(bad)
        print(f"[outputs] {fleet}: {len(keys)} fields, "
              + ("every one the same bits" if not bad else f"differ: {bad}"))
    print(f"[outputs] {len(fleets)} fleets, {differ} differ")
    return int(differ > 0)


def sass_functions(tree):
    """{kernel: its SASS instructions} of the kernel library built in
    ``tree`` (its ``.torch_ext_build/``), addresses and encodings dropped.
    Kernel 7 is keyed by its model, m, ball row and TRACK arguments alone:
    since its terminal variants its name carries MT, PT and their
    parameter, and its variants without them (MT = PT = 0) are compared
    with the kernels of those arguments."""
    from cddp_tpu_torch.ops.kernels import build

    lib = sorted(Path(tree, ".torch_ext_build").glob("libcddp_kernels_*.so"))[0]
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        m = re.match(r"(_ZN4cddp18ipddp_solve_kernelI.NS_8UnicycleELi\d+ELin?\d+ELb\d)"
                     r"(ELi0ELi0)?EE", name)
        if m:
            name = m.group(1)
        elif name.startswith("_ZN4cddp18ipddp_solve_kernel"):
            continue  # a terminal variant: no counterpart before them
        out[name] = [re.sub(r"\s+", " ", i)
                     for i in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", fn)]
    return out


def compare_sass(a, b):
    """Whether every kernel of tree ``a``'s library compiles to the same
    SASS instructions in tree ``b``'s; returns 1 if one differs or is
    missing."""
    A, B = sass_functions(a), sass_functions(b)
    bad = sorted(k for k in A if A[k] != B.get(k))
    print(f"[sass] {len(A)} kernels in {a}; {len(A) - len(bad)} the same instructions in {b}; "
          f"{len(set(B) - set(A))} in {b} only")
    for k in bad:
        print(f"[sass] differs: {k[:110]} ({len(A[k])} against "
              f"{len(B[k]) if k in B else None} instructions)")
    return int(bool(bad))


def model_kernels(tt, batch, smi, dev=None):
    """``--model-kernels``: kernels 2 and 4 of the pendulum, the cart-pole,
    HCW and the car, each timed alone (see the module text), on ``dev``
    (the card when None)."""
    from cddp_tpu_torch.ops.kernels import ip_rollout, riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    dev = dev or torch.device("cuda", 0)
    cases = [(f"forward_rollout{'_track' if tr else ''}@{m}",
              chip_smoke.zoo_problem(tt, torch.float32, dev, m, tracking=tr), batch)
             for m in ("pendulum", "cartpole") for tr in (False, True)]
    cases.append(("forward_rollout@car", chip_smoke.car_problem(tt, torch.float32, dev),
                  chip_smoke.CAR_B))
    cases += [(f"open_loop_rollout@{m}", chip_smoke.zoo_problem(tt, torch.float32, dev, m),
               batch) for m in ("pendulum", "cartpole", "hcw")]
    cases.append(("open_loop_rollout@car", chip_smoke.car_problem(tt, torch.float32, dev),
                  chip_smoke.CAR_B))
    for name, prob, B in cases:
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
        if name.startswith("forward_rollout"):
            X, U, back, alpha = chip_smoke.stage_inputs(prob, B, gen)
            consts = rollout_ops.lane_consts(prob)
            k, K = riccati._launch(*back)[:2]
            args = (X[:, :-1], U, k, K, X[:, 0], alpha)
            fn = lambda consts=consts, args=args: rollout_ops._launch(consts, *args)  # noqa: E731
            ins = args + chip_smoke.reference_read(prob)
            ops = chip_smoke.count_ops(rollout_ops.forward_rollout_plain, consts,
                                       *chip_smoke.one(args))
        else:
            x0 = chip_smoke.fleet_x0(prob, B, gen)
            cc = prob.get_constraint("ControlConstraint")
            U = (2.0 * torch.rand(B, prob.horizon, prob.control_dim, generator=gen,
                                  device=dev) - 1.0) * cc.upper
            entry, dt = rollout_ops.model_entry(prob.model), prob.timestep
            model = prob.model.to(torch.float32)
            fn = (lambda model=model, entry=entry, x0=x0, U=U, dt=dt:  # noqa: E731
                  ip_rollout._launch_open_loop(model, entry, x0, U, dt))
            ins = (x0, U)
            ops = chip_smoke.count_ops(ip_rollout.open_loop_rollout_plain, model, x0[:1], U[:1],
                                       dt)
        out = fn()
        outs = out if isinstance(out, tuple) else (out[:, 1:],)
        nbytes = chip_smoke.unique_bytes(ins) + chip_smoke.unique_bytes(outs)
        b_ms, b_by = chip_smoke.bound(nbytes, ops * B, torch.float32)
        ms = chip_smoke.cuda_ms(fn, 20)
        dev_ms, source = chip_smoke.device_ms(fn, name.split("@")[0].replace("_track", ""), 20)
        print(f"[model kernels] {name} at B={B}, N={prob.horizon}: {dev_ms:.4f} ms device "
              f"({source}), {ms:.4f} ms with the wrapper (CUDA events), bound {b_ms:.4f} ms "
              f"by {b_by} ({nbytes / 1e9:.4f} GB); device / bound {dev_ms / b_ms:.2f}  [{smi}]")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=chip_smoke.B_MAIN)
    ap.add_argument("--solver", nargs="+", default=["all"], choices=SOLVERS + ("all",))
    ap.add_argument("--engine", nargs="+", default=["all"], choices=tuple(ENGINES) + ("all",))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--boxqp", action="store_true")
    ap.add_argument("--problem", default="box", choices=("box", "obstacle", "tracking",
                                                         "terminal_ineq", "terminal_eq"))
    ap.add_argument("--save-outputs", metavar="PATH")
    ap.add_argument("--compare-outputs", nargs=2, metavar=("A", "B"))
    ap.add_argument("--compare-sass", nargs=2, metavar=("TREE_A", "TREE_B"))
    ap.add_argument("--model-kernels", action="store_true")
    args = ap.parse_args()
    if args.compare_outputs:
        raise SystemExit(compare_outputs(*args.compare_outputs))
    if args.compare_sass:
        raise SystemExit(compare_sass(*args.compare_sass))
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_fleet: no CUDA device")
    import cddp_tpu_torch as tt
    from cddp_tpu_torch.parallel.batch import batched_solve

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.model_kernels:
        return model_kernels(tt, args.batch, smi)
    chip_smoke.print_kernel_attributes(smi)
    if args.save_outputs:
        return save_outputs(args.save_outputs, args.batch, smi)
    if args.sass:
        sass_loops(smi)
    dev = torch.device("cuda", 0)
    # (terminal_problem looked up only when asked: an A/B runs this script
    # against a parent tree's chip_smoke, which may not have it.)
    make = {"box": chip_smoke.flagship_problem, "obstacle": chip_smoke.obstacle_problem,
            "tracking": chip_smoke.tracking_problem,
            "terminal_ineq": lambda *a: chip_smoke.terminal_problem(*a, "m4_ti2"),
            "terminal_eq": lambda *a: chip_smoke.terminal_problem(*a, "m4_te3")}[args.problem]
    prob = make(tt, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    x0 = torch.rand(args.batch, 3, generator=gen, device=dev) - 0.5
    if args.boxqp:
        boxqp_first_valid(prob, x0, tt.CDDPOptions(max_iterations=10, tolerance=1e-4), smi)
    solvers = SOLVERS if "all" in args.solver else args.solver
    if args.problem in ("obstacle", "terminal_ineq", "terminal_eq"):
        solvers = [s for s in solvers if s == "IPDDP"]
    wanted = set(ENGINES.values()) if "all" in args.engine else {ENGINES[e] for e in args.engine}
    for solver in solvers:
        for name, opts in engines(tt, solver).items():
            if name not in wanted:
                continue
            batched_solve(prob, x0, solver, opts)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            batched_solve(prob, x0, solver, opts)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                batched_solve(prob, x0, solver, opts)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
            launches = sum(e.count for e in rows)
            print(f"[{solver} {args.problem} {name}] B={args.batch}: {host_ms:.2f} ms host clock; "
                  f"profiled wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
                  f"({busy_ms / wall_ms:.1%}), {launches} kernel launches; peak "
                  f"{peak:.2f} GiB  [{smi}]")
            for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
                print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
            if name == ENGINES["per-pass"]:
                per_pass_wrapper_ms(solver, prob, x0, opts, prof, smi)
            if name == ENGINES["whole"]:
                work = whole_solve_work(solver, prob, x0, opts)
                print(f"    work per instance (backward attempts, sweeps, ...): "
                      + ", ".join(f"{float(w.double().mean()):.4f}" for w in work)
                      + f"; warp divergence {chip_smoke.warp_divergence(work):.4f}")


if __name__ == "__main__":
    main()
