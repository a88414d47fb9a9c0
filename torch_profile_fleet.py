#!/usr/bin/env python3
"""Where the time goes in the port's fleet solves, on one NVIDIA GPU.

    python3 torch_profile_fleet.py [--batch 262144] [--solver CLDDP|IPDDP|LogDDP|MSIPDDP|all]
                                   [--engine whole|per-pass|plain|all]

For the flagship fleet (cold control-limited unicycle MPC, H=20, 10
iterations, tolerance 1e-4, float32, x0 ~ U(-0.5, 0.5)) under each solver
and engine (whole-solve kernel, per-pass kernels, plain driver; LogDDP and
MSIPDDP have no per-pass kernels, and their ``solve_engine="xla"`` engine
is the plain driver seeded by the open-loop rollout kernel), it prints:
the host-clock ms of one ``batched_solve`` (after a warm-up, ending in a
synchronize); under ``torch.profiler`` the device busy time (the sum over
the CUDA kernel rows, which do not overlap on one stream), the profiled
wall, the launch count and the eight kernels with the most device time;
and the peak device memory of the solve. First it prints what the card
reports of every kernel (registers, spill bytes, shared memory, resident
blocks per SM). Imports nothing of JAX.
"""

import argparse
import subprocess
import time

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

import chip_smoke


SOLVERS = ("CLDDP", "IPDDP", "LogDDP", "MSIPDDP")
ENGINES = {"whole": "whole-solve kernel", "per-pass": "per-pass kernels", "plain": "plain driver"}


def engines(tt, solver):
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    plain = {"CLDDP": opts.replace(backward_engine="scan"),
             "IPDDP": chip_smoke.plain_ip_options(tt, opts)}.get(
        solver, opts.replace(solve_engine="xla", backward_engine="scan"))
    return {"whole-solve kernel": opts, "per-pass kernels": opts.replace(solve_engine="xla"),
            "plain driver": plain}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=chip_smoke.B_MAIN)
    ap.add_argument("--solver", default="all", choices=SOLVERS + ("all",))
    ap.add_argument("--engine", default="all", choices=tuple(ENGINES) + ("all",))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_fleet: no CUDA device")
    import cddp_tpu_torch as tt
    from cddp_tpu_torch.parallel.batch import batched_solve

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    chip_smoke.print_kernel_attributes(smi)
    dev = torch.device("cuda", 0)
    prob = chip_smoke.flagship_problem(tt, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    x0 = torch.rand(args.batch, 3, generator=gen, device=dev) - 0.5
    for solver in (SOLVERS if args.solver == "all" else (args.solver,)):
        for name, opts in engines(tt, solver).items():
            if args.engine != "all" and name != ENGINES[args.engine]:
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
            print(f"[{solver} {name}] B={args.batch}: {host_ms:.2f} ms host clock; "
                  f"profiled wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
                  f"({busy_ms / wall_ms:.1%}), {launches} kernel launches; peak "
                  f"{peak:.2f} GiB  [{smi}]")
            for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
                print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


if __name__ == "__main__":
    main()
