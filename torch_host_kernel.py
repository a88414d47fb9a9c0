#!/usr/bin/env python3
"""Kernel 7 (the whole IPDDP solve) built as host C++ and run on the CPU.

    python3 torch_host_kernel.py [--model unicycle|pendulum|hcw]
                                 [--variants m4 m4_ti1 m4_ti2 m4_te3 m4_te3_ti1]
                                 [--dtype f64|f32] [--batch 1024] [--iterations 10]
                                 [--shares] [--work] [--svd] [--warm]

A machine with no GPU and no ``nvcc`` can still hold the kernel's
arithmetic against the plain driver. The script copies
``cddp_tpu_torch/ops/csrc`` to a scratch directory under ``build/``, makes
each ``cp.async`` copy a plain load, defines the shared-memory buffer,
replaces the launch by a loop over one-thread blocks, compiles
``ipddp_solve.cu`` and ``ipddp_solve_terminal.cu`` with ``g++ -O2
-ffp-contract=off`` (as the float64 build's ``--fmad=false``) against a
stand-in ``cuda_runtime.h``, and points ``build.function`` at the result, so
that ``mega_ipddp._launch`` runs the kernel's code on CPU tensors. Then,
on the IPDDP box fleet (variant ``m4``) and its terminal fleets
(``chip_smoke.terminal_problem``), cold seeds from x0 ~ U(-0.5, 0.5) of
numpy's generator with seed 0; with ``--model pendulum`` on the pendulum
fleet's control box (``m2``; ``m2_track`` its tracking form), with
``--model hcw`` on the rendezvous fleet (``m6_te6``: its control box and
the terminal equality x_N = 0), both ``chip_smoke.zoo_problem``, from
``chip_smoke.fleet_x0`` with a torch generator seeded 0 (with ``--warm``,
warm seeds instead: the
plain driver's cold solve from those x0, then one tick, x0 advanced one step
and the plan shifted, and ``ipddp.warm_start`` from the solve's state, as
``chip_smoke.py``'s phase 13 seeds kernel 7):

- by default, each variant's statuses and iteration counts against the
  plain driver's and the largest X, U, cost, multiplier and terminal-dual
  differences where they agree;
- ``--shares`` (float32): the share of instances whose status, iterations
  and cost (rel 1e-4) the kernel and the plain driver agree on at five
  iterations and at ``--iterations``, and the plain driver's share with
  itself from x0 one ulp up (``chip_smoke.cost_share``);
- ``--work``: quantiles of the kernel's line-search sweeps per instance;
- ``--svd``: on the model's terminal-equality fleet, the share of the plain
  driver's backward calls whose SVD floor (1e-8 times the largest singular
  value less the smallest) is positive, and the smallest ratio of the
  sensitivity matrix's singular values.

These are counts and differences from a CPU run; none is a time or a
measurement of the card.
"""

import argparse
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke
import cddp_tpu_torch as tt
from cddp_tpu_torch.ops.kernels import build, mega_ipddp
from cddp_tpu_torch.solvers import ipddp

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "host_kernel"
SOURCES = ("ipddp_solve", "ipddp_solve_terminal")

STAND_IN = """#pragma once
#include <cmath>
#include <cstddef>
using std::isfinite;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x, y, z; };
inline dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
template <typename T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
"""


def edit(path, old, new):
    text = path.read_text()
    if old not in text:
        raise SystemExit(f"torch_host_kernel: {path.name} no longer has {old[:60]!r}")
    path.write_text(text.replace(old, new, 1))


def build_host():
    """Compile the two kernel-7 sources for float32 and float64; returns
    {(source, tag): ctypes.CDLL}."""
    src = SCRATCH / "csrc"
    shutil.rmtree(SCRATCH, ignore_errors=True)
    shutil.copytree(build.CSRC, src)
    (SCRATCH / "cuda_runtime.h").write_text(STAND_IN)
    edit(src / "sweep_stage.cuh", '               : "memory");\n#endif\n}\n\n// Close',
         '               : "memory");\n#else\n  *dst = *src;\n#endif\n}\n\n// Close')
    edit(src / "ipddp_solve.cuh",
         "ipddp_solve_kernel<T, Mdl, M, BALL, TRACK, MT, PT><<<blocks, kSolveThreads, smem, "
         "stream>>>(",
         "for (blockIdx.x = 0, blockDim.x = 1; blockIdx.x < unsigned(B); ++blockIdx.x) "
         "ipddp_solve_kernel<T, Mdl, M, BALL, TRACK, MT, PT>(")
    jobs = {}
    for name in SOURCES:
        edit(src / f"{name}.cu", '#include "ipddp_solve.cuh"\n',
             '#include "ipddp_solve.cuh"\n'
             "namespace cddp { alignas(16) unsigned char cddp_smem[1 << 22]; }\n")
        for tag, flags in (("f32", []), ("f64", ["-DCDDP_F64"])):
            out = SCRATCH / f"{name}_{tag}.so"
            jobs[(name, tag)] = (out, subprocess.Popen(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", *flags,
                 f"-I{SCRATCH}", f"-I{src}", "-x", "c++", str(src / f"{name}.cu"), "-o",
                 str(out)], stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (out, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"g++ failed for {key}:\n{err[-4000:]}")
        libs[key] = ctypes.CDLL(str(out))
    return libs


def use_host(libs):
    """Point the kernel library's lookup at the host builds."""
    def function(name, argtypes):
        source = SOURCES[1] if ("_ti" in name or "_te" in name) else SOURCES[0]
        fn = getattr(libs[(source, name[-3:])], name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def check(err, name):
        if err:
            raise RuntimeError(f"{name}: {err}")

    build.function = function
    build.check = check
    build.stream_ptr = lambda device: None
    build.dtype_tag = lambda kernel, tensors, shapes: {
        torch.float32: "f32", torch.float64: "f64"}[tensors[0].dtype]


# Each model's kernel-7 variants, the first its default fleet's.
VARIANTS = {"unicycle": ["m4", *chip_smoke.TERMINAL], "pendulum": ["m2", "m2_track"],
            "hcw": ["m6_te6"]}


def problem(model, variant, dtype):
    device = torch.device("cpu")
    if model != "unicycle":
        return chip_smoke.zoo_problem(tt, dtype, device, model, tracking="_track" in variant,
                                      terminal="_te" in variant)
    if variant == "m4":
        return chip_smoke.ip_problem(tt, dtype, device)
    return chip_smoke.terminal_problem(tt, dtype, device, variant)


def x0_batch(model, batch, dtype):
    if model == "unicycle":
        rng = np.random.default_rng(0)
        return torch.as_tensor(rng.uniform(-0.5, 0.5, (batch, 3)), dtype=dtype)
    return chip_smoke.fleet_x0(problem(model, VARIANTS[model][0], dtype), batch,
                               torch.Generator().manual_seed(0))


def pair(model, variant, dtype, batch, iterations, x0=None, warm=False):
    """(kernel Solution, its work rows, plain Solution) from cold seeds, or
    with ``warm`` from the warm seeds of a tick."""
    opts = tt.CDDPOptions(max_iterations=iterations, tolerance=1e-4)
    x0 = x0_batch(model, batch, dtype) if x0 is None else x0
    prob, seeds_fn = problem(model, variant, dtype), None
    if warm:
        x0, _, U1, state = chip_smoke.tick(tt, "IPDDP", prob, opts, x0)
        seeds_fn = chip_smoke.ip_warm_seeds(state, U1)
        opts = opts.replace(warm_start=True)
    p, seeds, term = chip_smoke.seeded(prob, opts, x0, seeds_fn)
    kern, work = mega_ipddp.launch_counting_work(p, opts, *seeds, terminal=term)
    plain = ipddp._drive(p, chip_smoke.plain_ip_options(tt, opts), *seeds, terminal=term)
    return kern, work, plain


def compare(model, variant, dtype, batch, iterations, warm=False):
    kern, _, plain = pair(model, variant, dtype, batch, iterations, warm=warm)
    same = ((kern.status_code == plain.status_code)
            & (kern.iterations_completed == plain.iterations_completed))
    fields = {"X": (kern.state_trajectory, plain.state_trajectory),
              "U": (kern.control_trajectory, plain.control_trajectory),
              "cost": (kern.final_objective, plain.final_objective),
              "Lambda": (kern.costate_trajectory, plain.costate_trajectory)}
    for group in ("terminal_duals", "terminal_slacks"):
        for name, t in (getattr(plain, group) or {}).items():
            fields[f"{group}[{name}]"] = (getattr(kern, group)[name], t)
    errs = ", ".join(f"{k} {float((a - b)[same].abs().max()):.3e}" for k, (a, b) in fields.items())
    print(f"[host] {variant} {dtype}{' warm' if warm else ''}: status and iterations equal on "
          f"{float(same.double().mean()):.4%} of {batch}; max abs err {errs}")


def shares(model, variant, batch, iterations):
    dtype = torch.float32
    x0 = x0_batch(model, batch, dtype)
    x1 = torch.nextafter(x0, torch.full_like(x0, math.inf))
    for its in (5, iterations):
        kern, _, plain = pair(model, variant, dtype, batch, its, x0)
        _, _, moved = pair(model, variant, dtype, batch, its, x1)
        print(f"[host] {variant} float32, {its} iterations: the kernel agrees with the plain "
              f"driver on {chip_smoke.cost_share(kern, plain):.4%}, the plain driver from x0 "
              f"one ulp up on {chip_smoke.cost_share(moved, plain):.4%} of {batch}")


def work(model, variant, dtype, batch, iterations):
    _, rows, _ = pair(model, variant, dtype, batch, iterations)
    sweeps = rows[1].double()
    q = torch.quantile(sweeps, torch.tensor([0.5, 0.8, 0.9, 0.99], dtype=torch.float64))
    print(f"[host] {variant} {dtype}: sweeps per instance mean {float(sweeps.mean()):.3f}, "
          f"median / 80th / 90th / 99th percentile {' / '.join(f'{v:.0f}' for v in q.tolist())}, "
          f"max {float(sweeps.max()):.0f}")


def svd_floor(model, dtype, batch, iterations):
    seen, svdvals = [], torch.linalg.svdvals

    def recording(A):
        sv = svdvals(A)
        seen.append(sv)
        return sv

    variant = next(v for v in VARIANTS[model] if "_te" in v)
    torch.linalg.svdvals = recording
    try:
        pair(model, variant, dtype, batch, iterations)
    finally:
        torch.linalg.svdvals = svdvals
    sv = torch.stack(seen)
    positive = (1e-8 * sv.amax(-1) - sv.amin(-1) > 0).double().mean()
    print(f"[host] {variant} {dtype}: the SVD floor is positive on {float(positive):.4%} of "
          f"{sv.shape[0] * sv.shape[1]} backward calls; smallest singular-value ratio "
          f"{float((sv.amin(-1) / sv.amax(-1)).min()):.3e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="unicycle", choices=sorted(VARIANTS))
    ap.add_argument("--variants", nargs="*", help="default: every variant of the model")
    ap.add_argument("--dtype", default="f64", choices=("f32", "f64"))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--shares", action="store_true")
    ap.add_argument("--work", action="store_true")
    ap.add_argument("--svd", action="store_true")
    ap.add_argument("--warm", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    use_host(build_host())
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    for variant in args.variants or VARIANTS[args.model]:
        if args.shares:
            shares(args.model, variant, args.batch, args.iterations)
        elif args.work:
            work(args.model, variant, dtype, args.batch, args.iterations)
        else:
            compare(args.model, variant, dtype, args.batch, args.iterations, args.warm)
    if args.svd:
        svd_floor(args.model, dtype, args.batch, args.iterations)


if __name__ == "__main__":
    main()
