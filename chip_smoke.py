#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (``cddp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a nonzero exit:

1. start: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device -> exit nonzero with no result (no CPU fallback);
2. build: compile the nine CUDA kernels from ``cddp_tpu_torch/ops/csrc``
   (float32 and float64; goal, tracking and terminal variants;
   ``build.build_all``), then start the MPCC lane library's compile
   beside phases 3 and 16-19 (joined before phase 20), printing
   each object's compile seconds, ptxas registers and spills, and for
   every launcher what the card reports of its kernel (registers, spill
   bytes, shared memory, resident blocks per SM; ``print_kernel_attributes``);
3. the CLDDP kernels against their plain PyTorch versions on the card, at
   the flagship problem's shapes (N=20, nx=3, nu=2) with B=4096: the
   Riccati and rollout kernels in float64 (atol 1e-9) and float32 (as
   accurate as the plain version against float64, per time step; see
   ``check``), the whole-solve kernel against the plain driver (float64:
   every status and iteration count equal, X, U and cost within 1e-8;
   float32: status, iterations and cost within rel 1e-4 equal on >= 99% of
   instances); in float64 also the branches the flagship does not reach: an
   indefinite Riccati case, the regularization limit (status 3), the early
   exit (1) and the acceptable exit (2), held exactly, and a 30-iteration
   run into last-bit ties, held as an envelope (see ``phase_branches``);
4. the flagship CLDDP fleet (the workload of ``bench.py``: cold
   control-limited unicycle MPC, H=20, 10 iterations, float32, B=262144)
   through ``batched_solve``: the launch counts prove the whole-solve kernel
   ran it (and the Riccati and rollout kernels the per-pass engine); costs
   must be finite and fall; solves/s of the whole-solve kernel, the
   per-pass kernels and the plain driver; each kernel's time, its plain
   version's and its bound;
5. the IPDDP kernels against their plain versions at B=4096 on the box
   fleet's shapes (m=4 box rows), with inputs staged by the plain driver
   (``stage_ip_inputs``): the open-loop rollout, condensed backward and
   forward trial kernels in float64 (atol 1e-9, flags equal) and float32
   (the float64-truth rule of ``check``); the condensed backward also at
   m=6 and m=10, and at each m on the driver's broadcast operands, on
   materialised batch-first copies, on batch-last views and on a ragged
   batch, which must give the same bits (``check_backward_layouts``); the
   whole-solve kernel against the
   plain per-pass driver on the same cold seeds (float64: every status and
   iteration count equal, X, U, duals, slacks, cost and mu within 1e-8, on
   the box fleet and the cases of ``phase_ip_branches``; float32: status,
   iterations and cost within rel 1e-4 on >= 99% over five iterations, and
   at ten no further from the plain driver than it is from itself under a
   one-ulp change of x0, see ``check_ip_f32``);
6. the IPDDP box fleet (``bench_ipddp_fleet.py``'s box problem: the
   flagship under IPDDP, 10 iterations, tolerance 1e-4, float32, B=262144)
   through ``batched_solve`` on each engine: the launch counts (whole solve:
   one open-loop rollout and one whole-solve launch; per-pass: the rollout,
   backward and forward kernels; plain: none), finite costs and residuals,
   status agreement with the plain driver on >= 99%, solves/s; each
   kernel's time, its plain version's and its bound;
7. the IPDDP obstacle fleet's kernels (``bench_ipddp_fleet.py:38-55``: a
   control box and a keep-out ball, m = 5) at B=4096: kernel 7's ball
   variants (the ball's row first or last) against the plain driver in
   float64 (every status and iteration count equal, X, U, duals, slacks,
   cost and mu within 1e-8, the stall latch's final state equal) on cases
   that reach each branch of the latch, each asserting the plain driver's
   events it is there for (the latch armed by the stall detector and at the
   regularization limit, the SOC replacing slacks, a nonzero
   constraint-Hessian fold, the SOC dropped), and at ball scale 2.5, where
   kernel and driver round the ball's g apart; float32 by ``check_ip_f32``;
   kernel 6 at m = 5 on per-step Jacobians and folded lxx against its plain
   version (float64: within 1e-9 of the plain version run with the kernel's
   rounding of its 2x2 inverse, and within 1e-9 plus twice what that one
   rounding moves the plain version by, see ``check_backward_obstacle``;
   float32 by the 2x rule of ``check``);
8. the obstacle fleet (float32, B=262144, 10 iterations, tolerance 1e-4)
   through ``batched_solve`` on each engine: the launch counts (whole solve:
   one open-loop rollout and one whole-solve launch; per-pass: the rollout
   and the backward kernel, and no forward-trial kernel, which takes box
   stacks only; plain: none), finite costs and residuals, status agreement
   with the plain driver on >= 99%, solves/s; kernels 7 and 6's times on
   it, their plain versions' and their bounds;
9. the whole-solve kernels of LogDDP (9) and MSIPDDP (8) against their plain
   drivers on the box fleet's cold seeds at B=4096, float64: every status and
   iteration count equal, X, U, k, K and cost within 1e-8, for MSIPDDP also
   Y, S, F, Lambda and mu, on the box fleet and the cases of
   ``phase_barrier_branches``, each of which asserts the branch it is there
   for; MSIPDDP over its first MS_EXACT_ITERS iterations, and at ten within 3
   points of the plain driver's agreement with itself from x0 one ulp up
   (its filter forks at roundoff ties, see MS_EXACT_ITERS); float32: see
   ``check_barrier_f32``;
10. the LogDDP and MSIPDDP box fleets (``bench_logddp_fleet.py``'s and
   ``bench_msipddp_fleet.py``'s problem: the IPDDP box fleet's, segment
   length 5) through ``batched_solve`` on each engine: the launch counts
   (whole solve: one open-loop rollout and one whole-solve launch;
   ``solve_engine="xla"``: the rollout only; plain: none), finite costs and
   residuals, status agreement with the plain driver on >= 99%, solves/s;
   each kernel's time, its plain driver's and its bound;
11. tracking MPC (per-step reference trajectories): on the tracking
   unicycle of tests/test_ip_rollout.py:537-559 at N=20 (the arc (sin t,
   1 - cos t, t), t in [0, 1], Q = 0.5 I, R = 0.1 I, Qf = 50 I, a control
   box of +-2; ``tracking_problem``), the tracking variant of kernels 2, 3,
   5, 7 (m = 4, and m5_ball0 with the obstacle fleet's ball), 8 and 9 against
   its plain version at B=4096 by the rules of phases 3, 5 and 9 (float64
   exact, float32 by each solver's agreement rule; CLDDP's at ten
   iterations is IPDDP's, the plain driver's agreement with itself one ulp
   up less 3 points, since this fleet converges); then the tracking MPC
   fleet: ``make_mpc_controller(prob, "CLDDP")`` at B=262144, float32, 10
   iterations, five ticks with the reference sliding one step a tick and
   the plant stepping with the model's discrete dynamics, each tick one
   launch of kernel 3's tracking variant, with ms per tick, solves/s and
   the fleet's mean distance to the reference; the tracking fleets that
   drive kernels 2, 5 (per-pass), 7, 8 and 9 (whole solve) once each, the
   IPDDP one timed; each variant's times and bound at B=262144;
12. terminal constraints: kernel 7's four terminal variants (``TERMINAL``:
   one or two linear terminal inequality rows, the terminal equality x_N =
   target, and both, on the IPDDP box fleet; ``terminal_problem``) against
   the plain driver at B=4096 from cold seeds (float64: every status and
   iteration count equal, X, U, cost and mu, duals, slacks and the terminal
   duals, multipliers and slacks within 1e-8 for the inequality variants
   and 1e-7 for the equality ones, whose Gramian form rounds apart from the
   driver's p+1 sweeps; float32 by ``check_ip_f32``, the equality variants
   held from five iterations on to the plain driver's own agreement one
   ulp up, since they fork from the first iterations); the per-pass engine
   on the terminal-inequality and terminal-equality fleets against the
   plain driver (float64, 1e-8; kernels 4, 5 and 6, and for the equality
   kernels 4 and 5 beside its plain reduced LQR); then the four terminal
   fleets at B=262144 through ``batched_solve``, each one launch of its
   variant, with the terminal violation, ms per fleet and solves/s of the
   two fleets of the slice, and each variant's times, bound, work and
   attributes;
13. warm starts: kernels 7, 8 and 9 from warm seeds (a cold solve of the
   fleet, then a tick: x0 advanced one step, the plans shifted) against
   their plain drivers at B=4096 (``phase_warm_kernels``: float64 exactly,
   kernel 7 on m4, m4_track, m5_ball0, m4_ti2 and m4_te3 and on warm
   branches that each assert they were reached (stale steps re-initialised,
   the interior repair, an x0-drift reset splitting the batch, nonzero
   gains at the regularization limit, the three trajectory-warm mu tiers),
   kernel 8 on the box and tracking fleets over MS_EXACT_ITERS iterations,
   kernel 9 with warm gains; float32 by ``check_ip_f32`` and
   ``check_barrier_f32``); the warm MPC fleet (``phase_warm_mpc``:
   ``make_mpc_controller(..., warm_start_solver_state=True)`` and False
   under IPDDP and MSIPDDP on phase 11's tracking problem at B=262144 for
   five ticks, one whole-solve launch a tick, ms and mean iterations a
   tick); the certified fleet (``phase_certified_fleet``: the float32 IPDDP
   box fleet at 20 iterations, then ``tt.polish`` in float64 on the card,
   one float64 launch of kernel 7); the warm kernels' device times;
14. the pendulum, the cart-pole and HCW (``phase_zoo``, ``zoo_problem``:
   the pendulum and cart-pole goldens' problems at N = 100 and 200, the
   JAX rendezvous bench's HCW at N = 20 with x_N = 0): (a) every new
   instantiation of kernels 1-9 against its plain version at B_CHECK, in
   float64 (statuses and iterations equal; kernels 1, 2, 4, 5, 6 within
   1e-9 + 1e-12 |v| plus twice the plain version's own move from inputs
   one ulp up, whole solves within 1e-8, on the cart-pole's N = 200 plus
   MOVE_FACTOR times the plain driver's move from x0 one ulp up, the
   rendezvous ``m6_te6`` within 1e-7) and float32 (the rules of phases 3,
   5 and 9; the cart-pole's chaotic swing-up by ``check``'s quantiles and
   ``check_clddp_f32_accuracy``); the tracking forms over ZOO_TRACK_ITERS
   iterations; (b) the pendulum fleet under the four solvers with the
   goldens' options, (c) the cart-pole fleet under CLDDP, (d) the
   rendezvous fleet on both IPDDP engines and as five warm and five cold
   MPC ticks, each at B_MAIN in float32 with its launch counts, converged
   share, iterations, ms and the whole-solve launch's work and warp
   divergence; short runs that drive every other new instantiation; then
   every new entry's times and bound at B_MAIN (the whole solves' plain
   drivers timed at B_CHECK in (a), not at B_MAIN);
15. the discrete car, the forklift, the LTISystem and IPDDP without path
   constraints (``phase_discrete``): (a) every new instantiation (kernel 1
   at 4x2 on the car's and the LTISystem's operands, kernel 2 on the car's
   exact map, kernel 4 on the car and the forklift, kernels 5 and 6 at the
   car's m = 4) against its plain version at B_CHECK, float64 within 1e-9
   + 1e-12 |v| plus twice the plain version's one-ulp move and float32 by
   ``check``'s rule, and the car's per-pass CLDDP and IPDDP against their
   plain drivers in float64 (N = 60, every status and iteration equal);
   (b) the car-parking fleet (tests/make_goldens.py:110-124, N = 300) at
   CAR_B under CLDDP and IPDDP per pass, and at B_CHECK under MSIPDDP and
   LogDDP on their plain drivers seeded by kernel 4; the forklift's
   rollout; (c) the LTISystem 4x2 box fleet at B_MAIN (kernel 1); (d) the
   unconstrained pendulum and the scalar terminal equality at B_CHECK
   (no kernel but 4's seed), each run with its exact launch counts,
   converged share, iterations, ms and distance of x_N to its target; then
   every entry's times and bound on its run's operands;
16. the quadrotor and QuadrotorRate (``phase_quadrotor``): (a) every new
   instantiation (kernel 1 at 13x4 and 10x4, kernels 2 and 4 on both
   models, kernel 5 at m = 8 on both and in the quadrotor's tracking form,
   kernel 6 at 13x4x8 and 10x4x8) against its plain version at B_CHECK,
   float64 within 1e-9 + 1e-12 |v| plus twice the plain version's one-ulp
   move and float32 by ``check``'s rule, and both models' per-pass CLDDP
   and IPDDP against their plain drivers in float64 (every status and
   iteration equal); (b) the ``quadrotor_ipddp`` golden per pass against
   the plain driver on the card and against the golden file; (c)
   ``bench_quadrotor.py``'s single solve (N = 100, float32, B = 1): status,
   iterations, ms a solve and, with the timings, its split per iteration;
   (d) the quadrotor fleet (N = 60, B = 65,536) per pass under IPDDP and
   CLDDP and on the plain MSIPDDP and LogDDP drivers at B_CHECK; (e) the
   QuadrotorRate fleet (N = 50) per pass; the figure-8 anchor
   (tests/test_parity_anchors.py:72-120) held to its bounds; each run with
   its launch counts, converged share, iterations, ms and peak memory;
17. the attitude trio, EulerAttitude, QuaternionAttitude and MrpAttitude
   (``phase_attitude``, ``attitude_problem``: the MRP slew of
   examples/spacecraft_examples.py:59-82, nu = 3 torques in a box of +-2):
   (a) every new instantiation against its plain version: kernels 1, 2
   and 4 at the slew's N = 200 on ATT_KERNEL_B instances, 5 and 6 at
   B_CHECK (float64 within 1e-9 + 1e-12 |v| plus twice the plain
   version's one-ulp move, float32 by ``check``'s rule, kernel 1's tail by
   its BoxQP ties), the whole solves 3, 7 and 9 (where their tables take
   the model, ``whole_takes``) at
   N = 20 and at the longest horizon each takes (the JAX gates', past
   which they run per pass) over ATT_WHOLE_ITERS (float64 every status
   and iteration equal, values within 1e-8; float32 99% of the plain
   driver's stable instances, those on which it agrees with its own run
   from x0 one ulp up) and the per-pass CLDDP and IPDDP at N = 200
   (float64) against their plain drivers, which a second process runs
   beside the kernels' build; (b) the slew fleets (B = 65,536, N = 200,
   per pass; MSIPDDP and LogDDP on their plain drivers at B_CHECK), (c)
   the attitude-MPC fleets (B = 262,144, N = 20: one launch
   of kernel 3, 7 or 9 each, or per pass where its table leaves the
   whole solve out), (d) the example's single slew (per pass at B = 1,
   held to its float64 run), each with its exact launch counts;
   (e) every entry's times and bound;
18. the other spacecraft models (``phase_spacecraft``, ``SC_SPECS``), as
   phase 17 runs the trio: (a) kernels 1, 2, 4, 5 and 6 at N = 100 and the
   whole solves their tables take at N = 20 and at the JAX gates'
   horizons; (b) the MPC fleets (N = 20, B = 262,144), (c) the N = 100
   fleets (B = 65,536), per pass; (d) every entry's times and bound;
19. the small models, Bicycle, DubinsCar, DreyfusRocket and Acrobot
   (``phase_small``, ``SMALL_SPECS``): (a) kernels 1, 2, 4, 5 and 6 at N =
   100 against their plain versions, and the whole solves 3, 7, 8 and 9
   at N = 20 and at the JAX gates' horizons (kernel 8 over
   MS_EXACT_ITERS) against their plain drivers, which run in a side
   process; (b) the MPC fleets under the four solvers (N = 20, B =
   262,144, float32), (c) the N = 100 fleets (B = 65,536) under CLDDP and
   IPDDP by the gates' routes, and through the per-pass engine where the
   route is whole; (d) every entry's times and bound.
20. the MPCC racing fleet (``phase_mpcc``, examples/mpcc_lib_torch.py,
   BASELINE config 5; the lane library of examples/mpcc_lanes.cuh, built
   beside phases 3 and 16-19's checks): (a) kernel 4 on the latch bicycle, kernels 6
   (7x3x6) and 5 (the MPCC cost lane) on staged operands, kernel 7's
   Gauss-Newton build against the plain driver (whose runs, and the plain
   engine's tick, come from the plain references' process); (b) the cold
   tick (M = 64, N = 20, 15 iterations, float32) at B = 1,024 on the three
   engines and at 65,536 on two, and the warm fleet at both, their launch
   counts proving each route; (c) the golden tick in float64; (d) every
   entry's times and bound.

Phases 14-20 run right after phase 3, their checks and fleets first and
phases 14 and 15's timings after them, then phases 4-13, then phases 16
to 19's timings: the plain drivers launch tens of thousands of small
torch operations, each of which takes 1.6-1.7x as long once the profiler
has run in the process, and after phase 16's timing sessions beside
phases 14-15's the profiler recorded no kernel-6 launch in any later
session (both measured on an H100 machine; PERF.md). Phases 16 to 20's
plain references (``Side``) run in two processes of their own, started
before the build: they run plain drivers only.

Phases 4-13 time each whole solve's plain driver, and run their fleets'
plain-driver engine, on the first B_CHECK instances of the main path's
seeds (``plain_at``, ``check_slice``, ``fleet_batch``): at B_MAIN those
runs took 3.2-14.4 s each, several a fleet, and left no room for phase 15.

Each kernel is timed twice at the main path's shapes: by CUDA events
around its wrapper (``cuda_ms``: the batch-first <-> batch-last copies
included) and by the profiler's device time of the kernel alone
(``device_ms``). A bound is the larger of the compulsory bytes (each input
read once, each output written once, ``unique_bytes``; kernel 6's inputs
as ``backward_operands_read`` gives them) over 3.35 TB/s and the operations
(``count_ops`` on the plain version, per instance; for a whole solve, from
the kernel's own count of backward attempts and trajectory sweeps) over 67
TFLOP/s, the H100 SXM's float32 rate outside the tensor cores.

The line before the last is the kernels' JSON record (kernel 7's entry
carries the obstacle run under "obstacle", kernel 6's under "obstacle_m5",
kernel 5's its 0 launches there; each tracking variant is an entry of its
own, named with the suffix "_track", and each terminal variant one named
as dispatch_log names it, "ipddp_solve_ti2" for instance; kernels 7, 8 and
9 carry phase 13's warm seeds under "warm"; phase 14's, 15's and 16's
instantiations are entries named with their model, ``clddp_solve@pendulum``,
``forward_rollout@car`` or ``ip_forward_track@quadrotor`` for instance;
every entry's "plain_at" says where its plain time was taken); the last
line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
import typing
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

B_CHECK = 4096
B_MAIN = 262144
# The per-pass fleets of phases 14-18 run on the first 1 / PER_PASS_SHARE of
# their fleet: they prove the route by their launch counts and print their
# rate, and their time scales with the batch (HCW's rendezvous fleet per
# pass: 7535.15 ms at B = 262,144, 1756.09 ms at 65,536 on an NVIDIA H100
# 80GB HBM3, 700.00 W). The timings still run at the fleet's batch.
PER_PASS_SHARE = 4
HORIZON = 20
DT = 0.05
SEED = 0
# CUDA-event timing of one kernel: at most this, after one call (at least
# three calls). At 1000 ms the script's 64 kernel timings took about 130 s
# of its run on an NVIDIA H100 80GB HBM3 at 700 W.
TIMING_BUDGET_MS = 200.0
HCW_X0_SCALE = (0.5, 0.5, 0.5, 0.005, 0.005, 0.005)  # the rendezvous fleet's x0 spread


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def launchers():
    """Every launcher of the kernel library, by kernel, without its type
    suffix, for every model each kernel is instantiated for (the tables of
    the kernels' wrappers); the unicycle's main-path variant (m = 4 box
    rows, the goal form) first, the tracking variants (suffix ``_track``)
    after the goal forms."""
    from cddp_tpu_torch.ops.kernels.ip_rollout import KERNEL_ROWS, TRACK_ROWS
    from cddp_tpu_torch.ops.kernels.ipddp_riccati import KERNEL_SHAPES
    from cddp_tpu_torch.ops.kernels.mega_ipddp import (BALL_LAYOUTS, IP_BOX_ROWS, LOG_BOX_ROWS,
                                                       MS_BOX_ROWS, TERMINAL_LAYOUTS,
                                                       TRACK_LAYOUTS)
    from cddp_tpu_torch.ops.kernels.riccati import KERNEL_SHAPES as RICCATI_SHAPES
    from cddp_tpu_torch.ops.kernels.rollout import (_REGISTRY, ATTITUDE_MODELS, CLDDP_MODELS,
                                                    CLDDP_TRACK_MODELS, ROLLOUT_MODELS,
                                                    SMALL_MODELS, SPACECRAFT_MODELS)

    balls = [f"m{m}_ball{row}" for m, row in BALL_LAYOUTS["unicycle"]]
    track = lambda stems: stems + [f"{s}_track" for s in stems]  # noqa: E731
    by_model = lambda stem, table: [  # noqa: E731
        f"{stem}_{model}_m{m}" for model, rows in table.items() for m in rows]
    # The attitude trio's kernels 6 and 7, the other spacecraft models'
    # kernels 3, 6, 7 and 9 and the small models' kernels 3, 6, 7, 8 and 9
    # live in translation units of their own.
    own = lambda table, models: {m: r for m, r in table.items() if m in models}  # noqa: E731
    rest = lambda table: {m: r for m, r in table.items()  # noqa: E731
                          if m not in ATTITUDE_MODELS + SPACECRAFT_MODELS + SMALL_MODELS}
    attitude_shapes, spacecraft_shapes = ((6, 3), (7, 3)), ((8, 3), (10, 3), (6, 2))
    small_shapes = ((3, 1, 2), (4, 1, 2))
    backward = lambda shapes: [f"cddp_ipddp_backward_{nx}x{nu}x{m}"  # noqa: E731
                               for nx, nu, m in KERNEL_SHAPES if (nx, nu) in shapes]
    return {
        "riccati_backward": [f"cddp_riccati_backward_{nx}x{nu}" for nx, nu in RICCATI_SHAPES],
        "forward_rollout": [f"cddp_forward_rollout_{m}" for m in ROLLOUT_MODELS]
        + [f"cddp_forward_rollout_{m}_track" for m in CLDDP_TRACK_MODELS],
        "clddp_solve": [f"cddp_clddp_solve_{m}" for m in CLDDP_MODELS
                        if m not in SPACECRAFT_MODELS + SMALL_MODELS]
        + [f"cddp_clddp_solve_{m}_track" for m in CLDDP_TRACK_MODELS],
        "clddp_solve_spacecraft": [f"cddp_clddp_solve_{m}" for m in SPACECRAFT_MODELS
                                   if m in CLDDP_MODELS],
        "clddp_solve_small": [f"cddp_clddp_solve_{m}" for m in SMALL_MODELS if m in CLDDP_MODELS],
        "open_loop_rollout": [f"cddp_open_loop_rollout_{e.cuda_name}" for e in _REGISTRY.values()],
        "ip_forward": by_model("cddp_ip_forward", KERNEL_ROWS)
        + [f"{s}_track" for s in by_model("cddp_ip_forward", TRACK_ROWS)],
        "ipddp_backward": [f"cddp_ipddp_backward_{nx}x{nu}x{m}" for nx, nu, m in KERNEL_SHAPES
                           if (nx, nu) not in attitude_shapes + spacecraft_shapes
                           and (nx, nu, m) not in small_shapes],
        "ipddp_backward_attitude": backward(attitude_shapes),
        "ipddp_backward_spacecraft": backward(spacecraft_shapes),
        "ipddp_backward_small": [f"cddp_ipddp_backward_{nx}x{nu}x{m}"
                                 for nx, nu, m in small_shapes],
        "ipddp_solve": by_model("cddp_ipddp_solve", rest(IP_BOX_ROWS))
        + [f"cddp_ipddp_solve_unicycle_{v}" for v in balls]
        + [f"cddp_ipddp_solve_{model}_{v}_track" for model, layouts in TRACK_LAYOUTS.items()
           for v in layouts],
        "ipddp_solve_terminal": [
            f"cddp_ipddp_solve_{model}_{layout}" + (f"_te{p}" if p else "")
            + (f"_ti{mT}" if mT else "")
            for model, layouts in TERMINAL_LAYOUTS.items()
            for layout, shapes in layouts.items() for mT, p in shapes],
        "ipddp_solve_attitude": [f"cddp_ipddp_solve_{m}_m6" for m in ATTITUDE_MODELS
                                 if m in IP_BOX_ROWS],
        "ipddp_solve_spacecraft": by_model("cddp_ipddp_solve", own(IP_BOX_ROWS, SPACECRAFT_MODELS)),
        "ipddp_solve_small": by_model("cddp_ipddp_solve", own(IP_BOX_ROWS, SMALL_MODELS)),
        "msipddp_solve": track(by_model("cddp_msipddp_solve", rest(MS_BOX_ROWS))),
        "msipddp_solve_small": by_model("cddp_msipddp_solve", own(MS_BOX_ROWS, SMALL_MODELS)),
        "logddp_solve": track(by_model("cddp_logddp_solve", rest(LOG_BOX_ROWS)))
        + by_model("cddp_logddp_solve", own(LOG_BOX_ROWS, ATTITUDE_MODELS)),
        "logddp_solve_spacecraft": by_model("cddp_logddp_solve",
                                            own(LOG_BOX_ROWS, SPACECRAFT_MODELS)),
        "logddp_solve_small": by_model("cddp_logddp_solve", own(LOG_BOX_ROWS, SMALL_MODELS)),
    }


def print_ptxas(library):
    """Print each object's compile seconds and ptxas registers and spills
    from ``library``'s build log, where it was built in this run."""
    log = library.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if ("registers" in line or "spill" in line or "entry function" in line
                    or line.startswith("==")):
                print(f"[ptxas] {line.strip()}")


def print_kernel_attributes(smi):
    """Print what the card reports of every launcher's kernel in float32
    and float64 (registers, spill bytes, shared memory, resident blocks per
    SM); returns {kernel: attributes of its main-path float32 variant}."""
    from cddp_tpu_torch.ops.kernels import build

    main_path = {}
    for kernel, stems in launchers().items():
        for stem in stems:
            for tag in ("f32", "f64"):
                a = build.kernel_attributes(f"{stem}_{tag}")
                print(f"[attributes] {stem}_{tag}: {a['registers']} registers, "
                      f"{a['spill_bytes']} local (spill) bytes, shared "
                      f"{a['static_smem_bytes']} static + {a['dynamic_smem_bytes']} dynamic "
                      f"bytes, {a['threads']} threads, {a['blocks_per_sm']} blocks per SM  "
                      f"[{smi}]")
                main_path.setdefault(kernel, a)
    return main_path


def warp_divergence(work):
    """Mean over warps (consecutive groups of 32 instances) of the slowest
    lane's work over the warp's mean lane work; work is the sum of a
    whole-solve kernel's work rows (backward attempts and sweeps) per
    instance. A warp runs as long as its slowest lane, so this is the
    factor per-thread control flow costs over lanes that each did the
    warp's mean work."""
    w = sum(r.double() for r in work)
    w = w[: w.numel() // 32 * 32].reshape(-1, 32)
    return float((w.amax(1) / w.mean(1)).mean())


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


def fleet_x0(prob, B, gen):
    """B initial states of the problem's fleet from ``gen``: the unicycle's
    U(-0.5, 0.5); the pendulum's (pi, 0) + U(-0.1, 0.1); the cart-pole's
    U(-0.05, 0.05); the car's (1, 1, 1.5 pi, 0) + U(-0.1, 0.1); the
    LTISystem's x0 + U(-0.5, 0.5); HCW's x0 + U(-1, 1) scaled by
    ``HCW_X0_SCALE`` (bench_ipddp_fleet.py:124-132); the quadrotors' x0
    (hover) + U(-0.5, 0.5)^3 on the position alone; the attitude trio's at
    rest, at an MRP from U(-0.3, 0.3)^3 in the model's coordinates
    (``attitude_state``); the other spacecraft models' and the small
    models' x0 + widths (U(0, 1) - 0.5) (``SC_SPECS``, ``SMALL_SPECS``)."""
    dev, dtype, nx = prob.x0.device, prob.x0.dtype, prob.state_dim
    u = torch.rand(B, nx, generator=gen, device=dev, dtype=dtype)
    name = type(prob.model).__name__
    if name == "Unicycle":
        return u - 0.5
    if name == "Pendulum":
        return prob.x0 + 0.1 * (2.0 * u - 1.0)
    if name == "CartPole":
        return 0.05 * (2.0 * u - 1.0)
    if name == "Car":
        return prob.x0 + 0.1 * (2.0 * u - 1.0)
    if name == "LTISystem":
        return prob.x0 + 0.5 * (2.0 * u - 1.0)
    if name in ("Quadrotor", "QuadrotorRate"):
        return prob.x0 + torch.cat([u[:, :3] - 0.5, torch.zeros_like(u[:, 3:])], -1)
    if name in ATT_CLASSES:
        return attitude_state(ATT_CLASSES[name], ATT_X0_WIDTH * (2.0 * u[:, :3] - 1.0))
    if name in SC_CLASSES or name in SMALL_CLASSES:
        widths = (SC_SPECS[SC_CLASSES[name]][2] if name in SC_CLASSES
                  else SMALL_SPECS[SMALL_CLASSES[name]].widths)
        return prob.x0 + torch.tensor(widths, device=dev, dtype=dtype) * (u - 0.5)
    return prob.x0 + torch.tensor(HCW_X0_SCALE, device=dev, dtype=dtype) * (2.0 * u - 1.0)


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of fn() on the card, by CUDA events after a warm-up
    (unless ``warm`` is False)."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, kernel, reps, events_ok=False):
    """(ms, source): mean device milliseconds of one launch of the CUDA
    kernel ``kernel`` (its ``__global__`` function is
    ``cddp::<kernel>_kernel``) over ``reps`` calls of fn, which ``cuda_ms``
    has just warmed, and where they come from. "profiler": the profiler's
    kernel rows, without the wrapper's layout copies, over the launches it
    recorded (it can miss one of a short kernel's). If three sessions (one
    with ``events_ok="wrapper"``) record none: with ``events_ok`` (a wrapper that copies nothing, so
    CUDA events around it time the kernel) "cuda_events", the CUDA-event
    time; with ``events_ok="wrapper"`` (phase 14, late in a full run)
    "cuda_events_wrapper", the CUDA-event time of the wrapper, its layout
    copies included; else raises."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    sessions = 1 if events_ok == "wrapper" else 3
    for attempt in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and f"cddp::{kernel}_kernel<" in e.key]
        count = sum(e.count for e in rows)
        if count:
            return sum(e.self_device_time_total for e in rows) / count / 1e3, "profiler"
        # A session can come back without the kernel's records (kernel 6's
        # m = 5 variant, late in a full run, in two or all three sessions;
        # in phases 7-8 alone it is recorded); profile it again.
        print(f"[timing] the profiler saw no launch of {kernel} in {reps} calls "
              f"(session {attempt + 1} of {sessions})")
    if not events_ok:
        raise AssertionError(f"the profiler saw no launch of {kernel} in 3 sessions of "
                             f"{reps} calls")
    ms = cuda_ms(fn, reps, warm=False)
    if events_ok == "wrapper":
        print(f"[timing] {kernel}: no device time; CUDA events around its wrapper, its "
              f"layout copies included: {ms:.3f} ms")
        return ms, "cuda_events_wrapper"
    print(f"[timing] {kernel}: device time by CUDA events around its wrapper, which "
          f"copies nothing: {ms:.3f} ms")
    return ms, "cuda_events"


def stage_inputs(prob, B, gen, U=None):
    """Backward- and forward-pass inputs as the per-pass driver builds them,
    linearized about random nominal trajectories of the problem: x0 from
    ``fleet_x0``, the controls ``U`` (B, N, nu), uniform in three quarters
    of the box when None."""
    from cddp_tpu_torch.models import rollout

    dev, dtype = prob.x0.device, prob.x0.dtype
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=dtype)  # noqa: E731
    cc = prob.get_constraint("ControlConstraint")
    x0 = fleet_x0(prob, B, gen)
    if U is None:
        U = (2.0 * rand(B, prob.horizon, prob.control_dim) - 1.0) * cc.upper * 0.75
    X = rollout(prob.model, x0, U, prob.timestep)
    back = clddp_backward_inputs(prob, X, U, 10.0 ** (-6.0 + 4.0 * rand(B)))
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125], device=dev, dtype=dtype)
    alpha = alphas[torch.randint(0, 4, (B,), generator=gen, device=dev)]
    return X, U, back, alpha


def clddp_backward_inputs(prob, X, U, reg):
    """The Riccati backward's inputs about (X, U), as the per-pass CLDDP
    driver builds them."""
    from cddp_tpu_torch.solvers import base

    cc = prob.get_constraint("ControlConstraint")
    A, Bm = base.discrete_jacobians(prob, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(prob, X, U)
    Vx = prob.objective.terminal_cost_gradient(X[:, -1])
    Vxx = prob.objective.terminal_cost_hessian(X[:, -1])
    return (A, Bm, lx, lu, lxx, luu, lux, cc.lower - U, cc.upper - U, Vx, Vxx, reg)


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
        f: getattr(consts, f).double() for f in ("Q", "R", "Qf", "goal", "lower", "upper", "refs")
        if getattr(consts, f) is not None})


def abs_err(a, b):
    """|a - b| in float64, with NaN meeting NaN counted as 0."""
    a, b = a.double(), b.double()
    return torch.where(a.isnan() & b.isnan(), torch.zeros_like(b), (a - b).abs())


# A float32 enumerated BoxQP leaves the float64 active set where a step's
# solution lies within rounding of a bound, and which instances it does so
# on is a matter of rounding (the discontinuous K then moves every earlier
# step). On the quadrotor's N = 60 operands of phase 16 (a), on an NVIDIA
# H100, kernel 1 left float64 by more than TIE_ERR (scaled, ``check``) on 11
# of 1024 instances and its plain version on 4 others; on 1024 operands of
# the CPU the kernel's code built for the host did so on 3 (contracted) and 8
# (not) and the plain version on 7, each a different set, the float64 check
# exact on all. A kernel that misread its operands would leave it on most.
TIE_ERR = 1e-2
TIE_SHARE = 0.02


def check(name, got, want, truth=None, gate=True, rtol=0.0, moved=None, quantiles=False,
          ties=False):
    """Hold a kernel's outputs against its plain version's; returns the max
    abs error between them. Flags must be equal everywhere.

    float64 (no ``truth``): |got - want| <= 1e-9 + ``rtol`` |want| + 2 m,
    NaN meeting NaN, where m is 0 or, given ``moved`` (the plain version's
    outputs from every input one ulp up, ``ulp_up``), the largest |moved -
    want| of the output: how far rounding alone moves the plain version.
    (Phase 14 gives both: on the pendulum's and the cart-pole's long
    horizons the Riccati recursion's sums of |Vx| reach 1e5 and more, and
    on the cart-pole's N = 200 a one-ulp move of its inputs moves the gains
    by 1e-9 and more, above 1e-9 itself; the plain version's cuBLAS
    products, which fuse multiply-adds, round apart from the kernel's.)

    float32: ``truth`` is the plain version run in float64 on the same
    inputs. Both float32 results are measured against it, per instance and
    time step, e(x) = max |x - truth| / (|truth| + step_scale(truth)), and
    the kernel must be as accurate as its plain version within a factor 2:
    e(got) <= 2 e(want) + 1e-6. (The backward recursion amplifies float32
    rounding in k to ~5e-4 of the step scale in both, so a fixed rtol
    between the two cannot be met.) With ``gate`` False the float32 errors
    are printed and not held to that rule. With ``quantiles`` (a chaotic
    fleet's inputs, the cart-pole's N = 200, where a few instances' float32
    rollouts leave the float64 one in both versions and the largest error
    is one such instance's) the rule holds per instance, on the median and
    the 99th percentile of e over the batch instead of its largest value.
    With ``ties`` (the enumerated BoxQP at a fleet's horizon, phase 16) it
    holds the median, and in place of the 99th percentile the share of
    instances whose e exceeds TIE_ERR (a changed active set) is at most
    TIE_SHARE."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if not g.is_floating_point():
            if not bool((g == w).all()):
                raise AssertionError(f"{name}[{i}]: {int((g != w).sum())} flags differ")
            continue
        err = abs_err(g, w)
        worst = max(worst, float(err.max()))
        if truth is None:
            move = 0.0 if moved is None else float(abs_err(moved[i], w).max())
            tol = 1e-9 + rtol * w.double().abs().nan_to_num(0.0) + 2.0 * move
            if moved is not None:
                print(f"[kernels float64] {name}[{i}]: max abs err {float(err.max()):.3e}; the "
                      f"plain version from inputs one ulp up moves {move:.3e}")
            if not bool((err <= tol).all()):
                raise AssertionError(f"{name}[{i}]: {int((~(err <= tol)).sum())} "
                                     f"entries off, max abs err {float(err.max())}")
            continue
        t = truth[i].double()
        scale = t.abs() + step_scale(t)
        def per(x):  # e of each instance
            return (abs_err(x, t) / scale).nan_to_num(0.0).reshape(t.shape[0], -1).amax(-1)

        stats = ((("max", 1.0),) if not quantiles else (("median", 0.5),) if ties
                 else (("median", 0.5), ("99th percentile", 0.99)))
        if ties:
            share = [float((per(x) > TIE_ERR).double().mean()) for x in (g, w)]
            print(f"[kernels float32] {name}[{i}] share of instances off float64 by more than "
                  f"{TIE_ERR:g} (held to {TIE_SHARE:g}): kernel {share[0]:.4%}, plain "
                  f"{share[1]:.4%}; 99th percentile (not held): kernel "
                  f"{float(per(g).quantile(0.99)):.3e}, plain {float(per(w).quantile(0.99)):.3e}")
            if gate and not share[0] <= TIE_SHARE:
                raise AssertionError(f"{name}[{i}]: {share[0]:.4%} of instances off float64 by "
                                     f"more than {TIE_ERR:g}")
        if quantiles:
            print(f"[kernels float32] {name}[{i}] scaled error against float64 (max, not held):"
                  f" kernel {float(per(g).max()):.3e}, plain {float(per(w).max()):.3e}")
        for what, q in stats:
            e_got, e_want = (float(per(x).quantile(q)) if quantiles else float(per(x).max())
                             for x in (g, w))
            print(f"[kernels float32] {name}[{i}] scaled error against float64 ({what}): "
                  f"kernel {e_got:.3e}, plain {e_want:.3e}")
            if gate and not e_got <= 2.0 * e_want + 1e-6:
                raise AssertionError(f"{name}[{i}]: kernel error {e_got:.3e} ({what}) against "
                                     f"float64 exceeds 2x the plain version's {e_want:.3e}")
    return worst


# How far beyond the plain driver's own one-ulp move a float64 whole solve
# may stray where ``check_solve_f64`` is given that move (phase 14). The
# kernel rounds every product apart from the plain driver's cuBLAS ones,
# which fuse multiply-adds, a larger nudge than one ulp of x0: on the
# cart-pole's N = 200 over 10 iterations its X, U and cost differ by
# 4.7-5.3 times that move (PERF.md).
MOVE_FACTOR = 10.0


# Host milliseconds of the last plain-driver run of ``solve_pair``,
# ``ip_solve_pair`` or ``barrier_pair`` (ending in a synchronize), which
# phase 14 records as each whole solve's plain time at B_CHECK.
LAST_PLAIN_MS = [0.0]


def timed_plain(run):
    """run(), its host milliseconds (ending in a synchronize) recorded in
    LAST_PLAIN_MS."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    LAST_PLAIN_MS[0] = (time.perf_counter() - t0) * 1e3
    return out


WHOLE_SOLVES = ("clddp_solve", "ipddp_solve", "msipddp_solve", "logddp_solve")


def plain_at():
    """Where phases 4-13 time a whole solve's plain driver, as the kernels'
    JSON records it ("plain_at"): on the first B_CHECK instances of the
    main path's seeds, not at B_MAIN. At B_MAIN the plain drivers took
    3.2-14.4 s a run, several runs a fleet, and the port's time left no
    room for phase 15 (PERF.md); at B_CHECK they do the same launches on
    1/64 of the data."""
    return f"B={B_CHECK}, float32, 10 iterations"


def check_slice(p, seeds):
    """The problem and seeds of the first B_CHECK instances (``plain_at``)."""
    cut = lambda t: t[:B_CHECK] if isinstance(t, torch.Tensor) and t.dim() else t  # noqa: E731
    return p.replace(x0=p.x0[:B_CHECK]), tuple(cut(t) for t in seeds)


def plain_run_ms(rates):
    """Host ms of a fleet's one plain-driver run at B_CHECK, from the
    solves/s its phase reports."""
    return 1e3 * B_CHECK / rates["plain driver"]


def fleet_batch(name, x0):
    """x0 of an engine's run in phases 4-10: the plain driver's on the first
    B_CHECK instances (``plain_at``), the kernels' engines' on all."""
    return x0[:B_CHECK] if name == "plain driver" else x0


def ulp_up(ts):
    """Every floating-point tensor of ``ts`` one ulp up (others as they are)."""
    return tuple(torch.nextafter(t, torch.full_like(t, math.inf))
                 if isinstance(t, torch.Tensor) and t.is_floating_point() else t for t in ts)


def solve_pair(tt, p, opts):
    """The whole-solve kernel and the plain driver from cold seeds, as
    ``solve`` seeds them; returns (kernel Solution, plain Solution)."""
    from cddp_tpu_torch.ops.kernels import mega_clddp
    from cddp_tpu_torch.solvers import clddp

    seeds = clddp_solve_seeds(p.x0, p)
    return (mega_clddp._launch(p, opts, *seeds),
            timed_plain(lambda: clddp._solve(p, opts.replace(backward_engine="scan"), *seeds)))


def check_solve_f64(label, kern, plain, min_share=1.0, traj_tol=1e-8, moved=None):
    """float64: status and iteration count equal on at least ``min_share``
    of instances (all, unless a case allows ties), X and U within
    ``traj_tol`` where they are equal, and the cost within 1e-8 on every
    instance; given ``moved`` (the plain driver's solution from x0 one ulp
    up, or a function that returns it, called only when a field exceeds its
    tolerance without it), each within that plus ``MOVE_FACTOR`` times the
    largest move of the plain driver's field (on a long horizon a one-ulp
    change moves the cart-pole's plain X by 1e-8 and its U and cost by 1e-7
    over 10 iterations, so rounding alone exceeds 1e-8 there). Returns the
    status counts."""
    same = ((kern.status_code == plain.status_code)
            & (kern.iterations_completed == plain.iterations_completed))
    share = float(same.double().mean())
    if share < min_share:
        raise AssertionError(f"clddp_solve f64 {label}: status/iterations differ "
                             f"on {int((~same).sum())} instances")
    errs, bad = {}, []
    fields = lambda s: (s.state_trajectory, s.control_trajectory, s.final_objective)  # noqa: E731
    every = torch.ones_like(same)
    if callable(moved):
        over = any(float((g - w)[rows].abs().max()) > tol for g, w, tol, rows in zip(
            fields(kern), fields(plain), (traj_tol, traj_tol, 1e-8), (same, same, every)))
        moved = moved() if over else None
    for nm, g, w, m, tol, rows in zip(("X", "U", "cost"), fields(kern), fields(plain),
                                      fields(moved or plain), (traj_tol, traj_tol, 1e-8),
                                      (same, same, every)):
        errs[nm] = float((g - w)[rows].abs().max())
        if moved is not None:
            move = float((m - w)[rows].abs().max())
            print(f"[kernels float64] clddp_solve {label} {nm}: max abs err {errs[nm]:.3e}; the "
                  f"plain driver from x0 one ulp up moves {move:.3e}")
            tol = tol + MOVE_FACTOR * move
        if not errs[nm] <= tol:
            bad.append(f"clddp_solve f64 {label} {nm}: max abs err {errs[nm]} > {tol}")
    if bad:
        raise AssertionError("; ".join(bad))
    counts = torch.bincount(kern.status_code.long(), minlength=4).tolist()
    print(f"[kernels float64] clddp_solve {label}: status and iterations equal "
          f"on {int(same.sum())} of {same.numel()}; statuses {counts}; max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return counts


def check_solve_f32(label, kern, plain, min_share):
    """float32: status, iterations and cost (rel 1e-4) equal on >= ``min_share``
    of instances. A float32 line-search fork (the Armijo ratio of some
    iteration within rounding of its threshold) can leave status and
    iteration count equal but move the cost well past 1e-4; it counts
    against the allowance like a status fork. Returns the share."""
    same = ((kern.status_code == plain.status_code)
            & (kern.iterations_completed == plain.iterations_completed))
    rel = (kern.final_objective - plain.final_objective).abs() / plain.final_objective.abs()
    close = same & (rel <= 1e-4)
    share = float(close.double().mean())
    if share < min_share:
        raise AssertionError(f"clddp_solve f32 {label}: status, iterations and cost (rel "
                             f"1e-4) agree on {share:.4f} of instances (need >= {min_share:.4f})")
    print(f"[kernels float32] clddp_solve {label}: agree on {share:.4%}; "
          f"{int((same & ~close).sum())} instances with equal status and iterations forked "
          f"in cost (max rel {float(rel[same].max()):.3e}); median rel cost err "
          f"{float(rel.median()):.3e}")
    return share


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


def phase_kernels(tt, dev, make_problem=flagship_problem, label="flagship", opts=None,
                  rtol=0.0, moved=False, chaotic=False):
    """Each CLDDP kernel against its plain version on the card, on the
    problem ``make_problem`` builds (phase 3: the flagship, with the
    branches of ``phase_branches``; phase 11: the tracking problem; phase
    14: the pendulum's and the cart-pole's), the whole solve under ``opts``
    (10 iterations, tolerance 1e-4 unless given); ``rtol`` and ``moved``:
    ``check``'s float64 relative term and its one-ulp move of the plain
    version (and ``check_solve_f64``'s of the plain driver);
    ``chaotic``: a fleet whose float32 solves amplify rounding from the
    first iterations (the cart-pole's N = 200) has its float32 kernels held
    by ``check``'s quantiles and its whole solve by
    ``check_clddp_f32_accuracy``."""
    from cddp_tpu_torch.ops.kernels import riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        prob = make_problem(tt, dtype, dev)
        X, U, back, alpha = stage_inputs(prob, B_CHECK, gen)

        # float32 is held against the plain version in float64 on the same
        # (float32) inputs; float64 against the plain version directly.
        exact = dtype == torch.float64
        got = riccati._launch(*back)
        want = riccati.riccati_backward_plain(*back)
        truth = None if exact else riccati.riccati_backward_plain(*(t.double() for t in back))
        err_r = check("riccati_backward", got, want, truth, rtol=rtol, quantiles=chaotic,
                      moved=riccati.riccati_backward_plain(*ulp_up(back))
                      if exact and moved else None)
        k, K = want[0], want[1]
        consts = rollout_ops.lane_consts(prob)
        fwd = (consts, X[:, :-1], U, k, K, X[:, 0], alpha)
        truth = None if exact else rollout_ops.forward_rollout_plain(
            consts_f64(consts), *(t.double() for t in fwd[1:]))
        err_f = check("forward_rollout", rollout_ops._launch(*fwd),
                      rollout_ops.forward_rollout_plain(*fwd), truth, rtol=rtol,
                      quantiles=chaotic,
                      moved=rollout_ops.forward_rollout_plain(consts, *ulp_up(fwd[1:]))
                      if exact and moved else None)
        print(f"[kernels {tag}] riccati_backward max abs err {err_r:.3e}; "
              f"forward_rollout max abs err {err_f:.3e}")

        opts = opts or tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
        p = prob.replace(x0=X[:, 0])
        kern, plain = solve_pair(tt, p, opts)
        same = ((kern.status_code == plain.status_code)
                & (kern.iterations_completed == plain.iterations_completed))
        share = float(same.double().mean())
        cost_err = float((kern.final_objective - plain.final_objective)[same].abs().max())
        if exact:
            check_solve_f64(label, kern, plain, moved=solve_pair(
                tt, p.replace(x0=ulp_up((p.x0,))[0]), opts)[1] if moved else None)
            if make_problem is flagship_problem:
                phase_branches(tt, dev)
        elif make_problem is flagship_problem:
            share = check_solve_f32(label, kern, plain, 0.99)
        elif chaotic:
            share = check_clddp_f32_accuracy(tt, dev, make_problem, label, p, opts, kern, plain)
        else:
            # A fleet that converges (most of the tracking problem's does
            # within ten iterations) meets the acceptable exit's 0 < dJ < 1e-6 and the
            # early exit's inf_du < tol at float32 rounding: the plain driver
            # forks from itself there under a one-ulp change of x0, as IPDDP's
            # filter ties do (check_ip_f32). So its rule: 99% over the first
            # five iterations, and at ten at most 3 points below that floor.
            short = min(5, opts.max_iterations)
            share = check_solve_f32(f"{label}, {short} iterations", *(
                (kern, plain) if short == opts.max_iterations
                else solve_pair(tt, p, opts.replace(max_iterations=short))), 0.99)
            up = p.replace(x0=torch.nextafter(p.x0, torch.full_like(p.x0, math.inf)))
            floor = cost_share(solve_pair(tt, up, opts)[1], plain)
            print(f"[kernels {tag}] clddp_solve {label}: the plain driver against itself from "
                  f"x0 one ulp up agrees on {floor:.4%}")
            check_solve_f32(label, kern, plain, floor - 0.03)
        print(f"[kernels {tag}] clddp_solve vs plain driver: agree on "
              f"{share:.4%} of {B_CHECK}; max abs cost err where status and "
              f"iterations agree {cost_err:.3e}")
        results[tag] = dict(riccati_backward=err_r, forward_rollout=err_f,
                            clddp_solve=cost_err, clddp_solve_agreement=share)
    return results


def check_clddp_f32_accuracy(tt, dev, make_problem, label, p, opts, kern, plain):
    """float32 CLDDP on a fleet whose solve amplifies rounding from the
    first iterations (the cart-pole's N = 200 swing-up: the plain driver
    agrees with itself from x0 one ulp up in cost (rel 1e-4) on 67% at five
    iterations, and the kernel, which rounds every product apart from it,
    with the plain driver on 57%, on an H100): agreement in cost
    measures chaos there, not the kernel. At ``opts``' budget the kernel's
    statuses and iterations equal the plain driver's on >= 99%, and
    against the plain driver in float64 from the same x0 its median and
    99th-percentile relative cost errors are at most twice the float32
    plain driver's (+1e-6), the rule ``check_ip_f32`` holds kernel 7 to.
    Returns the share with equal status, iterations and cost."""
    from cddp_tpu_torch.solvers import clddp

    p64 = make_problem(tt, torch.float64, dev).replace(x0=p.x0.double())
    same = float(((kern.status_code == plain.status_code)
                  & (kern.iterations_completed == plain.iterations_completed)).double().mean())
    truth = clddp._solve(p64, opts.replace(backward_engine="scan"),
                         *clddp_solve_seeds(p64.x0, p64)).final_objective
    errs = {}
    for name, sol in (("kernel", kern), ("plain", plain)):
        rel = (sol.final_objective.double() - truth).abs() / truth.abs()
        errs[name] = (float(rel.median()), float(rel.quantile(0.99)))
    share = cost_share(kern, plain)
    print(f"[kernels float32] clddp_solve {label}, {opts.max_iterations} iterations: status "
          f"and iterations agree on {same:.4%}, and cost (rel 1e-4) on {share:.4%}; rel cost "
          f"err against float64: median kernel {errs['kernel'][0]:.3e}, plain "
          f"{errs['plain'][0]:.3e}; 99th percentile kernel {errs['kernel'][1]:.3e}, plain "
          f"{errs['plain'][1]:.3e}")
    if same < 0.99:
        raise AssertionError(f"clddp_solve f32 {label}: status and iterations agree on "
                             f"{same:.4%} (need >= 99%)")
    for i, what in enumerate(("median", "99th percentile")):
        if not errs["kernel"][i] <= 2.0 * errs["plain"][i] + 1e-6:
            raise AssertionError(f"clddp_solve f32 {label}: {what} rel cost err against "
                                 f"float64 {errs['kernel'][i]:.3e} exceeds twice the plain "
                                 f"driver's {errs['plain'][i]:.3e}")
    return share


# --- operation and byte counts for the roofline bounds -------------------------

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_F32_PER_S = 67e12  # float32 outside the tensor cores
H100_F64_PER_S = 34e12  # float64 outside the tensor cores

# aten ops that move or make data without arithmetic: no operations.
_NO_OPS = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "clone", "copy_",
    "cat", "stack", "select", "slice", "unsqueeze", "squeeze", "permute", "transpose",
    "t", "empty", "new_empty", "empty_like", "zeros", "new_zeros", "zeros_like",
    "full", "new_full", "full_like", "ones", "ones_like", "eye", "detach", "alias",
    "_to_copy", "lift_fresh", "unbind", "split", "split_with_sizes", "contiguous",
    "fill_", "zero_", "scalar_tensor", "arange", "movedim", "flatten", "item",
    "_local_scalar_dense", "is_nonzero", "resolve_conj", "resolve_neg", "diagonal",
    "as_strided", "index_select", "index", "set_", "new_ones", "lift_fresh_copy",
    "squeeze_", "unsqueeze_", "to", "_index_put_impl_", "index_put_",
}
_REDUCTIONS = {"sum", "amax", "amin", "all", "any", "max", "min", "mean", "prod"}


# What forward-mode AD adds besides arithmetic: zero tangents, casts, the
# stacking of tangent columns.
_AD_MOVES = {"_efficientzerotensor", "_to_copy", "stack", "new_zeros", "copy_",
             "_new_zeros_with_same_feature_meta", "scalar_tensor"}


def count_ops(fn, *args, moves=()):
    """Arithmetic operations ``fn(*args)`` performs, counted at the aten
    level: 2 m n k for a matrix product, one per output element for an
    elementwise op (add, mul, compare, select, sin, log, ...), one per input
    element for a reduction, none for data movement (``moves`` names more of
    it). Run on one instance, it counts the plain version's arithmetic per
    instance."""
    from torch.utils._python_dispatch import TorchDispatchMode

    total = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            name = func.overloadpacket.__name__
            if name in ("mm", "bmm"):
                lhs, rhs = a[0], a[1]
                total[0] += 2 * lhs.numel() * rhs.shape[-1]
            elif name in ("addmm", "baddbmm"):
                total[0] += 2 * a[1].numel() * a[2].shape[-1] + out.numel()
            elif name in _REDUCTIONS:
                total[0] += a[0].numel()
            elif name not in _NO_OPS and name not in moves and isinstance(out, torch.Tensor):
                total[0] += out.numel()
            return out

    with Count():
        fn(*args)
    return total[0]


def count_ops_steps(fn, *args):
    """``count_ops(fn, *args)`` for a recursion over the horizon N of its
    batch-first arguments (those with a step axis 1 of N or N + 1 rows,
    N > 16): the plain versions do the same operations at every step, so
    the count is c(2) + (N - 2) (c(3) - c(2)) from the arguments cut to
    two and three steps, exactly the full count
    (tests/test_torch_chip_smoke.py holds the two equal) in a fraction of
    its time: at N = 100-300 each full count took 1.4-2 s of host time."""
    steps = {a.shape[1] for a in args if isinstance(a, torch.Tensor) and a.dim() >= 3}
    N = max(steps, default=0)
    if N <= 16:
        return count_ops(fn, *args)

    def cut(n):
        return tuple(a[:, :n + (a.shape[1] - N)] if isinstance(a, torch.Tensor) and a.dim() >= 2
                     and a.shape[1] in (N, N + 1) else a for a in args)

    c2, c3 = count_ops(fn, *cut(2)), count_ops(fn, *cut(3))
    return c2 + (N - 2) * (c3 - c2)


def unique_bytes(tensors):
    """Bytes of the distinct elements of ``tensors``: a broadcast (stride 0)
    axis counts once, as a kernel need read it only once."""
    total = 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            n = 1
            for size, stride in zip(t.shape, t.stride()):
                n *= size if stride != 0 else 1
            total += n * t.element_size()
    return total


def backward_operands_read(back):
    """Kernel 6's inputs as the data its function must read, for
    ``unique_bytes``: a step operand that is one value at every instance
    and step as one copy (the quadratic cost's zero lux; on the obstacle
    stack also luu, R plus the constraint-Hessian fold's zero control
    block), and of the constraint Jacobians Gx and Gu the rows that are one
    value at every instance and step (a box's, a ball's control row) as one
    copy beside the rows that vary (a ball's state row)."""
    out = []
    for k, t in enumerate(back):
        if k >= 12 or 0 in t.stride()[:2]:
            out.append(t)
            continue
        same = t == t[:1, :1]
        if k in (10, 11):
            const = same.flatten(3).all(-1).all(0).all(0)
            out += [t[:, :, ~const], t[0, 0, const]]
        else:
            out.append(t[0, 0] if bool(same.all()) else t)
    return tuple(out)


def bound(nbytes, ops, dtype):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the card's non-tensor peak for the dtype."""
    peak = H100_F64_PER_S if dtype == torch.float64 else H100_F32_PER_S
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def first_instance(p):
    """The problem of ``p``'s first instance: x0's first row, and the first
    row of a per-instance objective's tensors (``batched``)."""
    from cddp_tpu_torch.costs import objective as objectives

    obj = p.objective
    if getattr(obj, "batched", False):
        obj = objectives._with_leaves(obj, [t[:1] for t in objectives._leaves(obj)])
    return p.replace(x0=p.x0[:1], objective=obj)


def one(args):
    """The first instance of batch-first arguments (non-tensors as they are)."""
    return tuple(a[:1] if isinstance(a, torch.Tensor) and a.dim() else a for a in args)


def clddp_solve_seeds(x0, prob, U0=None):
    """The cold seeds ``clddp.solve`` builds for x0: X the tiled x0, the
    controls U0 (zeros when None), zero gains."""
    B, N, nu, nx = x0.shape[0], prob.horizon, prob.control_dim, prob.state_dim
    return (x0[:, None].expand(-1, N + 1, -1).contiguous(),
            x0.new_zeros(B, N, nu) if U0 is None else U0,
            x0.new_zeros(B, N, nu), x0.new_zeros(B, N, nu, nx))


def clddp_solve_work(p, opts, seeds):
    """Kernel 3's (inputs, outputs, operations) for its bound from one
    counted launch on ``seeds``: the plain versions' operations per backward
    attempt (the backward's inputs and the Riccati recursion) and per
    rollout, counted at B=1 on the first instance's seeds, times this
    launch's work."""
    from cddp_tpu_torch.ops.kernels import mega_clddp, riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    B, dev = p.x0.shape[0], p.x0.device
    sol3, work = mega_clddp.launch_counting_work(p, opts, *seeds)
    p1, (X1, U1, k1, K1) = p.replace(x0=p.x0[:1]), one(seeds)
    reg1 = X1.new_full((1,), opts.regularization.initial_value)
    ops_back = count_ops(lambda: riccati.riccati_backward_plain(*clddp_backward_inputs(
        p1, X1, U1, reg1)))
    ops2 = count_ops(rollout_ops.forward_rollout_plain, rollout_ops.lane_consts(p1),
                     X1[:, :-1], U1, k1, K1, X1[:, 0], X1.new_ones(1))
    attempts, rollouts = (float(w.double().sum()) for w in work)
    ops3 = attempts * ops_back + rollouts * ops2
    print(f"[divergence] clddp_solve at B={B}: mean over warps of max / mean lane work "
          f"(backward attempts + rollouts) {warp_divergence(work):.4f}")
    print(f"[bound] operations per instance: clddp_solve {ops3 / B:.0f} on average "
          f"({attempts / B:.3f} backward attempts x {ops_back} + {rollouts / B:.3f} "
          f"rollouts x {ops2})")
    outs = (sol3.state_trajectory, sol3.control_trajectory, sol3.feedforward_gains,
            sol3.feedback_gains, torch.empty(6, B, device=dev))
    return tuple(seeds) + reference_read(p), outs, ops3


def time_clddp_kernels(prob, x0, opts, smi,
                       names=("riccati_backward", "forward_rollout", "clddp_solve"),
                       plain_ms=None, events_ok=False):
    """Kernels 1-3 (those of ``names``) at the main path's batch: kernel and
    plain times and each one's bound from this run's inputs
    (``time_kernels``; ``plain_ms`` gives plain times measured elsewhere);
    the rollout on ``stage_inputs``' trajectories and gains, the whole
    solve on the fleet's cold seeds from x0."""
    from cddp_tpu_torch.ops.kernels import mega_clddp, riccati
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
    from cddp_tpu_torch.solvers import clddp

    dev = x0.device
    X, U, back, alpha = stage_inputs(prob, B_MAIN, torch.Generator(device=dev).manual_seed(SEED))
    out1 = riccati._launch(*back)
    k, K = out1[0], out1[1]
    consts = rollout_ops.lane_consts(prob)
    fwd = (consts, X[:, :-1], U, k, K, X[:, 0], alpha)
    out2 = rollout_ops._launch(*fwd)
    seeds = clddp_solve_seeds(x0, prob)
    p = prob.replace(x0=x0)
    plain_opts = opts.replace(backward_engine="scan")
    pc, sc = check_slice(p, seeds)
    # Operations per instance, counted on the plain versions at B=1; the
    # whole solve's from this run's backward attempts and rollouts.
    ops1 = count_ops(riccati.riccati_backward_plain, *one(back))
    ops2 = count_ops(rollout_ops.forward_rollout_plain, consts, *one(fwd[1:]))
    print(f"[bound] operations per instance: riccati_backward {ops1}, forward_rollout {ops2}")
    work_items = {
        "riccati_backward": (back, out1, ops1 * B_MAIN),
        "forward_rollout": (fwd[1:] + reference_read(prob), out2, ops2 * B_MAIN),
        "clddp_solve": clddp_solve_work(p, opts, seeds),
    }
    runs = {
        "riccati_backward": (lambda: riccati._launch(*back), 20,
                             lambda: riccati.riccati_backward_plain(*back), 1),
        "forward_rollout": (lambda: rollout_ops._launch(*fwd), 20,
                            lambda: rollout_ops.forward_rollout_plain(*fwd), 1),
        "clddp_solve": (lambda: mega_clddp._launch(p, opts, *seeds), 20,
                        lambda: clddp._solve(pc, plain_opts, *sc), 1),
    }
    return time_kernels({n: runs[n] for n in names}, work_items, prob.x0.dtype, smi,
                        plain_ms=plain_ms, events_ok=events_ok)


def reference_read(prob):
    """A tracking objective's running reference as the tracking kernels read
    it, one (N, nx) copy for the whole batch, for ``unique_bytes``; nothing
    for the goal form."""
    refs = prob.objective.reference_states
    return () if refs is None else (refs[:prob.horizon],)


# --- IPDDP (the box fleet) -------------------------------------------------------

STATE_BOX = ([-5.0, -5.0, -2.0 * math.pi], [5.0, 5.0, 2.0 * math.pi])


def ip_problem(tt, dtype, device, horizon=HORIZON, state_box=False, goal=None):
    """The IPDDP box fleet (``bench_ipddp_fleet.py``'s box problem: the
    flagship problem under IPDDP), optionally with the state box of
    tests/test_mega_ipddp.py and another goal."""
    prob = flagship_problem(tt, dtype, device, horizon)
    if goal is not None:
        prob = prob.replace(objective=prob.objective.replace(
            reference_state=torch.tensor(goal, device=device, dtype=dtype)))
    if state_box:
        prob = prob.add_constraint("StateConstraint", tt.state_constraint(
            *STATE_BOX, device=device, dtype=dtype))
    return prob


def ip_seeds(prob, opts, x0, U0=None):
    """The cold-start batch ``ipddp.solve`` builds for x0 from the controls
    U0 (B, N, nu) (zeros when None): (problem, (X, U, Y, S, G, Lambda, mu0,
    k_u0, K_u0))."""
    from cddp_tpu_torch.constraints.stack import PathStacker
    from cddp_tpu_torch.solvers import ipddp

    p = prob.replace(x0=x0)
    B, N, nu, nx = x0.shape[0], p.horizon, p.control_dim, p.state_dim
    U0 = x0.new_zeros(B, N, nu) if U0 is None else U0
    seeds = ipddp._initialize(p, opts, PathStacker(p), U0)
    return p, seeds + (x0.new_zeros(B, N, nu), x0.new_zeros(B, N, nu, nx))


def plain_ip_options(tt, opts):
    """``opts`` with the plain engines: the per-pass driver without kernels."""
    return opts.replace(backward_engine="scan", ipddp=dataclasses.replace(
        opts.ipddp, forward_engine="scan"))


def stage_ip_inputs(tt, prob, B, gen, opts, iterations=4, U0=None, kernels=False):
    """Inputs of the open-loop rollout, condensed backward and forward trial
    kernels as the per-pass driver stages them: the plain driver takes
    ``iterations`` (phase 14 takes one on its long horizons) from cold
    starts at random x0, and about the iterate it reaches the backward's
    inputs are built at its barrier parameter and
    regularization, and a line-search trial from the plain backward's gains
    at a random ladder step capped by the fraction-to-boundary maxima. On
    a quarter of the batch the caps are tripled, so that the trial's
    fraction-to-boundary test fails on part of it; the slack SOC flag is
    set on half. ``U0``: the cold starts' controls, (N, nu) for every
    instance (zeros when None). ``kernels``: the iterations and the trial's
    gains by the per-pass driver with its kernels (4, 6, 5) in place of the
    plain driver (phase 17's long horizons, whose plain iteration takes
    seconds). Returns (problem, (x0, U), backward args, forward args)."""
    from cddp_tpu_torch.constraints.stack import PathStacker
    from cddp_tpu_torch.options import line_search_alphas
    from cddp_tpu_torch.solvers import ipddp

    dev, dtype = prob.x0.device, prob.x0.dtype
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=dtype)  # noqa: E731
    x0 = fleet_x0(prob, B, gen)
    p, seeds = ip_seeds(prob, opts, x0, None if U0 is None else U0.expand(B, -1, -1))
    stk = PathStacker(p)
    drive = opts.replace(max_iterations=iterations)
    sol = ipddp._drive(p, drive if kernels else plain_ip_options(tt, drive), *seeds)
    X, U, Lam = sol.state_trajectory, sol.control_trajectory, sol.costate_trajectory
    Y = torch.cat([sol.dual_trajectories[n] for n in stk.names], -1)
    S = torch.cat([sol.slack_trajectories[n] for n in stk.names], -1)
    G = ipddp._eval_path(stk, X, U)
    mu, reg = sol.barrier_mu, sol.final_regularization
    back = ipddp.backward_inputs(p, stk, X, U, Y, S, G, mu, reg)
    bp = ipddp._backward_condensed(p, opts if kernels else opts.replace(backward_engine="scan"),
                                   stk, X, U, Y, S, G, mu, reg)
    a_pr_max, a_du_max = ipddp._max_step_sizes(S, Y, bp.dS, bp.dY, mu, opts)
    ladder = torch.tensor(line_search_alphas(opts.line_search)[:4], device=dev, dtype=dtype)
    alpha = ladder[torch.randint(0, len(ladder), (B,), generator=gen, device=dev)]
    over = torch.where(rand(B) < 0.25, 3.0, 1.0).to(dtype)
    fwd = (X[:, :-1], U, Y, S, bp.k_u, bp.K_u, bp.k_lambda[:, :-1], bp.K_lambda[:, :-1],
           Lam[:, :-1], bp.k_y, bp.K_y, bp.k_s, bp.K_s, x0,
           torch.minimum(alpha, a_pr_max * over), torch.minimum(alpha, a_du_max * over),
           ipddp._tau(opts, mu), rand(B) < 0.5)
    return p, (x0, U), back, fwd


def per_pass_layout(back):
    """The condensed backward's inputs in the layout the per-pass driver
    hands them on: Y, S and G as the forward kernel returns them, batch-last
    views; the plain driver (``stage_ip_inputs``) makes them batch-first."""
    return tuple(t.movedim(0, -1).contiguous().movedim(-1, 0) if k in (7, 8, 9) else t
                 for k, t in enumerate(back))


def forward_consts(prob, opts, slack_soc, f64=False):
    """The forward kernel's constants for ``prob``, with the slack SOC
    re-closure on or off (and in float64 for the float32 truth)."""
    from cddp_tpu_torch.constraints.stack import PathStacker
    from cddp_tpu_torch.ops.kernels import ip_rollout

    fc = ip_rollout.resolve_ip_forward(prob, opts, PathStacker(prob))
    fc = dataclasses.replace(fc, slack_soc=slack_soc)
    return dataclasses.replace(fc, lane=consts_f64(fc.lane)) if f64 else fc


def cost_agree(a, b):
    """Per instance: status, iteration count and cost (rel 1e-4) equal in
    two solutions."""
    same = (a.status_code == b.status_code) & (a.iterations_completed == b.iterations_completed)
    rel = (a.final_objective - b.final_objective).abs() / b.final_objective.abs()
    return same & (rel <= 1e-4)


def cost_share(a, b):
    """Share of instances whose status, iteration count and cost (rel
    1e-4) are equal in two solutions."""
    return float(cost_agree(a, b).double().mean())


def checked_errs(phase, errs):
    """``errs``, a phase's check errors {dtype: {entry: err}} that ``run``
    took earlier, refused where a dtype has none: checks that returned
    nothing fail here, not later."""
    if not all(errs.get(tag) for tag in ("float64", "float32")):
        raise AssertionError(f"{phase}: its checks returned no errors ({errs!r})")
    return errs


def check_ip_solve(label, kern, plain, exact, tol=1e-8, min_share=0.99, dual_rtol=0.0):
    """The whole-solve kernel against the plain per-pass driver on the same
    seeds. float64: status and iteration count equal on every instance; X,
    U, cost and mu within ``tol``, every dual and slack (the terminal
    constraints' duals, multipliers and slacks too) within ``tol`` +
    ``dual_rtol`` times the plain value's magnitude. float32: status
    and iterations equal on >= 99% of instances, and status, iterations and
    cost (rel 1e-4) on >= ``min_share``. Returns (status counts, share with
    equal cost, max abs cost err where status and iterations agree)."""
    same = ((kern.status_code == plain.status_code)
            & (kern.iterations_completed == plain.iterations_completed))
    counts = torch.bincount(kern.status_code.long(), minlength=4).tolist()
    cost_err = float((kern.final_objective - plain.final_objective)[same].abs().max())
    tag = "float64" if exact else "float32"
    if exact:
        if not bool(same.all()):
            raise AssertionError(f"ipddp_solve f64 {label}: status/iterations differ "
                                 f"on {int((~same).sum())} instances")
        pairs = [("X", kern.state_trajectory, plain.state_trajectory, 0.0),
                 ("U", kern.control_trajectory, plain.control_trajectory, 0.0),
                 ("cost", kern.final_objective, plain.final_objective, 0.0),
                 ("mu", kern.barrier_mu, plain.barrier_mu, 0.0)]
        for name in plain.dual_trajectories:
            pairs += [(f"Y[{name}]", kern.dual_trajectories[name],
                       plain.dual_trajectories[name], dual_rtol),
                      (f"S[{name}]", kern.slack_trajectories[name],
                       plain.slack_trajectories[name], dual_rtol)]
        for name in plain.terminal_duals or {}:
            pairs.append((f"Y_T[{name}]", kern.terminal_duals[name],
                          plain.terminal_duals[name], dual_rtol))
        for name in plain.terminal_slacks or {}:
            pairs.append((f"S_T[{name}]", kern.terminal_slacks[name],
                          plain.terminal_slacks[name], dual_rtol))
        errs = {}
        for name, g, w, rtol in pairs:
            err = abs_err(g, w)
            errs[name] = float(err.max())
            if not bool((err <= tol + rtol * w.double().abs()).all()):
                raise AssertionError(f"ipddp_solve f64 {label} {name}: max abs err "
                                     f"{errs[name]} > {tol} + {rtol} |plain|")
        share = 1.0
        detail = "max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    else:
        rel = ((kern.final_objective - plain.final_objective).abs()
               / plain.final_objective.abs())
        share = cost_share(kern, plain)
        if float(same.double().mean()) < 0.99 or share < min_share:
            raise AssertionError(f"ipddp_solve f32 {label}: status and iterations agree "
                                 f"on {float(same.double().mean()):.4%} (need >= 99%), "
                                 f"and cost too on {share:.4%} (need >= {min_share:.4%})")
        detail = (f"status and iterations alone on {float(same.double().mean()):.4%}; "
                  f"median rel cost err {float(rel.median()):.3e}, 99th percentile "
                  f"{float(rel.quantile(0.99)):.3e}")
    its = torch.bincount(kern.iterations_completed.long()).tolist()
    print(f"[kernels {tag}] ipddp_solve {label}: status, iterations"
          f"{'' if exact else ' and cost'} agree on {share:.4%} of {same.numel()}; "
          f"statuses {counts}; iterations {its}; {detail}")
    return counts, share, cost_err


def seeded(prob, opts, x0, seeds_fn=None):
    """(problem, seeds, terminal state) for x0: the cold seeds of
    ``ip_seeds`` (terminal None: the cold one), or ``seeds_fn``'s (phase
    13's warm seeds, ``ip_warm_seeds``)."""
    if seeds_fn is None:
        return ip_seeds(prob, opts, x0) + (None,)
    return seeds_fn(prob, opts, x0)


def ip_solve_pair(tt, prob, opts, x0, seeds_fn=None):
    """The whole-solve kernel and the plain per-pass driver from the same
    seeds: cold ones, or ``seeds_fn``'s."""
    from cddp_tpu_torch.ops.kernels import mega_ipddp
    from cddp_tpu_torch.solvers import ipddp

    p, seeds, term = seeded(prob, opts, x0, seeds_fn)
    if not mega_ipddp.mega_eligible(p, opts):
        raise AssertionError("the case is not eligible for the whole-solve kernel")
    return (mega_ipddp._launch(p, opts, *seeds, terminal=term),
            timed_plain(lambda: ipddp._drive(p, plain_ip_options(tt, opts), *seeds,
                                             terminal=term)))


def phase_ip_kernels(tt, dev):
    """Kernels 4-7 against their plain versions on the card (phase 5)."""
    from cddp_tpu_torch.ops.kernels import ip_rollout
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        exact = dtype == torch.float64
        gen = torch.Generator(device=dev).manual_seed(SEED)
        prob = ip_problem(tt, dtype, dev)
        opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
        p, ol, back, fwd = stage_ip_inputs(tt, prob, B_CHECK, gen, opts)
        as64 = lambda ts: tuple(t.double() if t.is_floating_point() else t  # noqa: E731
                                for t in ts)
        entry = rollout_ops.model_entry(p.model)

        want = (ip_rollout.open_loop_rollout_plain(p.model, *ol, DT),)
        truth = None if exact else (ip_rollout.open_loop_rollout_plain(
            p.model, *as64(ol), DT),)
        err4 = check("open_loop_rollout",
                     (ip_rollout._launch_open_loop(p.model, entry, *ol, DT),), want, truth)

        err6, ok_share = check_backward_layouts(tt, dev, back, opts)

        err5 = 0.0
        for soc in (False, True):
            fc = forward_consts(p, opts, soc)
            truth = None if exact else ip_rollout.ip_forward_plain(
                forward_consts(p, opts, soc, f64=True), *as64(fwd))
            got = ip_rollout._launch_forward(fc, *fwd)
            err5 = max(err5, check(f"ip_forward slack_soc={soc}", got,
                                   ip_rollout.ip_forward_plain(fc, *fwd), truth))
            feasible = float(got[-1].double().mean())
            print(f"[kernels {tag}] ip_forward slack_soc={soc}: feasible on "
                  f"{feasible:.2%} of {B_CHECK}")
            if exact and not 0.0 < feasible < 1.0:
                raise AssertionError("the forward trial must pass its fraction-to-"
                                     "boundary test on part of the batch only")
        print(f"[kernels {tag}] open_loop_rollout max abs err {err4:.3e}; "
              f"ipddp_backward max abs err {err6:.3e} (ok on {ok_share:.2%}); "
              f"ip_forward max abs err {err5:.3e}")

        x0 = torch.rand(B_CHECK, 3, generator=gen, device=dev, dtype=dtype) - 0.5
        if exact:
            _, share, cost_err = check_ip_solve("box fleet", *ip_solve_pair(tt, prob, opts, x0),
                                                True)
            phase_ip_branches(tt, dev, x0)
        else:
            share, cost_err = check_ip_f32(tt, dev, prob, opts, x0)
        results[tag] = dict(open_loop_rollout=err4, ipddp_backward=err6, ip_forward=err5,
                            ipddp_solve=cost_err, ipddp_solve_agreement=share)
    return results


def check_backward_layouts(tt, dev, back, opts):
    """Kernel 6 against its plain version at m = 4 (``back``, the box
    fleet's inputs), 6 (a state box) and 10 (both boxes), each on the
    driver's operands, whose cost Hessians and constraint Jacobians are
    broadcasts, on materialised batch-first copies of them, on batch-last
    views of the per-instance operands and on a ragged batch (the first
    B_CHECK - 37 instances, a partial last block): every layout must give
    the driver's layout's bits, and the kernel must pass ``check`` (in
    float32 held to its 2x rule at m = 4).
    Prints each variant's attributes; returns (max abs err, ok share) at
    m = 4."""
    from cddp_tpu_torch.ops.kernels import build
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric

    dtype = back[0].dtype
    tag = "f64" if dtype == torch.float64 else "f32"
    out = {}
    for m in (4, 6, 10):
        if m != 4:
            prob = ip_problem(tt, dtype, dev, state_box=True)
            if m == 6:
                prob = prob.replace(constraints={
                    "StateConstraint": prob.get_constraint("StateConstraint")})
            gen = torch.Generator(device=dev).manual_seed(SEED + m)
            back = stage_ip_inputs(tt, prob, B_CHECK, gen, opts)[2]
        if back[7].shape[-1] != m:
            raise AssertionError(f"staged {back[7].shape[-1]} constraint rows, not {m}")
        broadcast = (4, 5, 10, 11)
        strides = ric.operand_strides(back)
        if any(strides[k][:2] != (0, 0) for k in broadcast):
            raise AssertionError(f"the driver's cost Hessians and constraint Jacobians are "
                                 f"not broadcasts: {strides}")
        got = ric._launch(*back)
        layouts = {
            "materialised": [t.contiguous() for t in back],
            # Batch-last views, as the forward kernel returns its duals and slacks.
            "batch-last": [t if k in broadcast else t.movedim(0, -1).contiguous().movedim(-1, 0)
                           for k, t in enumerate(back)],
            # A ragged batch (a partial last block): the first rows' bits.
            "ragged": [t[:B_CHECK - 37] for t in back],
        }
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        for layout, ins in layouts.items():
            for i, (a, b) in enumerate(zip(got, ric._launch(*ins))):
                if not torch.equal(a[:b.shape[0]].view(bits), b.view(bits)):
                    raise AssertionError(f"ipddp_backward m={m} output {i}: {layout} operands "
                                         f"give other bits than the driver's")
        truth = None if tag == "f64" else ric.ipddp_backward_plain(
            *(t.double() for t in back))
        # float32 is held to the 2x rule on the main path (m = 4) only: the
        # FMA-contracted kernel's worst step at m = 6 has 2.5x the plain
        # version's error against float64, in the batch-last design too.
        err = check(f"ipddp_backward m={m}", got, ric.ipddp_backward_plain(*back), truth,
                    gate=m == 4)
        out[m] = (err, float(got[-1][:, 6].double().mean()))
        a = build.kernel_attributes(f"cddp_ipddp_backward_3x2x{m}_{tag}")
        print(f"[kernels {tag}] ipddp_backward m={m}: broadcast, materialised, batch-last "
              f"and ragged operands give the same bits; max abs err against plain {err:.3e} (ok on "
              f"{out[m][1]:.2%}); {a['registers']} registers, {a['spill_bytes']} local bytes, "
              f"{a['static_smem_bytes'] + a['dynamic_smem_bytes']} shared bytes (the driver's "
              f"layout), {a['threads']} threads, {a['blocks_per_sm']} blocks per SM")
    return out[4]


def self_agreement(tt, prob, opts, x0, plain, seeds_fn=None):
    """The share of instances on which the plain driver from x0 one ulp up
    agrees with ``plain`` in status, iterations and cost (rel 1e-4)."""
    from cddp_tpu_torch.solvers import ipddp

    plain_opts = plain_ip_options(tt, opts)
    p1, seeds1, term1 = seeded(prob, plain_opts,
                               torch.nextafter(x0, torch.full_like(x0, math.inf)), seeds_fn)
    return cost_share(ipddp._drive(p1, plain_opts, *seeds1, terminal=term1), plain)


def check_ip_f32(tt, dev, prob, opts, x0, prob64=None, label="box fleet", early_forks=False,
                 seeds_fn=None):
    """The float32 whole-solve kernel against the plain driver. Over the box
    fleet's first five iterations the two agree in status, iterations and
    cost (rel 1e-4) on >= 99% of instances. From the sixth on the float32
    path forks at accept-margin ties of the filter line search (the JAX
    package's tests/test_mega_ipddp.py::TestF32BranchSensitivity): the plain
    driver forks from itself as often when x0 moves by one ulp. At the full
    10 iterations the kernel is held to that floor: its share of equal
    cost may fall at most 3 points below the plain driver's share against
    itself from x0 one ulp up, and against the plain driver in float64 its
    median and 99th-percentile relative cost errors may be at most twice
    the float32 plain driver's (+1e-6). ``early_forks``: a fleet whose
    plain driver forks from itself within five iterations already (the
    terminal equality's, whose multiplier least squares reads float32
    rounding from the first iteration) is held to that floor at five
    iterations too. ``seeds_fn``: seeds other than the cold ones (phase
    13's warm seeds), for x0 and its move alike. Returns (share with equal
    cost, max abs cost err where status and iterations agree) at five
    iterations."""
    from cddp_tpu_torch.solvers import ipddp

    short = min(5, opts.max_iterations)
    short_opts = opts.replace(max_iterations=short)
    kern5, plain5 = ip_solve_pair(tt, prob, short_opts, x0, seeds_fn)
    short_min = 0.99
    if early_forks:
        floor5 = self_agreement(tt, prob, short_opts, x0, plain5, seeds_fn)
        print(f"[kernels float32] {label}: the plain driver against itself from x0 one ulp "
              f"up at {short} iterations: {floor5:.4%} of {x0.shape[0]}")
        short_min = floor5 - 0.03
    _, short_share, short_err = check_ip_solve(f"{label}, {short} iterations", kern5, plain5,
                                               False, min_share=short_min)
    kern, plain = ((kern5, plain5) if opts.max_iterations == short
                   else ip_solve_pair(tt, prob, opts, x0, seeds_fn))
    plain_opts = plain_ip_options(tt, opts)
    floor = self_agreement(tt, prob, opts, x0, plain, seeds_fn)
    print(f"[kernels float32] the plain driver against itself from x0 one ulp up: status, "
          f"iterations and cost agree on {floor:.4%} of {x0.shape[0]}")
    check_ip_solve(label, kern, plain, False, min_share=floor - 0.03)
    prob64 = ip_problem(tt, torch.float64, dev) if prob64 is None else prob64
    p64, seeds64, term64 = seeded(prob64, plain_opts, x0.double(), seeds_fn)
    truth = ipddp._drive(p64, plain_opts, *seeds64, terminal=term64).final_objective
    errs = {}
    for name, sol in (("kernel", kern), ("plain", plain)):
        rel = (sol.final_objective.double() - truth).abs() / truth.abs()
        errs[name] = (float(rel.median()), float(rel.quantile(0.99)))
    print(f"[kernels float32] ipddp_solve {label} against the float64 plain driver: "
          f"median rel cost err kernel {errs['kernel'][0]:.3e}, plain {errs['plain'][0]:.3e}; "
          f"99th percentile kernel {errs['kernel'][1]:.3e}, plain {errs['plain'][1]:.3e}")
    for i, what in enumerate(("median", "99th percentile")):
        if not errs["kernel"][i] <= 2.0 * errs["plain"][i] + 1e-6:
            raise AssertionError(f"ipddp_solve f32: {what} rel cost err against float64 "
                                 f"{errs['kernel'][i]:.3e} exceeds twice the plain "
                                 f"driver's {errs['plain'][i]:.3e}")
    return short_share, short_err


def phase_ip_branches(tt, dev, x0):
    """float64 cases of the whole-solve kernel against the plain driver that
    take its other branches: both other barrier strategies, the state box,
    the regularization limit through the backward retry loop (status 3) and
    a run to convergence (status 1 or 2). Each asserts the statuses it is
    there for."""
    from cddp_tpu_torch.options import (BarrierOptions, BarrierStrategy,
                                        RegularizationOptions)

    dtype = torch.float64
    base = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    barrier = lambda s: base.replace(ipddp=tt.IPDDPOptions(  # noqa: E731
        barrier=BarrierOptions(strategy=s)))
    limit = ip_problem(tt, dtype, dev, horizon=8)
    limit = limit.replace(objective=limit.objective.replace(
        R=-5.0 * torch.eye(2, device=dev, dtype=dtype)))
    cases = (
        # label, problem, options, statuses every instance must end in,
        # statuses some instance must reach
        ("monotonic", ip_problem(tt, dtype, dev), barrier(BarrierStrategy.MONOTONIC),
         None, ()),
        ("ipopt", ip_problem(tt, dtype, dev), barrier(BarrierStrategy.IPOPT), None, ()),
        ("control and state box", ip_problem(tt, dtype, dev, state_box=True), base,
         None, ()),
        ("regularization limit", limit, tt.CDDPOptions(
            max_iterations=4, regularization=RegularizationOptions(
                initial_value=1e-6, update_factor=10.0, max_value=1e-2)), {3}, (3,)),
        ("to convergence", ip_problem(tt, dtype, dev, goal=(0.6, 0.4, 0.5)),
         tt.CDDPOptions(max_iterations=60, tolerance=1e-5), None, (1, 2)),
    )
    for label, prob, opts, only, reached in cases:
        counts, _, _ = check_ip_solve(label, *ip_solve_pair(tt, prob, opts, x0), True)
        if only is not None and sum(counts[s] for s in only) != x0.shape[0]:
            raise AssertionError(f"{label}: statuses {counts}, not all in {only}")
        if reached and not sum(counts[s] for s in reached) > 0:
            raise AssertionError(f"{label}: statuses {counts} reach none of {reached}")


def phase_ip_fleet(tt, dev, smi, obstacle=False):
    """The IPDDP box fleet (phase 6), or with ``obstacle`` the obstacle fleet
    (phase 8), through ``batched_solve`` at B_MAIN, float32: launch counts
    per engine (the obstacle's per-pass run takes no forward-trial kernel:
    kernel 5 is box-only), finite costs and residuals, status agreement with
    the plain driver, solves/s. Returns (launch counts of the run that
    drives each kernel, launch counts of the default engine's run, solves/s,
    problem, x0)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    prob = (obstacle_problem if obstacle else ip_problem)(tt, torch.float32, dev)
    tag = "[obstacle]" if obstacle else "[ipddp]"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.rand(B_MAIN, 3, generator=gen, device=dev) - 0.5
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    engines = {
        "whole-solve kernel": opts,
        "per-pass kernels": opts.replace(solve_engine="xla"),
        "plain driver": plain_ip_options(tt, opts),
    }
    sols, counts, took = {}, {}, {}
    for name, o in engines.items():
        dispatch_log.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols[name] = batched_solve(prob, fleet_batch(name, x0), "IPDDP", o)
        torch.cuda.synchronize()
        took[name] = time.perf_counter() - t0
        counts[name] = dict(dispatch_log.launches)
        print(f"{tag} launches of the {name} run: {counts[name]}")
    if counts["whole-solve kernel"] != {"open_loop_rollout": 1, "ipddp_solve": 1}:
        raise AssertionError(f"the default IPDDP solve did not run as one open-loop "
                             f"rollout and one whole-solve launch: "
                             f"{counts['whole-solve kernel']}")
    per_pass = counts["per-pass kernels"]
    forward_ok = ("ip_forward" not in per_pass if obstacle
                  else per_pass.get("ip_forward", 0) >= 1)
    if (per_pass.get("open_loop_rollout") != 1 or "ipddp_solve" in per_pass
            or per_pass.get("ipddp_backward", 0) < 1 or not forward_ok):
        raise AssertionError(f"the per-pass IPDDP engine did not run on kernels 4 and 6"
                             f"{'' if obstacle else ' and 5'} alone: {per_pass}")
    if counts["plain driver"]:
        raise AssertionError(f"the plain IPDDP driver launched kernels: "
                             f"{counts['plain driver']}")

    whole, plain = sols["whole-solve kernel"], sols["plain driver"]
    for name, sol in sols.items():
        if not (bool(sol.final_objective.isfinite().all())
                and bool(sol.inf_pr.isfinite().all())):
            raise AssertionError(f"non-finite IPDDP costs or inf_pr from the {name}")
    if tuple(whole.control_trajectory.shape) != (B_MAIN, HORIZON, 2):
        raise AssertionError(f"control trajectory shape {tuple(whole.control_trajectory.shape)}")
    agree = float((whole.status_code[:B_CHECK] == plain.status_code).double().mean())
    rel = ((whole.final_objective[:B_CHECK] - plain.final_objective).abs()
           / plain.final_objective.abs())
    print(f"{tag} B={B_MAIN}: statuses "
          f"{torch.bincount(whole.status_code.long(), minlength=4).tolist()}; mean cost "
          f"{float(whole.final_objective.mean()):.4f}, max inf_pr "
          f"{float(whole.inf_pr.max()):.3e}; whole-solve status agrees with the plain "
          f"driver on {agree:.4%} of the first {B_CHECK}, cost within rel 1e-4 on "
          f"{float((rel <= 1e-4).double().mean()):.4%}")
    if agree < 0.99:
        raise AssertionError(f"whole-solve and plain IPDDP statuses agree on {agree:.4%} "
                             f"(need >= 99%)")

    # The per-pass engine's timed run is its launch-count run above: the
    # obstacle fleet's takes 5-6 s (NVIDIA H100 80GB HBM3).
    reps = {"whole-solve kernel": 10}
    rates = {}
    for name, o in engines.items():
        def run(o=o):
            return batched_solve(prob, x0, "IPDDP", o).final_objective

        if name != "whole-solve kernel":  # timed in its one run above
            dt, n, n_reps = took[name], B_CHECK if name == "plain driver" else B_MAIN, 1
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps[name]):
                run()
            torch.cuda.synchronize()
            dt, n, n_reps = (time.perf_counter() - t0) / reps[name], B_MAIN, reps[name]
        rates[name] = n / dt
        print(f"{tag} {name}: {rates[name]:.1f} solves/s ({dt * 1e3:.2f} ms per "
              f"B={n} solve, {n_reps} reps)  [{smi}]")
    launches = {"open_loop_rollout": counts["whole-solve kernel"]["open_loop_rollout"],
                "ipddp_solve": counts["whole-solve kernel"]["ipddp_solve"],
                "ipddp_backward": per_pass["ipddp_backward"],
                "ip_forward": per_pass.get("ip_forward", 0)}
    return launches, counts["whole-solve kernel"], rates, prob, x0


def time_ip_kernels(tt, prob, x0, smi, names=("open_loop_rollout", "ip_forward",
                                               "ipddp_backward", "ipddp_solve"),
                    opts=None, plain_ms=None, events_ok=False, stage_iterations=4):
    """Kernels 4-7 (those of ``names``) at the main path's batch and shapes:
    kernel and plain times and each one's bound from this run's inputs
    (``time_kernels``; ``plain_ms`` gives plain times measured elsewhere),
    the whole solve under ``opts`` (10 iterations, tolerance 1e-4 unless
    given); kernel 6 on the per-pass driver's layout (``per_pass_layout``),
    and also timed on the plain driver's."""
    from cddp_tpu_torch.ops.kernels import ip_rollout, mega_ipddp
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
    from cddp_tpu_torch.solvers import ipddp

    dtype, dt = prob.x0.dtype, prob.timestep
    opts = opts or tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    gen = torch.Generator(device=x0.device).manual_seed(SEED)
    p, ol, back_dense, fwd = stage_ip_inputs(tt, prob, B_MAIN, gen, opts, stage_iterations)
    back = per_pass_layout(back_dense)
    entry = rollout_ops.model_entry(p.model)
    fc = forward_consts(p, opts, False)
    out4 = ip_rollout._launch_open_loop(p.model, entry, *ol, dt)
    out5 = ip_rollout._launch_forward(fc, *fwd)
    pw, seeds = ip_seeds(prob, opts, x0)
    plain_opts = plain_ip_options(tt, opts)
    pc, sc = check_slice(pw, seeds)

    # Operations per instance, counted on the plain versions at B=1; the
    # whole solve's from this run's backward attempts and trajectory sweeps.
    ops4 = count_ops(ip_rollout.open_loop_rollout_plain, p.model, *one(ol), dt)
    ops5 = count_ops(ip_rollout.ip_forward_plain, fc, *one(fwd))
    ops6 = count_ops(ric.ipddp_backward_plain, *one(back))
    print(f"[bound] operations per instance: open_loop_rollout {ops4}, ip_forward "
          f"{ops5}, ipddp_backward {ops6}")
    refs = reference_read(prob)
    work_items = {
        "open_loop_rollout": (ol, (out4[:, 1:],), ops4 * B_MAIN),
        "ip_forward": (fwd + refs, out5, ops5 * B_MAIN),
    }
    if "ipddp_backward" in names:
        out6 = ric._launch(*back)
        work_items["ipddp_backward"] = (backward_operands_read(back), out6, ops6 * B_MAIN)
    if "ipddp_solve" in names:
        work_items["ipddp_solve"] = ipddp_solve_work(tt, pw, opts, seeds, ops5, out5, refs)
    # name: (kernel, its reps, plain version, its reps)
    runs = {
        "open_loop_rollout": (lambda: ip_rollout._launch_open_loop(p.model, entry, *ol, dt), 20,
                              lambda: ip_rollout.open_loop_rollout_plain(p.model, *ol, dt), 1),
        "ip_forward": (lambda: ip_rollout._launch_forward(fc, *fwd), 20,
                       lambda: ip_rollout.ip_forward_plain(fc, *fwd), 1),
        "ipddp_backward": (lambda: ric._launch(*back), 20,
                           lambda: ric.ipddp_backward_plain(*back), 1),
        "ipddp_solve": (lambda: mega_ipddp._launch(pw, opts, *seeds), 10,
                        lambda: ipddp._drive(pc, plain_opts, *sc), 1),
    }
    out = time_kernels({n: runs[n] for n in names}, work_items, dtype, smi, plain_ms=plain_ms,
                       events_ok=events_ok)
    if "ipddp_backward" not in names:
        return out
    dense = lambda: ric._launch(*back_dense)  # noqa: E731
    print(f"[timing] ipddp_backward at B={B_MAIN} on batch-first Y, S and G (the plain "
          f"driver's layout): kernel {cuda_ms(dense, 20):.3f} ms with the wrapper, "
          f"{device_ms(dense, 'ipddp_backward', 10, events_ok)[0]:.3f} ms device  [{smi}]")
    return out


def ipddp_solve_work(tt, pw, opts, seeds, ops5, out5, refs, cost_ops=None):
    """Kernel 7's (inputs, outputs, operations) for its bound from one
    counted launch on ``seeds``: the operations of the plain version per
    backward attempt and per sweep (the forward trial, ``ops5`` of it, with
    the merit, theta and residuals) at B=1, times this launch's work.
    ``cost_ops(p1, X, U)``, when given, counts the cost's derivatives in
    place of the plain objective's (``mpcc_gn_cost_ops``)."""
    from cddp_tpu_torch.constraints.stack import PathStacker
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import mega_ipddp
    from cddp_tpu_torch.solvers import base, ipddp

    sol7, work = mega_ipddp.launch_counting_work(pw, opts, *seeds)

    p1 = first_instance(pw)
    s1 = one(seeds)
    stk1 = PathStacker(p1)
    mu1 = s1[6]
    reg1 = torch.full_like(mu1, 1e-6)
    back1 = lambda: ipddp.backward_inputs(  # noqa: E731
        p1, stk1, s1[0], s1[1], s1[2], s1[3], s1[4], mu1, reg1)
    if cost_ops is None:
        ops_back = count_ops(lambda: ric.ipddp_backward_plain(*back1()))
    else:
        inputs = back1()
        ops_back = (count_ops(lambda: base.discrete_jacobians(p1, s1[0], s1[1]))
                    + count_ops(lambda: stk1.jacobians(s1[0][:, :-1], s1[1]))
                    + count_ops(lambda: ric.ipddp_backward_plain(*inputs))
                    + cost_ops(p1, s1[0], s1[1]))
    ops_sweep = ops5 + count_ops(
        lambda t: (ipddp._barrier_merit(t[6], t[2], mu1), ipddp._theta(opts, t[4], t[2]),
                   ipddp._primal_comp(t[4], t[2], t[3], mu1)),
        one(out5))
    attempts, sweeps = (float(w.double().sum()) for w in work)
    ops7 = attempts * ops_back + sweeps * ops_sweep
    B = pw.x0.shape[0]
    print(f"[divergence] ipddp_solve at B={B}: mean over warps of max / mean lane work "
          f"(backward attempts + sweeps) {warp_divergence(work):.4f}")
    print(f"[bound] operations per instance: ipddp_solve {ops7 / B:.0f} on average "
          f"({attempts / B:.3f} backward attempts x {ops_back} + {sweeps / B:.3f} sweeps x "
          f"{ops_sweep})")
    outs7 = (sol7.state_trajectory, sol7.control_trajectory, sol7.feedforward_gains,
             sol7.feedback_gains, sol7.costate_trajectory,
             *sol7.dual_trajectories.values(), *sol7.slack_trajectories.values())
    return seeds + refs, outs7 + (torch.empty(9, B, device=pw.x0.device),), ops7


def time_kernels(runs, work_items, dtype, smi, label="", events_ok=False, plain_ms=None,
                 batch=None):
    """Time each kernel of ``runs`` ({name: (kernel, reps, plain version,
    reps)}) by CUDA events around its wrapper and by the profiler's device
    time, its plain version by CUDA events without a warm-up (unless
    ``plain_ms`` gives its time, measured elsewhere), and its bound from
    ``work_items`` ({name: (inputs, outputs, operations)}). Returns {name:
    (ms, plain_ms, bound_ms, bound_by, device_ms, device_ms_source)}.
    ``batch``: the kernels' batch, when not B_MAIN."""
    out, batch = {}, batch or B_MAIN
    for name, (kernel, reps, plain, plain_reps) in runs.items():
        # A kernel that runs for seconds (phase 14's long solves) takes as
        # many timed calls as fit TIMING_BUDGET_MS; the profiler takes at
        # least three (it can miss a session's only launch).
        reps = max(3, min(reps, int(TIMING_BUDGET_MS / max(cuda_ms(kernel, 1), 1e-3))))
        ms = cuda_ms(kernel, reps, warm=False)
        # No warm-up for the plain versions (seconds a call on the long
        # horizons): their kernels' checks have run them at these shapes.
        plain_ms_ = (plain_ms or {}).get(name) or cuda_ms(plain, plain_reps, warm=False)
        dev_ms, source = device_ms(kernel, name.split("@")[0], max(reps // 2, 3), events_ok)
        ins, outs, ops = work_items[name]
        nbytes = unique_bytes(ins) + unique_bytes(outs)
        b_ms, b_by = bound(nbytes, ops, dtype)
        out[name] = (ms, plain_ms_, b_ms, b_by, dev_ms, source)
        print(f"[timing] {name}{label} at B={batch}: kernel {ms:.3f} ms with the wrapper, "
              f"{dev_ms:.3f} ms device ({source}), plain {plain_ms_:.3f} ms, bound {b_ms:.4f} ms "
              f"by "
              f"{b_by} ({nbytes / 1e9:.3f} GB, {ops / 1e9:.3f} G operations)  [{smi}]")
    return out


# --- IPDDP (the keep-out-obstacle fleet) ------------------------------------------

OBSTACLE_DT = 0.03


def obstacle_problem(tt, dtype, device, horizon=HORIZON, scale_factor=1.0,
                     ball_name="BallConstraint"):
    """The IPDDP obstacle fleet (``bench_ipddp_fleet.py:38-55``): the
    unicycle, Q = 0, R = 0.05 I, Qf = 100 I, goal (2, 2, pi/2), dt = 0.03,
    the control box and a keep-out ball of radius 0.4 at (1, 1), m = 5. The
    stack is name-sorted: named "BallConstraint", the ball's row is first
    (kernel 7's m5_ball0 variant), named after "ControlConstraint", last
    (m5_ball4)."""
    from cddp_tpu_torch.models import Unicycle

    kw = dict(device=device, dtype=dtype)
    obj = tt.quadratic_objective(torch.zeros(3, 3), torch.eye(2) * 0.05,
                                 torch.eye(3) * 100.0, [2.0, 2.0, math.pi / 2],
                                 OBSTACLE_DT, **kw)
    prob = tt.problem(Unicycle(), obj, torch.zeros(3), horizon, OBSTACLE_DT, **kw)
    prob = prob.add_constraint("ControlConstraint", tt.control_constraint(
        [-2.0, -math.pi], [2.0, math.pi], **kw))
    return prob.add_constraint(ball_name, tt.ball_constraint(0.4, [1.0, 1.0], scale_factor,
                                                             **kw))


def obstacle_pair(tt, prob, opts, x0):
    """Kernel 7 with its latch's final state (soc_on, armed) and the plain
    driver with its latch events, from the same cold seeds."""
    from cddp_tpu_torch.ops.kernels import mega_ipddp
    from cddp_tpu_torch.solvers import ipddp

    p, seeds = ip_seeds(prob, opts, x0)
    if not mega_ipddp.mega_eligible(p, opts):
        raise AssertionError("the case is not eligible for the whole-solve kernel")
    kern, soc_on, armed = mega_ipddp.launch_with_latch(p, opts, *seeds)
    events = {}
    plain = ipddp._drive(p, plain_ip_options(tt, opts), *seeds, events=events)
    return kern, plain, soc_on, armed, events


def stage_obstacle_backward(tt, prob, B, gen):
    """Kernel 6's inputs on the obstacle stack as the per-pass driver builds
    them, about the iterate the plain driver reaches in four iterations with
    a latch that arms at the first stalled commit, with the
    constraint-Hessian fold on: the ball's Jacobian row and the folded lxx
    vary per step and instance (materialised, not broadcasts)."""
    from cddp_tpu_torch.constraints.stack import PathStacker
    from cddp_tpu_torch.solvers import ipddp

    dev, dtype = prob.x0.device, prob.x0.dtype
    x0 = torch.rand(B, 3, generator=gen, device=dev, dtype=dtype) - 0.5
    opts = tt.CDDPOptions(max_iterations=4, tolerance=1e-4,
                          ipddp=tt.IPDDPOptions(soc_stall_iterations=1))
    p, seeds = ip_seeds(prob, opts, x0)
    stk = PathStacker(p)
    sol = ipddp._drive(p, plain_ip_options(tt, opts), *seeds)
    X, U = sol.state_trajectory, sol.control_trajectory
    Y = torch.cat([sol.dual_trajectories[n] for n in stk.names], -1)
    S = torch.cat([sol.slack_trajectories[n] for n in stk.names], -1)
    G = ipddp._eval_path(stk, X, U)
    fold = ipddp.fold_terms(stk, X, U, Y, torch.ones_like(sol.barrier_mu))
    return ipddp.backward_inputs(p, stk, X, U, Y, S, G, sol.barrier_mu,
                                 sol.final_regularization, fold)


def plain_with_kernel_inverse(back):
    """Kernel 6's plain version with one rounding of the kernel's: the
    condensed Quu's adjugate inverse as (sign cofactor) (1 / det)
    (``small_linalg.cuh::inverse``) in place of the plain version's
    (sign cofactor) / det (``linalg.inv_small``); the two differ by at most
    one ulp in each entry of the inverse."""
    from cddp_tpu_torch.ops import linalg
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric

    def inv_small(H):
        idx = range(H.shape[-1])
        inv_det = 1.0 / linalg.det_small(H)
        return torch.stack([torch.stack([
            (-1.0) ** (i + j) * linalg._det_idx(H, tuple(r for r in idx if r != i),
                                                tuple(c for c in idx if c != j)) * inv_det
            for i in idx], dim=-1) for j in idx], dim=-2)

    plain_inverse = linalg.inv_small
    linalg.inv_small = inv_small
    try:
        return ric.ipddp_backward_plain(*back)
    finally:
        linalg.inv_small = plain_inverse


def check_backward_obstacle(tt, dev, dtype):
    """Kernel 6 at m = 5 against its plain version on the obstacle's
    per-step Jacobians and folded lxx (``stage_obstacle_backward``).

    float64: the folded negative curvature makes a few steps' condensed
    Quu near-singular, where the result is set by rounding. So the kernel
    is held exactly (``check``'s 1e-9) to the plain version run with the
    kernel's one rounding that differs, its 2x2 inverse
    (``plain_with_kernel_inverse``), and within 1e-9 + 2 W of the plain
    version itself at each instance and step, W being how far that one
    rounding moves the plain version there. Both plain runs are on CPU
    copies of the operands, as CPU tensors run the wrapper's plain version:
    PyTorch's CPU operations round without fused multiply-adds, as the
    float64 kernel build (``--fmad=false``). float32: the 2x rule of
    ``check``. Returns the max abs error against the plain version."""
    from cddp_tpu_torch.ops.kernels import build
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    back = stage_obstacle_backward(tt, obstacle_problem(tt, dtype, dev), B_CHECK, gen)
    strides = ric.operand_strides(back)
    if strides[4][0] == 0 or strides[10][0] == 0:
        raise AssertionError(f"lxx and Gx of the obstacle stack are broadcasts: {strides}")
    got = ric._launch(*back)
    tag = "f64" if dtype == torch.float64 else "f32"
    if dtype == torch.float64:
        cpu = tuple(t.cpu() for t in back)
        got = tuple(t.cpu() for t in got)
        plain, alt = ric.ipddp_backward_plain(*cpu), plain_with_kernel_inverse(cpu)
        exact = check("ipddp_backward m=5, against the plain version with the kernel's "
                      "inverse", got, alt)
        err = moved = 0.0
        for i, (g, w, a) in enumerate(zip(got, plain, alt)):
            e, W = abs_err(g, w), abs_err(a, w)
            err, moved = max(err, float(e.max())), max(moved, float(W.max()))
            if not bool((e <= 1e-9 + 2.0 * step_scale(W)).all()):
                raise AssertionError(f"ipddp_backward m=5 f64 [{i}]: max abs err "
                                     f"{float(e.max())} against the plain version exceeds "
                                     f"1e-9 + 2x the move of its inverse's rounding")
        print(f"[kernels f64] ipddp_backward m=5: max abs err {exact:.3e} against the plain "
              f"version with the kernel's inverse rounding; {err:.3e} against the plain "
              f"version, which that one rounding moves by up to {moved:.3e} (largest |k_u| "
              f"{float(plain[0].abs().max()):.3e})")
    else:
        truth = ric.ipddp_backward_plain(*(t.double() for t in back))
        err = check("ipddp_backward m=5", got, ric.ipddp_backward_plain(*back), truth)
    a = build.kernel_attributes(f"cddp_ipddp_backward_3x2x5_{tag}")
    print(f"[kernels {tag}] ipddp_backward m=5 (obstacle: per-step Gx and folded lxx): max "
          f"abs err against plain {err:.3e} (ok on {float(got[-1][:, 6].double().mean()):.2%}); "
          f"{a['registers']} registers, {a['spill_bytes']} local bytes, "
          f"{a['static_smem_bytes'] + a['dynamic_smem_bytes']} shared bytes (box layout), "
          f"{a['threads']} threads, {a['blocks_per_sm']} blocks per SM")
    return err


def phase_obstacle_kernels(tt, dev):
    """Kernel 7's ball variant against the plain driver and kernel 6 at m = 5
    against its plain version (phase 7). float64 at B_CHECK, on cases that
    reach each branch of the stall latch, each asserting the plain driver's
    events it is there for: every status and iteration count equal, X, U,
    duals, slacks, cost and mu within 1e-8 (at ball scale 2.5 the kernel's
    g, s (r^2 - q), and the driver's, (-s q) - (-s r^2), round apart: held
    at that tolerance, not to bits), and the latch's final state (SOC on,
    armed) equal on every instance; the duals and slacks, which an active
    ball row takes far from 1, within 1e-8 + 1e-8 of the plain value (the
    CPU parity tests' rtol = atol = 1e-8). float32: the box fleet's rule (``check_ip_f32``).
    Returns {dtype: {kernel: max abs err}}."""
    from cddp_tpu_torch.ops.kernels import mega_ipddp
    from cddp_tpu_torch.options import LineSearchOptions, RegularizationOptions

    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    x0 = torch.rand(B_CHECK, 3, generator=gen, device=dev, dtype=f64) - 0.5
    inside = torch.cat([0.7 + 0.6 * torch.rand(B_CHECK, 2, generator=gen, device=dev, dtype=f64),
                        torch.rand(B_CHECK, 1, generator=gen, device=dev, dtype=f64) - 0.5], 1)
    base = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    fleet = obstacle_problem(tt, f64, dev)
    cases = (
        # label, problem, options, x0, kernel variant, plain-driver events
        # some instance must show
        ("obstacle fleet", fleet, base, x0, "m5_ball0",
         ("stall_armed", "soc_replaced", "folded")),
        ("ball row last", obstacle_problem(tt, f64, dev, ball_name="Obstacle"), base, x0,
         "m5_ball4", ("stall_armed", "soc_replaced", "folded")),
        ("latch, one-rung line search", fleet, base.replace(
            max_iterations=20, line_search=LineSearchOptions(max_iterations=1),
            ipddp=tt.IPDDPOptions(soc_stall_iterations=1)), x0, "m5_ball0",
         ("stall_armed", "soc_replaced", "folded", "dropped")),
        ("latch, inside the ball at a low regularization limit", fleet, base.replace(
            max_iterations=15, regularization=RegularizationOptions(max_value=1e-3)),
         inside, "m5_ball0", ("fail_armed", "soc_replaced", "folded")),
        ("ball scale 2.5", obstacle_problem(tt, f64, dev, scale_factor=2.5), base, x0,
         "m5_ball0", ("stall_armed",)),
    )
    err64 = 0.0
    for label, prob, opts, x, variant, reach in cases:
        if mega_ipddp.solve_variant(prob) != variant:
            raise AssertionError(f"{label}: kernel variant {mega_ipddp.solve_variant(prob)}, "
                                 f"not {variant}")
        kern, plain, soc_on, armed, ev = obstacle_pair(tt, prob, opts, x)
        _, _, err = check_ip_solve(f"obstacle, {label}", kern, plain, True, dual_rtol=1e-8)
        err64 = max(err64, err)
        latch = (soc_on == ev["soc_on"]) & (armed == ev["soc_armed"])
        if not bool(latch.all()):
            raise AssertionError(f"obstacle, {label}: the latch's final state differs on "
                                 f"{int((~latch).sum())} instances")
        missing = [e for e in reach if not bool(ev[e].any())]
        if missing:
            raise AssertionError(f"obstacle, {label}: no instance reached {missing}")
        print(f"[kernels float64] obstacle, {label} ({variant}): the latch's final state "
              f"equal on every instance; plain-driver events on {B_CHECK}: "
              + ", ".join(f"{k} {int(v.sum())}" for k, v in ev.items()))
    share, err32 = check_ip_f32(tt, dev, obstacle_problem(tt, torch.float32, dev), base,
                                x0.float(), prob64=fleet, label="obstacle fleet")
    return {"float64": dict(ipddp_solve=err64,
                            ipddp_backward=check_backward_obstacle(tt, dev, f64)),
            "float32": dict(ipddp_solve=err32, ipddp_solve_agreement=share,
                            ipddp_backward=check_backward_obstacle(tt, dev, torch.float32))}


def time_obstacle_kernels(tt, prob, x0, smi, plain_ms=None):
    """Kernel 7's ball variant on the obstacle fleet's cold seeds and kernel
    6 at m = 5 on the per-pass driver's obstacle operands
    (``stage_obstacle_backward``: every input batch-first, as the plain
    trial returns Y, S and G) at B_MAIN: kernel and plain times and each
    one's bound (``time_kernels``; kernel 6's bytes by
    ``backward_operands_read``). Kernel 7's operations: this run's backward
    attempts, each the plain backward with the ball's Jacobian and the fold
    as the kernel makes it (three multiplies and d adds a step: the plain
    driver's fold multiplies every row's full Hessian), and sweeps, each the
    driver's plain trial on this stack with the slack SOC on, its merit,
    theta and residuals."""
    from cddp_tpu_torch.constraints.stack import PathStacker
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import mega_ipddp
    from cddp_tpu_torch.solvers import ipddp

    dtype = prob.x0.dtype
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    plain_opts = plain_ip_options(tt, opts)
    pw, seeds = ip_seeds(prob, opts, x0)
    sol7, work = mega_ipddp.launch_counting_work(pw, opts, *seeds)
    back = stage_obstacle_backward(tt, prob, B_MAIN,
                                   torch.Generator(device=x0.device).manual_seed(SEED + 5))
    out6 = ric._launch(*back)

    p1 = pw.replace(x0=pw.x0[:1])
    s1 = one(seeds)
    stk1 = PathStacker(p1)
    mu1 = s1[6]
    reg1 = torch.full_like(mu1, 1e-6)
    armed1 = torch.ones_like(mu1, dtype=torch.bool)
    ball = p1.get_constraint("BallConstraint")
    ops_back = count_ops(lambda: ric.ipddp_backward_plain(*ipddp.backward_inputs(
        p1, stk1, *s1[:5], mu1, reg1))) + p1.horizon * (3 + ball.dim)
    bp1 = ipddp._backward_condensed(p1, plain_opts, stk1, *s1[:5], mu1, reg1)
    a1, tau1 = torch.ones_like(mu1), ipddp._tau(opts, mu1)
    trial = lambda: ipddp._forward_scan(p1, stk1, True, s1[0], s1[1], s1[2], s1[3],  # noqa: E731
                                        s1[5], bp1, a1, a1, tau1, armed1)
    t1 = trial()
    ops_sweep = count_ops(trial) + count_ops(
        lambda: (ipddp._barrier_merit(t1[6], t1[2], mu1), ipddp._theta(opts, t1[4], t1[2]),
                 ipddp._primal_comp(t1[4], t1[2], t1[3], mu1)))
    attempts, sweeps = (float(w.double().sum()) for w in work)
    ops7 = attempts * ops_back + sweeps * ops_sweep
    ops6 = count_ops(ric.ipddp_backward_plain, *one(back))
    print(f"[divergence] ipddp_solve obstacle at B={B_MAIN}: mean over warps of max / mean "
          f"lane work (backward attempts + sweeps) {warp_divergence(work):.4f}")
    print(f"[bound] operations per instance, obstacle: ipddp_backward m=5 {ops6}; ipddp_solve "
          f"{ops7 / B_MAIN:.0f} on average ({attempts / B_MAIN:.3f} backward attempts x "
          f"{ops_back} + {sweeps / B_MAIN:.3f} sweeps x {ops_sweep})")
    outs7 = (sol7.state_trajectory, sol7.control_trajectory, sol7.feedforward_gains,
             sol7.feedback_gains, sol7.costate_trajectory,
             *sol7.dual_trajectories.values(), *sol7.slack_trajectories.values())
    pc, sc = check_slice(pw, seeds)
    out = time_kernels(
        {"ipddp_solve": (lambda: mega_ipddp._launch(pw, opts, *seeds), 10,
                         lambda: ipddp._drive(pc, plain_opts, *sc), 1)},
        {"ipddp_solve": (seeds, outs7 + (torch.empty(9, B_MAIN, device=x0.device),), ops7)},
        dtype, smi, label=" (obstacle, m5_ball0)", plain_ms=plain_ms)
    out.update(time_kernels(
        {"ipddp_backward": (lambda: ric._launch(*back), 20,
                            lambda: ric.ipddp_backward_plain(*back), 1)},
        {"ipddp_backward": (backward_operands_read(back), out6, ops6 * B_MAIN)}, dtype, smi,
        label=" (obstacle, m=5)", events_ok=True))
    # luu and Gu are one value at every instance and step here; handed to
    # the kernel as stride-0 broadcasts, read once, they give the same bits.
    bcast = tuple(t[:1, :1].expand_as(t) if k in (5, 11) else t for k, t in enumerate(back))
    if not all(torch.equal(a, b) for a, b in zip(ric._launch(*bcast), out6)):
        raise AssertionError("ipddp_backward m=5: broadcast luu and Gu change the result")
    fn = lambda: ric._launch(*bcast)  # noqa: E731
    print(f"[timing] ipddp_backward (obstacle, m=5) at B={B_MAIN} with luu and Gu as "
          f"stride-0 broadcasts: kernel {cuda_ms(fn, 20):.3f} ms with the wrapper, "
          f"{device_ms(fn, 'ipddp_backward', 10, True)[0]:.3f} ms device  [{smi}]")
    return out


# --- LogDDP and MSIPDDP (the barrier box fleets) -----------------------------------

STATUS_NAMES = 5  # statuses 0-4 (4: LogDDP's regularization-limit quirk)


def barrier_seeds(solver, p, opts, defect=False, U0=None):
    """The cold-start batch ``logddp.solve`` or ``msipddp.solve`` builds for
    p.x0 from the controls U0 (zeros when None; X rolled open-loop from them
    by the plain version, which kernel 4 equals), or for MSIPDDP the
    defect-carrying seed of ``msipddp.defect_seed``; zero gains."""
    from cddp_tpu_torch.constraints.stack import PathStacker
    from cddp_tpu_torch.ops.kernels import ip_rollout
    from cddp_tpu_torch.solvers import msipddp

    x0 = p.x0
    B, N, nu, nx = x0.shape[0], p.horizon, p.control_dim, p.state_dim
    U = x0.new_zeros(B, N, nu) if U0 is None else U0
    gains = (x0.new_zeros(B, N, nu), x0.new_zeros(B, N, nu, nx))
    if solver == "LogDDP":
        return (ip_rollout.open_loop_rollout_plain(p.model, x0, U, p.timestep), U) + gains
    stk = PathStacker(p)
    if defect:
        return msipddp.defect_seed(p, opts, stk, U) + gains
    return msipddp._initialize(p, opts.replace(backward_engine="scan"), stk, U) + gains


def barrier_pair(solver, prob, opts, x0, defect=False, seeds_fn=None):
    """The whole-solve kernel and the plain driver from the same seeds (the
    cold ones, or ``seeds_fn(problem, opts)``'s): ((kernel Solution,
    fields), (plain Solution, fields)), the fields the float64 check
    compares."""
    from cddp_tpu_torch.ops.kernels import mega_logddp, mega_msipddp
    from cddp_tpu_torch.solvers import logddp, msipddp

    p = prob.replace(x0=x0)
    seeds = barrier_seeds(solver, p, opts, defect) if seeds_fn is None else seeds_fn(p, opts)
    mega, drive = ((mega_logddp, logddp._drive) if solver == "LogDDP"
                   else (mega_msipddp, msipddp._drive))
    if not mega.mega_eligible(p, opts):
        raise AssertionError(f"the {solver} case is not eligible for the whole-solve kernel")

    def fields(out):
        sol, st = (out, None) if solver == "LogDDP" else out
        f = {"X": sol.state_trajectory, "U": sol.control_trajectory,
             "k": sol.feedforward_gains, "K": sol.feedback_gains, "cost": sol.final_objective}
        if st is not None:
            f.update(Y=st.Y, S=st.S, F=st.F, Lambda=st.Lambda, mu=sol.barrier_mu)
        return sol, f

    return (fields(mega._launch(p, opts, *seeds)),
            fields(timed_plain(lambda: drive(p, opts, *seeds))))


# MSIPDDP's filter has no violation floor: once a cold start's violations
# are l1 sums of roundoff, the float64 solve forks at ties (ROADMAP C.1) as
# often against its own run from x0 one ulp away as against the kernel. The
# float64 checks hold cold MSIPDDP fleets exactly over MS_EXACT_ITERS
# iterations, forks at ties allowed on MS_TIE_SHARE of the instances, and
# the box fleet at its ten iterations against the plain driver's agreement
# with itself. Configurations whose violations stay well above roundoff (a
# defect-carrying seed, a far goal, the monotonic barrier) do not tie: they
# are held exactly at 10-15 iterations. float32 likewise.
MS_EXACT_ITERS = 4
MS_TIE_SHARE = 0.005
# From the box fleet's warm seeds (phase 13) the float64 plain driver forks
# from itself one ulp away from its third iteration on (on the CPU at
# B=1024: 100% agree at two iterations, 93% at three, 80-82% at four): a
# warm iterate starts near feasible, so its l1 violations reach roundoff
# sooner than a cold start's. Those seeds are held exactly over
# MS_WARM_EXACT_ITERS iterations and at MS_WARM_SELF_ITERS against the
# plain driver's agreement with itself (at four, on an H100, the kernel agreed
# on 77.59% against the plain driver's 80.91% with itself, a fork rate 3.3
# points above it: the kernel rounds every operation apart from the plain
# driver, a larger nudge than one ulp of x0).
MS_WARM_EXACT_ITERS = 2
MS_WARM_SELF_ITERS = 3
SHORT_ITERS = {"LogDDP": 5, "MSIPDDP": MS_EXACT_ITERS}


def check_barrier(solver, label, kern, plain, exact, tol=1e-8, min_share=0.99):
    """A whole-solve kernel against its plain driver on the same seeds.
    float64: status and iteration count equal on every instance, and every
    field within ``tol`` on >= ``min_share`` of them (errors reported over
    those). float32: status and iterations equal on >= 99%, and status,
    iterations and cost (rel 1e-4) on >= ``min_share``. Returns (status
    counts, share held, max abs cost err where status and iterations
    agree)."""
    (ks, kf), (ps, pf) = kern, plain
    name = {"LogDDP": "logddp_solve", "MSIPDDP": "msipddp_solve"}[solver]
    same = ((ks.status_code == ps.status_code)
            & (ks.iterations_completed == ps.iterations_completed))
    counts = torch.bincount(ks.status_code.long(), minlength=STATUS_NAMES).tolist()
    cost_err = float((ks.final_objective - ps.final_objective)[same].abs().max())
    tag = "float64" if exact else "float32"
    if exact:
        if not bool(same.all()):
            raise AssertionError(f"{name} f64 {label}: status/iterations differ on "
                                 f"{int((~same).sum())} instances")
        close = fields_close(kf, pf, tol)
        share = float(close.double().mean())
        if share < min_share:
            raise AssertionError(f"{name} f64 {label}: every field within {tol} on "
                                 f"{share:.4%} of instances (need >= {min_share:.4%})")
        errs = {k: float(abs_err(kf[k][close], pf[k][close]).max()) for k in kf}
        cost_err = errs["cost"]
        detail = (f"{int((~close).sum())} forked; max abs err over the rest "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    else:
        share = cost_share(ks, ps)
        if float(same.double().mean()) < 0.99 or share < min_share:
            raise AssertionError(f"{name} f32 {label}: status and iterations agree on "
                                 f"{float(same.double().mean()):.4%} (need >= 99%), and "
                                 f"cost too on {share:.4%} (need >= {min_share:.4%})")
        rel = (ks.final_objective - ps.final_objective).abs() / ps.final_objective.abs()
        detail = (f"status and iterations alone on {float(same.double().mean()):.4%}; median "
                  f"rel cost err {float(rel.median()):.3e}")
    its = torch.bincount(ks.iterations_completed.long()).tolist()
    print(f"[kernels {tag}] {name} {label}: held on {share:.4%} of {same.numel()}; "
          f"statuses {counts}; iterations {its}; {detail}")
    return counts, share, cost_err


def fields_close(kf, pf, tol=1e-8):
    """Per instance: every field of the two solutions within ``tol``."""
    close = None
    for k in kf:
        e = abs_err(kf[k], pf[k])
        e = e.flatten(1).amax(-1) if e.dim() > 1 else e
        close = e <= tol if close is None else close & (e <= tol)
    return close


def agrees(a, b, exact):
    """Per instance, two (Solution, fields) pairs agree: status and
    iterations equal and every field within 1e-8 (float64), or status,
    iterations and cost (rel 1e-4) (float32)."""
    same = ((a[0].status_code == b[0].status_code)
            & (a[0].iterations_completed == b[0].iterations_completed))
    if exact:
        return same & fields_close(a[1], b[1])
    rel = (a[0].final_objective - b[0].final_objective).abs() / b[0].final_objective.abs()
    return same & (rel <= 1e-4)


def plain_agrees(solver, prob, opts, x1, plain, exact, seeds_fn=None):
    """Per instance: the plain driver from x1 (x0 moved by one ulp) agrees
    with ``plain``, its run from x0."""
    return agrees(barrier_pair(solver, prob, opts, x1, seeds_fn=seeds_fn)[1], plain, exact)


def check_against_self(solver, label, prob, opts, x0, exact, seeds_fn=None):
    """The kernel at the fleet's budget against the plain driver's agreement
    with itself: over all instances no more than 3 points below the plain
    driver's from x0 one ulp up; and among the instances that run agrees
    on, no more than 3 points below the plain driver's from x0 one ulp
    down. (Rounding alone forks the solve at filter ties, so neither share
    is near 100%.)"""
    kern, plain = barrier_pair(solver, prob, opts, x0, seeds_fn=seeds_fn)
    up, down = (plain_agrees(solver, prob, opts, torch.nextafter(x0, torch.full_like(x0, v)),
                             plain, exact, seeds_fn) for v in (math.inf, -math.inf))
    floor = float(up.double().mean())
    tag = "float64" if exact else "float32"
    print(f"[kernels {tag}] {solver} {label}: the plain driver against itself from x0 one "
          f"ulp up {floor:.4%}")
    check_barrier(solver, label, kern, plain, exact, min_share=floor - 0.03)
    same = agrees(kern, plain, exact)
    cond, cond_down = (float((a & up).double().sum() / up.double().sum()) for a in (same, down))
    print(f"[kernels {tag}] {solver} {label}: where the plain driver agrees with its run from "
          f"x0 one ulp up, the kernel agrees with it on {cond:.4%}, its run from x0 one ulp "
          f"down on {cond_down:.4%}")
    if cond < cond_down - 0.03:
        raise AssertionError(f"{solver} {label}: the kernel agrees with the plain driver on "
                             f"{cond:.4%} of its stable instances, more than 3 points below "
                             f"the plain driver's own {cond_down:.4%}")


def check_barrier_f32(solver, prob, opts, x0, label="box fleet", seeds_fn=None,
                      early_forks=False):
    """float32: over the solver's short budget (LogDDP 5 iterations, MSIPDDP
    MS_EXACT_ITERS) the kernel agrees with the plain driver in status,
    iterations and cost (rel 1e-4) on >= 99% of instances; at ten it may
    fall at most 3 points below the plain driver's agreement with itself
    from x0 one ulp up, the rate at which rounding alone forks the solve.
    Returns (share, max abs cost err where status and iterations agree) at
    the short budget. ``early_forks``: a fleet whose plain driver forks
    from itself within the short budget already (MSIPDDP from the box
    fleet's warm seeds) is held there to that floor less 3 points, as
    ``check_ip_f32`` holds one."""
    short = SHORT_ITERS[solver]
    short_opts = opts.replace(max_iterations=short)
    kern, plain = barrier_pair(solver, prob, short_opts, x0, seeds_fn=seeds_fn)
    short_min = 0.99
    if early_forks:
        up = torch.nextafter(x0, torch.full_like(x0, math.inf))
        floor = float(plain_agrees(solver, prob, short_opts, up, plain, False,
                                   seeds_fn).double().mean())
        print(f"[kernels float32] {solver} {label}: the plain driver against itself from x0 "
              f"one ulp up at {short} iterations: {floor:.4%} of {x0.shape[0]}")
        short_min = floor - 0.03
    _, share, err = check_barrier(solver, f"{label}, {short} iterations", kern, plain, False,
                                  min_share=short_min)
    check_against_self(solver, f"{label}, 10 iterations", prob, opts, x0, False, seeds_fn)
    return share, err


def phase_barrier_branches(tt, dev, x0):
    """float64 cases of kernels 9 and 8 against their plain drivers that take
    the branches the box fleet does not; each asserts its branch was
    reached (phase 9). Cold MSIPDDP fleets run MS_EXACT_ITERS iterations
    with forks at roundoff ties allowed on MS_TIE_SHARE of the instances;
    the MSIPDDP configurations that do not tie run 10-15 iterations and are
    held on 99.9%."""
    from cddp_tpu_torch.options import (BarrierOptions, BarrierStrategy, LogBarrierOptions,
                                        MSIPDDPOptions, RegularizationOptions)

    dtype = torch.float64
    fleet = ip_problem(tt, dtype, dev)
    far = ip_problem(tt, dtype, dev, goal=(0.6, 0.4, 0.5))
    indefinite = ip_problem(tt, dtype, dev, horizon=8)
    indefinite = indefinite.replace(objective=indefinite.objective.replace(
        R=-5.0 * torch.eye(2, device=dev, dtype=dtype)))
    limit = dict(max_iterations=4, regularization=RegularizationOptions(
        initial_value=1e-6, update_factor=10.0, max_value=1e-2))
    short = tt.CDDPOptions(max_iterations=8, tolerance=1e-4)

    def ms(iters, **kw):
        return short.replace(max_iterations=iters, msipddp=MSIPDDPOptions(**kw))

    def strategy(s):
        return BarrierOptions(strategy=s)

    def moved_mu(sol, counts, f):
        return bool((sol.barrier_mu < 1.0).any())

    def converged(sol, counts, f):
        return counts[1] + counts[2] > 0

    def near_box(sol, counts, f):
        # z = distance of a control to its bound <= delta on some instance.
        U = f["U"]
        z = torch.minimum(2.0 - U[..., 0].abs(), math.pi - U[..., 1].abs())
        return float(z.min()) <= 0.5

    def defects(sol, counts, f):
        return float((f["F"] - f["X"][:, 1:]).abs().max())

    cold, tie_free = 1.0 - MS_TIE_SHARE, 0.999
    # label, solver, problem, options, defect seed, share held, check of the branch
    cases = (
        ("quadratic branch (delta 0.5)", "LogDDP", fleet, short.replace(
            log_barrier=LogBarrierOptions(relaxed_log_barrier_delta=0.5)), False, 1.0, near_box),
        ("status-4 quirk", "LogDDP", indefinite, tt.CDDPOptions(**limit), False, 1.0,
         lambda s, c, f: c[4] == x0.shape[0]),
        ("to convergence", "LogDDP", far, tt.CDDPOptions(
            max_iterations=60, tolerance=1e-4, acceptable_tolerance=1e-4), False, 1.0, converged),
        # Cold seeds carry no defects: the hybrid rule's linearized gap
        # closing makes some, the dense rule none.
        ("hybrid rollout", "MSIPDDP", fleet, ms(MS_EXACT_ITERS, rollout_type="hybrid"), False,
         cold, lambda s, c, f: defects(s, c, f) > 1e-6),
        ("dense rollout", "MSIPDDP", fleet, ms(MS_EXACT_ITERS, rollout_type="dense"), False,
         cold, lambda s, c, f: defects(s, c, f) == 0.0),
        ("defect seed, nonlinear", "MSIPDDP", fleet, ms(10, segment_length=4), True, tie_free,
         moved_mu),
        ("defect seed, hybrid", "MSIPDDP", fleet, ms(10, segment_length=4,
                                                     rollout_type="hybrid"), True, tie_free,
         moved_mu),
        ("monotonic", "MSIPDDP", fleet, ms(10, barrier=strategy(BarrierStrategy.MONOTONIC)),
         False, tie_free, moved_mu),
        ("ipopt, to convergence", "MSIPDDP", far, ms(15, barrier=strategy(
            BarrierStrategy.IPOPT)), False, tie_free, converged),
        ("control and state box, to convergence", "MSIPDDP",
         ip_problem(tt, dtype, dev, goal=(0.6, 0.4, 0.5), state_box=True), ms(15), False,
         tie_free, lambda s, c, f: f["Y"].shape[-1] == 10 and converged(s, c, f)),
        ("regularization limit", "MSIPDDP", indefinite, tt.CDDPOptions(**limit), False, cold,
         lambda s, c, f: c[3] == x0.shape[0]),
    )
    for label, solver, prob, opts, defect, min_share, reached in cases:
        kern, plain = barrier_pair(solver, prob, opts, x0, defect)
        if defect:
            seed = barrier_seeds(solver, prob.replace(x0=x0), opts, True)
            d0 = float((seed[5] - seed[0][:, 1:]).abs().max())
            print(f"[kernels float64] {label}: seed defects up to {d0:.3e}, after the solve "
                  f"{defects(None, None, plain[1]):.3e}")
            if not d0 > 1e-2:
                raise AssertionError(f"{label}: the seed carries no defects")
        counts, _, _ = check_barrier(solver, f"{label}, {opts.max_iterations} iterations",
                                     kern, plain, True, min_share=min_share)
        if not reached(plain[0], counts, plain[1]):
            raise AssertionError(f"{solver} {label}: the branch was not reached "
                                 f"(statuses {counts})")


def phase_barrier_kernels(tt, dev, make_problem=ip_problem, label="box fleet", opts=None,
                          plain_ms=None, suffix=""):
    """Kernels 9 and 8 against their plain drivers on the card, on the cold
    seeds at B_CHECK of the problem ``make_problem`` builds (phase 9: the
    box fleet, with the branches of ``phase_barrier_branches``; phase 11:
    the tracking problem; phase 14: the pendulum's), under ``opts`` (10
    iterations, tolerance 1e-4 unless given); ``plain_ms`` gets each
    solver's float32 plain host ms at the full budget under its kernel's
    name and ``suffix``. Returns {dtype: {kernel: max abs cost err,
    agreement}}."""
    results = {}
    opts = opts or tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        prob = make_problem(tt, dtype, dev)
        x0 = fleet_x0(prob, B_CHECK, gen)
        out = {}
        for solver, name in (("LogDDP", "logddp_solve"), ("MSIPDDP", "msipddp_solve")):
            if dtype == torch.float32:
                share, err = check_barrier_f32(solver, prob, opts, x0, label)
                if plain_ms is not None:
                    plain_ms[name + suffix] = LAST_PLAIN_MS[0]
            elif solver == "LogDDP":
                _, share, err = check_barrier(solver, label,
                                              *barrier_pair(solver, prob, opts, x0), True)
            else:
                _, share, err = check_barrier(solver, f"{label}, {MS_EXACT_ITERS} iterations",
                                              *barrier_pair(solver, prob, opts.replace(
                                                  max_iterations=MS_EXACT_ITERS), x0), True,
                                              min_share=1.0 - MS_TIE_SHARE)
                check_against_self(solver, f"{label}, 10 iterations", prob, opts, x0, True)
            out[name], out[name + "_agreement"] = err, share
        if dtype == torch.float64 and make_problem is ip_problem:
            phase_barrier_branches(tt, dev, x0)
        results[tag] = out
    return results


def phase_barrier_fleets(tt, dev, smi):
    """The LogDDP and MSIPDDP box fleets through ``batched_solve`` at B_MAIN,
    float32 (phase 10): launch counts per engine, finite costs and inf_pr,
    status agreement with the plain driver, solves/s. Returns (launch
    counts of the whole-solve kernels, launch counts of the default engine's
    runs, solves/s, problem, x0)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    prob = ip_problem(tt, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.rand(B_MAIN, 3, generator=gen, device=dev) - 0.5
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    engines = {
        "whole-solve kernel": opts,
        "per-pass driver": opts.replace(solve_engine="xla"),
        "plain driver": opts.replace(solve_engine="xla", backward_engine="scan"),
    }
    launches, default, rates = {}, {}, {}
    for solver, kernel in (("LogDDP", "logddp_solve"), ("MSIPDDP", "msipddp_solve")):
        sols, counts, took = {}, {}, {}
        for name, o in engines.items():
            dispatch_log.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sols[name] = batched_solve(prob, fleet_batch(name, x0), solver, o)
            torch.cuda.synchronize()
            took[name] = time.perf_counter() - t0
            counts[name] = dict(dispatch_log.launches)
            print(f"[{solver}] launches of the {name} run: {counts[name]}")
        if counts["whole-solve kernel"] != {"open_loop_rollout": 1, kernel: 1}:
            raise AssertionError(f"the default {solver} solve did not run as one open-loop "
                                 f"rollout and one whole-solve launch: "
                                 f"{counts['whole-solve kernel']}")
        if counts["per-pass driver"] != {"open_loop_rollout": 1}:
            raise AssertionError(f"solve_engine='xla' {solver} launched "
                                 f"{counts['per-pass driver']}")
        if counts["plain driver"]:
            raise AssertionError(f"the plain {solver} driver launched kernels: "
                                 f"{counts['plain driver']}")
        launches[kernel] = counts["whole-solve kernel"][kernel]
        default[f"{solver} fleet"] = counts["whole-solve kernel"]
        whole, plain = sols["whole-solve kernel"], sols["plain driver"]
        for name, sol in sols.items():
            if not (bool(sol.final_objective.isfinite().all())
                    and bool(sol.inf_pr.isfinite().all())):
                raise AssertionError(f"non-finite {solver} costs or inf_pr from the {name}")
        if tuple(whole.control_trajectory.shape) != (B_MAIN, HORIZON, 2):
            raise AssertionError(f"control shape {tuple(whole.control_trajectory.shape)}")
        agree = float((whole.status_code[:B_CHECK] == plain.status_code).double().mean())
        rel = ((whole.final_objective[:B_CHECK] - plain.final_objective).abs()
               / plain.final_objective.abs())
        print(f"[{solver}] B={B_MAIN}: statuses "
              f"{torch.bincount(whole.status_code.long(), minlength=STATUS_NAMES).tolist()}; "
              f"mean cost {float(whole.final_objective.mean()):.4f}, max inf_pr "
              f"{float(whole.inf_pr.max()):.3e}; whole-solve status agrees with the plain "
              f"driver on {agree:.4%} of the first {B_CHECK}, cost within rel 1e-4 on "
              f"{float((rel <= 1e-4).double().mean()):.4%}")
        if agree < 0.99:
            raise AssertionError(f"whole-solve and plain {solver} statuses agree on "
                                 f"{agree:.4%} (need >= 99%)")
        # The per-pass driver's timed run is its launch-count run above
        # (MSIPDDP's 4.8 s, NVIDIA H100 80GB HBM3).
        reps = {"whole-solve kernel": 10}
        rates[solver] = {}
        for name, o in engines.items():
            if name != "whole-solve kernel":  # timed in its one run above
                dt, n, n_reps = took[name], B_CHECK if name == "plain driver" else B_MAIN, 1
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps[name]):
                    batched_solve(prob, x0, solver, o)
                torch.cuda.synchronize()
                dt, n, n_reps = (time.perf_counter() - t0) / reps[name], B_MAIN, reps[name]
            rates[solver][name] = n / dt
            print(f"[{solver}] {name}: {rates[solver][name]:.1f} solves/s ({dt * 1e3:.2f} ms "
                  f"per B={n} solve, {n_reps} reps)  [{smi}]")
    return launches, default, rates, prob, x0


def logddp_solve_work(tt, p, opts, seeds):
    """Kernel 9's (inputs, outputs, operations) for its bound from one
    counted launch on ``seeds`` (the problem ``p`` at x0): the operations of
    the plain version per backward attempt, per trajectory sweep and per
    nominal refresh (one an iteration), counted at B=1 on the first
    instance's seeds, times this launch's work."""
    from cddp_tpu_torch.ops.kernels import mega_logddp
    from cddp_tpu_torch.solvers import logddp

    B, dtype, dev = p.x0.shape[0], p.x0.dtype, p.x0.device
    p1 = p.replace(x0=p.x0[:1])
    sol9, work9 = mega_logddp.launch_counting_work(p, opts, *seeds)
    s1 = one(seeds)
    mu1 = torch.full((1,), opts.log_barrier.barrier.mu_initial, dtype=dtype, device=dev)
    bar1 = logddp._barrier(opts, mu1)
    reg1 = torch.full_like(mu1, opts.regularization.initial_value)
    ops_back9 = count_ops(lambda: logddp._backward_pass(p1, opts, bar1, s1[0], s1[1], reg1))
    bp1 = logddp._backward_pass(p1, opts, bar1, s1[0], s1[1], reg1)
    cost1 = p1.objective.evaluate(s1[0], s1[1])
    ops_sweep9 = count_ops(lambda: logddp._forward_pass(
        p1, opts, bar1, s1[0], s1[1], bp1.k, bp1.K, bp1.dV, cost1, cost1, 1.0))
    ops_ref9 = count_ops(lambda: logddp._merit_and_violation(p1, bar1, s1[0], s1[1]))
    attempts, sweeps = (float(w.double().sum()) for w in work9)
    iters = float(sol9.iterations_completed.double().sum())
    ops9 = attempts * ops_back9 + sweeps * ops_sweep9 + iters * ops_ref9
    print(f"[divergence] logddp_solve at B={B}: mean over warps of max / mean lane work "
          f"(backward attempts + sweeps) {warp_divergence(work9):.4f}")
    print(f"[bound] operations per instance: logddp_solve {ops9 / B:.0f} on average "
          f"({attempts / B:.3f} backward attempts x {ops_back9} + {sweeps / B:.3f} "
          f"sweeps x {ops_sweep9} + {iters / B:.3f} refreshes x {ops_ref9})")
    outs9 = (sol9.state_trajectory, sol9.control_trajectory, sol9.feedforward_gains,
             sol9.feedback_gains, torch.empty(8, B, device=dev))
    return tuple(seeds) + reference_read(p), outs9, ops9


def msipddp_solve_work(tt, p, opts, seeds):
    """Kernel 8's (inputs, outputs, operations) for its bound from one
    counted launch on ``seeds``: the plain version's operations per backward
    attempt, line-search trial (with the whole dual-step ladder), commit
    (the accepted trial with its one dual step) and nominal reset, counted
    at B=1, times this launch's work, and the initial cost once an
    instance."""
    from cddp_tpu_torch.constraints.stack import PathStacker
    from cddp_tpu_torch.ops.kernels import mega_msipddp
    from cddp_tpu_torch.options import line_search_alphas
    from cddp_tpu_torch.solvers import filter as flt
    from cddp_tpu_torch.solvers import msipddp

    B, dtype, dev = p.x0.shape[0], p.x0.dtype, p.x0.device
    p1 = p.replace(x0=p.x0[:1])
    sol8, st8, work8 = mega_msipddp.launch_counting_work(p, opts, *seeds)
    stk1 = PathStacker(p1)
    m1 = one(seeds)
    reg1 = torch.full((1,), opts.regularization.initial_value, dtype=dtype, device=dev)
    st1 = dict(X=m1[0], U=m1[1], Y=m1[2], S=m1[3], G=m1[4], F=m1[5], Lambda=m1[6], mu=m1[7],
               cost=p1.objective.evaluate(m1[0], m1[1]))
    st1["filt"], _ = flt.accept_entry(flt.empty_filter(1, 7, dtype, dev),
                                      st1["cost"], torch.zeros_like(st1["cost"]))
    ops_back8 = count_ops(lambda: msipddp._backward_pass(p1, stk1, st1, reg1))
    bp8 = msipddp._backward_pass(p1, stk1, st1, reg1)
    alphas = line_search_alphas(opts.line_search)
    ops_trial8 = count_ops(lambda: msipddp._forward_pass(p1, opts, stk1, st1, bp8, 1.0, alphas))
    # A commit rewrites the accepted trial with its one dual step: the trial
    # without the dual-step ladder and the filter test.
    KydX = (bp8.K_y @ torch.zeros_like(m1[0][:, 1:, :, None]))[..., 0]
    tau = torch.clamp(1.0 - st1["mu"], min=opts.msipddp.barrier.min_fraction_to_boundary)[:, None]
    ops_ladder8 = count_ops(msipddp._dual_step, st1["Y"], bp8.k_y, KydX, tau, alphas)
    ops_filter8 = count_ops(msipddp._is_filter_acceptable, st1["filt"], st1["cost"],
                            st1["cost"], opts, st1["cost"])
    ops_dual8 = count_ops(lambda: st1["Y"] + alphas[0] * bp8.k_y + KydX)
    ops_commit8 = ops_trial8 - ops_ladder8 - ops_filter8 + ops_dual8
    ops_reset8 = count_ops(msipddp._reset_filter_quantities, stk1, st1["X"], st1["Y"],
                           st1["S"], st1["G"], st1["F"], st1["mu"], st1["cost"])
    ops_init8 = count_ops(p1.objective.evaluate, st1["X"], st1["U"])
    attempts, trials, commits, resets = (float(w.double().sum()) for w in work8)
    ops8 = (attempts * ops_back8 + trials * ops_trial8 + commits * ops_commit8
            + resets * ops_reset8 + B * ops_init8)
    print(f"[divergence] msipddp_solve at B={B}: mean over warps of max / mean lane work "
          f"(backward attempts + trials + commits + resets) {warp_divergence(work8):.4f}")
    print(f"[bound] operations per instance: msipddp_solve {ops8 / B:.0f} on average "
          f"({attempts / B:.3f} backward attempts x {ops_back8} + {trials / B:.3f} "
          f"trials x {ops_trial8} + {commits / B:.3f} commits x {ops_commit8} + "
          f"{resets / B:.3f} resets x {ops_reset8} + the initial cost {ops_init8})")
    outs8 = (sol8.state_trajectory, sol8.control_trajectory, sol8.feedforward_gains,
             sol8.feedback_gains, st8.Y, st8.S, st8.F, st8.Lambda,
             torch.empty(9, B, device=dev))
    return tuple(seeds[:4]) + tuple(seeds[5:]) + reference_read(p), outs8, ops8


def time_barrier_kernels(tt, prob, x0, smi, opts=None, plain_ms=None, events_ok=False):
    """Kernels 9 and 8 at the main path's batch and shapes, under ``opts``
    (10 iterations, tolerance 1e-4 unless given):
    kernel and plain driver times (``plain_ms`` gives them where measured
    elsewhere) and each one's bound from this run's inputs and work
    (``time_kernels``; ``logddp_solve_work``, ``msipddp_solve_work``)."""
    from cddp_tpu_torch.ops.kernels import mega_logddp, mega_msipddp
    from cddp_tpu_torch.solvers import logddp, msipddp

    opts = opts or tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    p = prob.replace(x0=x0)
    work_items, runs = {}, {}
    for name, solver, mega, drive in (("logddp_solve", "LogDDP", mega_logddp, logddp._drive),
                                      ("msipddp_solve", "MSIPDDP", mega_msipddp,
                                       msipddp._drive)):
        seeds = barrier_seeds(solver, p, opts)
        work_items[name] = (logddp_solve_work if name == "logddp_solve"
                            else msipddp_solve_work)(tt, p, opts, seeds)
        pc, sc = check_slice(p, seeds)
        runs[name] = (lambda mega=mega, seeds=seeds: mega._launch(p, opts, *seeds), 10,
                      lambda drive=drive, pc=pc, sc=sc: drive(pc, opts, *sc), 1)
    return time_kernels(runs, work_items, prob.x0.dtype, smi, plain_ms=plain_ms,
                        events_ok=events_ok)


# --- tracking MPC (per-step reference trajectories) --------------------------------

TRACK_TICKS = 5
# The tracking variant of each kernel that has one: its dispatch_log name.
TRACKING = {k: k + "_track" for k in ("forward_rollout", "clddp_solve", "ip_forward",
                                      "ipddp_solve", "msipddp_solve", "logddp_solve")}


def tracking_reference(horizon, tick, dtype, device):
    """The arc (sin t, 1 - cos t, t) at t = linspace(0, 1, N) + tick * dt:
    tests/test_ip_rollout.py:537-559's reference, slid by one step a tick."""
    ts = torch.linspace(0.0, 1.0, horizon, dtype=torch.float64) + tick * DT
    refs = torch.stack([torch.sin(ts), 1.0 - torch.cos(ts), ts], 1)
    return refs.to(device=device, dtype=dtype)


def tracking_problem(tt, dtype, device, horizon=HORIZON, ball=False):
    """The tracking unicycle of tests/test_ip_rollout.py:537-559: Q = 0.5 I,
    R = 0.1 I, Qf = 50 I, dt = 0.05, a control box of +-2, the arc as its
    per-step reference and the arc's end as its goal; with ``ball`` the
    obstacle fleet's keep-out ball (radius 0.4 at (1, 1), its row first:
    kernel 7's m5_ball0_track variant)."""
    from cddp_tpu_torch.models import Unicycle

    kw = dict(device=device, dtype=dtype)
    refs = tracking_reference(horizon, 0, dtype, device)
    obj = tt.quadratic_objective(torch.eye(3) * 0.5, torch.eye(2) * 0.1, torch.eye(3) * 50.0,
                                 refs[-1], DT, reference_states=refs, **kw)
    prob = tt.problem(Unicycle(), obj, torch.zeros(3), horizon, DT, **kw)
    prob = prob.add_constraint("ControlConstraint", tt.control_constraint(
        [-2.0, -2.0], [2.0, 2.0], **kw))
    if ball:
        prob = prob.add_constraint("BallConstraint", tt.ball_constraint(0.4, [1.0, 1.0], 1.0,
                                                                        **kw))
    return prob


def phase_tracking_ip_kernels(tt, dev):
    """Kernels 5 and 7's tracking variants against their plain versions at
    B_CHECK (phase 11): the forward trial on the tracking problem's staged
    inputs (``stage_ip_inputs``; float64 within 1e-9, float32 by the
    float64-truth rule of ``check``), and the whole solve at m = 4 and on
    m5_ball0 (the tracking problem with the obstacle fleet's ball) against
    the plain driver from cold seeds (float64: ``check_ip_solve``, the
    ball's duals and slacks at 1e-8 + 1e-8 |plain|; float32:
    ``check_ip_f32``). Returns {dtype: {kernel: max abs err}}."""
    from cddp_tpu_torch.ops.kernels import ip_rollout, mega_ipddp

    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        exact = dtype == torch.float64
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        prob = tracking_problem(tt, dtype, dev)
        opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
        p, _, _, fwd = stage_ip_inputs(tt, prob, B_CHECK, gen, opts)
        as64 = lambda ts: tuple(t.double() if t.is_floating_point() else t  # noqa: E731
                                for t in ts)
        err5 = 0.0
        for soc in (False, True):
            fc = forward_consts(p, opts, soc)
            if fc.lane.variant != "_track":
                raise AssertionError("the tracking problem's forward trial is not tracking")
            truth = None if exact else ip_rollout.ip_forward_plain(
                forward_consts(p, opts, soc, f64=True), *as64(fwd))
            err5 = max(err5, check(f"ip_forward_track slack_soc={soc}",
                                   ip_rollout._launch_forward(fc, *fwd),
                                   ip_rollout.ip_forward_plain(fc, *fwd), truth))
        print(f"[tracking {tag}] ip_forward_track max abs err {err5:.3e}")
        x0 = torch.rand(B_CHECK, 3, generator=gen, device=dev, dtype=dtype) - 0.5
        ball = tracking_problem(tt, dtype, dev, ball=True)
        for pr, variant in ((prob, "m4_track"), (ball, "m5_ball0_track")):
            if mega_ipddp.solve_variant(pr) != variant:
                raise AssertionError(f"kernel 7 variant {mega_ipddp.solve_variant(pr)}, "
                                     f"not {variant}")
        if exact:
            _, _, err7 = check_ip_solve("tracking", *ip_solve_pair(tt, prob, opts, x0), True)
            _, _, err7b = check_ip_solve("tracking with the ball",
                                         *ip_solve_pair(tt, ball, opts, x0), True,
                                         dual_rtol=1e-8)
        else:
            _, err7 = check_ip_f32(tt, dev, prob, opts, x0, label="tracking",
                                   prob64=tracking_problem(tt, torch.float64, dev))
            _, err7b = check_ip_f32(tt, dev, ball, opts, x0, label="tracking with the ball",
                                    prob64=tracking_problem(tt, torch.float64, dev, ball=True))
        results[tag] = dict(ip_forward_track=err5, ipddp_solve_track=err7,
                            ipddp_solve_track_ball=err7b)
    return results


def phase_tracking_mpc(tt, dev, smi):
    """The tracking MPC fleet (phase 11): ``make_mpc_controller`` under CLDDP
    at B_MAIN, float32, 10 iterations, ``TRACK_TICKS`` ticks, the reference
    sliding one step a tick and the plant stepping with the model's own
    discrete dynamics. Each tick must be one launch of kernel 3's tracking
    variant and give finite controls, plans and costs. Prints ms per tick
    (host clock, ending in a synchronize), solves/s and the fleet's mean
    distance to the reference's current point at the first and last tick.
    Returns (launches of the ticks, ms per tick)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log

    prob = tracking_problem(tt, torch.float32, dev)
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    init_fn, step_fn = tt.make_mpc_controller(
        prob, "CLDDP", opts, reference_fn=lambda tick: tracking_reference(
            HORIZON, tick, torch.float32, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand(B_MAIN, 3, generator=gen, device=dev) - 0.5
    state = init_fn(x)

    def distance(x, tick):
        here = tracking_reference(HORIZON, tick, torch.float32, dev)[0, :2]
        return float((x[:, :2] - here).norm(dim=-1).mean())

    dist0, ms, launches = distance(x, 0), [], {}
    for tick in range(TRACK_TICKS):
        dispatch_log.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, state, info = step_fn(state, x, tick)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = dict(dispatch_log.launches)
        if counts != {TRACKING["clddp_solve"]: 1}:
            raise AssertionError(f"MPC tick {tick} did not run as one launch of kernel 3's "
                                 f"tracking variant: {counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        for name, t in (("u_apply", u), ("U_plan", state.U_plan), ("X_plan", state.X_plan),
                        ("cost", info["cost"])):
            if not bool(t.isfinite().all()):
                raise AssertionError(f"MPC tick {tick}: non-finite {name}")
        x = prob.model.discrete_dynamics(x, u, tick * DT, DT)
        print(f"[tracking mpc] tick {tick}: {ms[-1]:.2f} ms ({B_MAIN / ms[-1] * 1e3:.1f} "
              f"solves/s), launches {counts}, statuses "
              f"{torch.bincount(info['status'].long(), minlength=4).tolist()}, mean "
              f"iterations {float(info['iterations'].double().mean()):.3f}  [{smi}]")
    if not bool(x.isfinite().all()):
        raise AssertionError("non-finite plant states")
    steady = sum(ms[1:]) / (len(ms) - 1)
    print(f"[tracking mpc] B={B_MAIN}, {TRACK_TICKS} ticks: {steady:.2f} ms a tick after the "
          f"first ({B_MAIN / steady * 1e3:.1f} solves/s), first {ms[0]:.2f} ms; mean distance "
          f"to the reference's current point {dist0:.4f} at tick 0, "
          f"{distance(x, TRACK_TICKS):.4f} at tick {TRACK_TICKS}  [{smi}]")
    return launches, ms


def phase_tracking_fleets(tt, dev, smi):
    """The tracking problem's fleets at B_MAIN, float32, through
    ``batched_solve``, each run with the launch counts zeroed just before
    it: CLDDP and IPDDP per-pass (kernels 2 and 5's tracking variants),
    IPDDP, LogDDP and MSIPDDP whole-solve (kernels 7, 9 and 8's), each
    variant launched and no goal variant of a cost kernel; finite costs.
    The IPDDP fleet is timed (host clock). Returns (launch counts of the run
    that drives each tracking variant, launch counts of the whole-solve
    runs, problem, x0)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    prob = tracking_problem(tt, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.rand(B_MAIN, 3, generator=gen, device=dev) - 0.5
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    runs = (  # solver, options, the tracking variants it must launch
        ("CLDDP", opts.replace(solve_engine="xla"), ("forward_rollout",)),
        ("IPDDP", opts.replace(solve_engine="xla"), ("ip_forward",)),
        ("IPDDP", opts, ("ipddp_solve",)),
        ("LogDDP", opts, ("logddp_solve",)),
        ("MSIPDDP", opts, ("msipddp_solve",)),
    )
    launches, default = {}, {}
    for solver, o, kernels in runs:
        dispatch_log.reset()
        sol = batched_solve(prob, x0, solver, o)
        torch.cuda.synchronize()
        counts = dict(dispatch_log.launches)
        engine = "per-pass" if o.solve_engine == "xla" else "whole-solve"
        print(f"[tracking] {solver} {engine} launches: {counts}")
        goal_forms = [k for k in TRACKING if k in counts]
        if goal_forms or not all(counts.get(TRACKING[k], 0) >= 1 for k in kernels):
            raise AssertionError(f"the {solver} {engine} tracking fleet did not run on the "
                                 f"tracking variants of {kernels} alone: {counts}")
        if not bool(sol.final_objective.isfinite().all()):
            raise AssertionError(f"non-finite costs from the {solver} {engine} tracking fleet")
        launches.update({TRACKING[k]: counts[TRACKING[k]] for k in kernels})
        if engine == "whole-solve":
            default[f"{solver} tracking fleet"] = counts
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        batched_solve(prob, x0, "IPDDP", opts)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    print(f"[tracking] IPDDP tracking fleet, whole-solve kernel: {B_MAIN / dt:.1f} solves/s "
          f"({dt * 1e3:.2f} ms per B={B_MAIN} solve, {reps} reps)  [{smi}]")
    return launches, default, prob, x0


def tracking_checks(tt, dev):
    """Phase 11's (a): every tracking variant against its plain version at
    B_CHECK. Returns {dtype: {variant: err}}."""
    errs = {"float64": {}, "float32": {}}
    for tag, r in phase_kernels(tt, dev, tracking_problem, "tracking").items():
        errs[tag].update({TRACKING[k]: r[k] for k in ("forward_rollout", "clddp_solve")})
    for tag, r in phase_tracking_ip_kernels(tt, dev).items():
        errs[tag].update(r)
    for tag, r in phase_barrier_kernels(tt, dev, tracking_problem, "tracking").items():
        errs[tag].update({TRACKING[k]: r[k] for k in ("logddp_solve", "msipddp_solve")})
    return errs


def phase_tracking(tt, dev, smi, errs):
    """Phase 11, tracking MPC: ``errs``, every tracking variant against its
    plain version at B_CHECK (``tracking_checks``, which a side process
    runs earlier), then the tracking MPC fleet, the tracking fleets that
    drive each variant, and each variant's times and bound at B_MAIN.
    Returns (launches, default-engine launches, {dtype: {variant: err}},
    {variant: timing})."""
    checked_errs("phase 11", errs)
    launches, ms = phase_tracking_mpc(tt, dev, smi)
    default = {"tracking MPC fleet": dict(launches)}
    fleet_launches, fleet_default, prob, x0 = phase_tracking_fleets(tt, dev, smi)
    launches.update(fleet_launches)
    default.update(fleet_default)
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    timing = time_clddp_kernels(prob, x0, opts, smi, names=("forward_rollout", "clddp_solve"))
    timing.update(time_ip_kernels(tt, prob, x0, smi, names=("ip_forward", "ipddp_solve")))
    timing.update(time_barrier_kernels(tt, prob, x0, smi))
    return launches, default, errs, {TRACKING[k]: v for k, v in timing.items()}


# --- IPDDP terminal constraints (phase 12) ----------------------------------------

# Kernel 7's terminal variants (launcher suffix) and their dispatch_log names.
TERMINAL = {"m4_ti1": "ipddp_solve_ti1", "m4_ti2": "ipddp_solve_ti2",
            "m4_te3": "ipddp_solve_te3", "m4_te3_ti1": "ipddp_solve_te3_ti1"}
# The two fleets of the slice: terminal inequalities, terminal equality.
TERMINAL_FLEETS = ("m4_ti2", "m4_te3")


def terminal_problem(tt, dtype, device, variant, horizon=HORIZON):
    """The IPDDP box fleet (``ip_problem``) with the terminal constraints of
    kernel 7's ``variant`` (tests/test_mega_ipddp.py:611-723): m4_ti2, the
    terminal-inequality fleet, A_T x_N <= b_T with A_T = [[1,0,0],[0,1,0]]
    and b_T = (1.9, 1.9), which binds short of the goal; m4_ti1 its first
    row; m4_te3, the terminal-equality fleet, x_N = (1.5, 1.0, pi/4); and
    m4_te3_ti1 that with theta_N <= 2."""
    kw = dict(device=device, dtype=dtype)
    prob = ip_problem(tt, dtype, device, horizon)
    if variant in ("m4_ti1", "m4_ti2"):
        rows = 1 if variant == "m4_ti1" else 2
        return prob.add_terminal_constraint("TerminalInequality", tt.terminal_inequality_constraint(
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]][:rows], [1.9, 1.9][:rows], **kw))
    prob = prob.add_terminal_constraint("TerminalEquality", tt.terminal_equality_constraint(
        [1.5, 1.0, math.pi / 4], **kw))
    if variant == "m4_te3_ti1":
        prob = prob.add_terminal_constraint("TerminalInequality",
                                            tt.terminal_inequality_constraint(
                                                [[0.0, 0.0, 1.0]], [2.0], **kw))
    return prob


def terminal_violation(prob, X):
    """Each instance's terminal violation at x_N: the sum over the terminal
    constraints of their ``violation`` (positive parts; the equality's
    norm)."""
    return sum(c.violation(X[:, -1]) for c in prob.terminal_constraints.values())


def phase_terminal_kernels(tt, dev):
    """(a) Each terminal variant of kernel 7 against the plain driver at
    B_CHECK from cold seeds (phase 12): float64 by ``check_ip_solve`` (the
    inequality variants within 1e-8, the equality ones within 1e-7, the JAX
    package's envelope for its kernel against its driver; every status and
    iteration count equal; duals, multipliers and slacks, the terminal ones
    included, within that + 1e-8 |plain|); float32 by ``check_ip_f32`` (the
    equality variants held to the plain driver's own one-ulp agreement from
    five iterations on). dispatch_log must show the variant's launch.
    Returns {dtype: {dispatch name: cost err}}."""
    from cddp_tpu_torch.ops.kernels import dispatch_log, mega_ipddp

    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=dev).manual_seed(SEED + 31)
        x0 = torch.rand(B_CHECK, 3, generator=gen, device=dev, dtype=dtype) - 0.5
        opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
        errs = {}
        for variant, name in TERMINAL.items():
            prob = terminal_problem(tt, dtype, dev, variant)
            if mega_ipddp.solve_variant(prob) != variant:
                raise AssertionError(f"kernel 7 variant {mega_ipddp.solve_variant(prob)}, "
                                     f"not {variant}")
            eq = "_te" in variant
            dispatch_log.reset()
            if dtype == torch.float64:
                _, _, errs[name] = check_ip_solve(
                    f"terminal {variant}", *ip_solve_pair(tt, prob, opts, x0), True,
                    tol=1e-7 if eq else 1e-8, dual_rtol=1e-8)
            else:
                _, errs[name] = check_ip_f32(
                    tt, dev, prob, opts, x0, label=f"terminal {variant}", early_forks=eq,
                    prob64=terminal_problem(tt, torch.float64, dev, variant))
            counts = dict(dispatch_log.launches)
            if counts.get(name, 0) < 1 or any(k.startswith("ipddp_solve") and k != name
                                               for k in counts):
                raise AssertionError(f"the {variant} checks launched {counts}: not {name} "
                                     f"alone of kernel 7's variants")
        print(f"[terminal {tag}] kernel 7's terminal variants against the plain driver: "
              + ", ".join(f"{k} cost err {v:.3e}" for k, v in errs.items()))
        results[tag] = errs
    return results


def phase_terminal_per_pass(tt, dev):
    """(b) The per-pass engine (``solve_engine="xla"``) on both fleets at
    B_CHECK, float64, against the plain driver by ``check_ip_solve``
    (1e-8): the inequality fleet launches kernels 4, 5 and 6 (the folded
    terminal value per instance), the equality fleet kernels 4 and 5 (its
    reduced LQR is plain torch, as in JAX); neither launches kernel 7."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    x0 = torch.rand(B_CHECK, 3, generator=gen, device=dev, dtype=torch.float64) - 0.5
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    for variant in TERMINAL_FLEETS:
        prob = terminal_problem(tt, torch.float64, dev, variant)
        dispatch_log.reset()
        per_pass = batched_solve(prob, x0, "IPDDP", opts.replace(solve_engine="xla"))
        counts = dict(dispatch_log.launches)
        want = {"open_loop_rollout", "ip_forward"} | (
            set() if "_te" in variant else {"ipddp_backward"})
        if set(counts) != want:
            raise AssertionError(f"the per-pass engine on {variant} launched {counts}, "
                                 f"not {sorted(want)}")
        plain = batched_solve(prob, x0, "IPDDP", plain_ip_options(tt, opts))
        check_ip_solve(f"per-pass engine, terminal {variant}", per_pass, plain, True,
                       dual_rtol=1e-8)
        print(f"[terminal float64] per-pass engine on {variant}: launches {counts}")


def time_terminal_kernel(tt, prob, x0, smi, variant, opts=None, plain_ms=None,
                         events_ok=False):
    """Kernel 7's terminal ``variant`` at B_MAIN on the fleet's cold seeds:
    wrapper and device ms, the plain driver's ms and the bound, whose
    operations are the plain version's per backward attempt (the terminal
    value fold and condensed backward, or the reduced LQR) and per sweep
    (the forward trial with the terminal rows, merit, theta and residuals)
    times this run's work, under ``opts`` (10 iterations, tolerance 1e-4
    unless given; ``plain_ms``: the plain driver's time, measured
    elsewhere). Returns (timing tuple as ``time_kernels`` gives it, work per
    instance (attempts, sweeps), attributes)."""
    from cddp_tpu_torch.constraints.stack import PathStacker, TerminalStacker
    from cddp_tpu_torch.ops.kernels import build, ip_rollout, mega_ipddp
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
    from cddp_tpu_torch.solvers import ipddp

    opts = opts or tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    plain_opts = plain_ip_options(tt, opts)
    pw, seeds = ip_seeds(prob, opts, x0)
    sol7, work = mega_ipddp.launch_counting_work(pw, opts, *seeds)

    # Operations per instance, on the plain versions at B=1.
    p1 = pw.replace(x0=pw.x0[:1])
    s1 = one(seeds)
    stk1, tstk1 = PathStacker(p1), TerminalStacker(p1)
    X, U, Y, S, G, mu1 = s1[0], s1[1], s1[2], s1[3], s1[4], s1[6]
    reg1 = torch.full_like(mu1, 1e-6)
    S_T, Y_T, lam = ipddp.initialize_terminal(p1, opts, tstk1, X, mu1)
    tm = ipddp._Terminal(G_T=tstk1.ineq_evaluate(X[:, -1]), S_T=S_T, Y_T=Y_T,
                         h_T=tstk1.eq_evaluate(X[:, -1]), Lambda_T_eq=lam)
    if tstk1.eq_dim:
        ops_back = count_ops(lambda: ipddp._backward_terminal_eq(
            p1, plain_opts, stk1, tstk1, X, U, Y, S, G, tm, mu1, reg1))
    else:
        def condensed():
            fold = ipddp._terminal_value_fold(p1, tstk1, X[:, -1], S_T, Y_T, mu1)
            return ric.ipddp_backward_plain(*ipddp.backward_inputs(
                p1, stk1, X, U, Y, S, G, mu1, reg1, terminal=fold[:2]))
        ops_back = count_ops(condensed)
    bp = ipddp._backward_condensed(p1, plain_opts, stk1, X, U, Y, S, G, mu1, reg1,
                                   terminal=(tstk1, tm))
    fc = forward_consts(p1, opts, False)
    tau = ipddp._tau(opts, mu1)
    a = torch.ones_like(mu1)
    fwd = (X[:, :-1], U, Y, S, bp.k_u, bp.K_u, bp.k_lambda[:, :-1], bp.K_lambda[:, :-1],
           s1[5][:, :-1], bp.k_y, bp.K_y, bp.k_s, bp.K_s, X[:, 0], a, a, tau,
           torch.zeros_like(mu1, dtype=torch.bool))
    out5 = ip_rollout.ip_forward_plain(fc, *fwd)
    st = dict(X=X, S_T=S_T, Y_T=Y_T, G_T=tm.G_T, Lambda_T_eq=lam, mu=mu1)
    ops_sweep = count_ops(ip_rollout.ip_forward_plain, fc, *fwd) + count_ops(
        lambda: (lambda tmn: (ipddp._barrier_merit(out5[6], out5[2], mu1, tmn),
                              ipddp._theta(opts, out5[4], out5[2], tmn),
                              ipddp._primal_comp(out5[4], out5[2], out5[3], mu1, tmn)))(
            ipddp._terminal_trial(tstk1, st, bp, out5[0][:, -1], a, a, tau)[0]))
    attempts, sweeps = (float(w.double().sum()) for w in work)
    ops7 = attempts * ops_back + sweeps * ops_sweep
    print(f"[divergence] ipddp_solve {variant} at B={B_MAIN}: {warp_divergence(work):.4f}; "
          f"operations per instance {ops7 / B_MAIN:.0f} ({attempts / B_MAIN:.3f} backward "
          f"attempts x {ops_back} + {sweeps / B_MAIN:.3f} sweeps x {ops_sweep})")
    tstk = TerminalStacker(pw)
    term_state = ipddp.initialize_terminal(pw, opts, tstk, seeds[0], seeds[6])
    ins = seeds + term_state + (mega_ipddp._terminal_consts(tstk, x0),)
    outs = (sol7.state_trajectory, sol7.control_trajectory, sol7.feedforward_gains,
            sol7.feedback_gains, sol7.costate_trajectory,
            *sol7.dual_trajectories.values(), *sol7.slack_trajectories.values(),
            *sol7.terminal_duals.values(), *sol7.terminal_slacks.values(),
            torch.empty(9, B_MAIN, device=x0.device))
    pc, sc = check_slice(pw, seeds)
    runs = {"ipddp_solve": (lambda: mega_ipddp._launch(pw, opts, *seeds), 10,
                            lambda: ipddp._drive(pc, plain_opts, *sc), 1)}
    timing = time_kernels(runs, {"ipddp_solve": (ins, outs, ops7)}, x0.dtype, smi,
                          label=f" {variant}", events_ok=events_ok,
                          plain_ms=plain_ms and {"ipddp_solve": plain_ms})["ipddp_solve"]
    model = rollout_ops.model_entry(prob.model).cuda_name
    attrs = build.kernel_attributes(f"cddp_ipddp_solve_{model}_{variant}_f32")
    return timing, (attempts / B_MAIN, sweeps / B_MAIN), attrs


def phase_terminal_fleets(tt, dev, smi):
    """(c) The main path of phase 12: each terminal variant's fleet through
    ``batched_solve`` at B_MAIN, float32, 10 iterations, the launch counts
    zeroed just before each run and read just after (one open-loop rollout
    and one launch of the variant); finite costs, residuals and states;
    the largest terminal violation among the instances that converged and
    its mean (and over all instances); for the two fleets of the slice
    (``TERMINAL_FLEETS``) ms per fleet by the host clock and solves/s. Then
    each variant's times, bound, work and attributes
    (``time_terminal_kernel``). Returns (launches {name: n}, {name: timing},
    {name: work}, {name: attributes})."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.rand(B_MAIN, 3, generator=gen, device=dev) - 0.5
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    probs = {v: terminal_problem(tt, torch.float32, dev, v) for v in TERMINAL}
    launches = {}
    for variant, name in TERMINAL.items():
        prob = probs[variant]
        dispatch_log.reset()
        sol = batched_solve(prob, x0, "IPDDP", opts)
        torch.cuda.synchronize()
        counts = dict(dispatch_log.launches)
        if counts != {"open_loop_rollout": 1, name: 1}:
            raise AssertionError(f"the {variant} fleet did not run as one open-loop rollout "
                                 f"and one launch of {name}: {counts}")
        launches[name] = counts[name]
        for what, t in (("cost", sol.final_objective), ("inf_pr", sol.inf_pr),
                        ("X", sol.state_trajectory)):
            if not bool(t.isfinite().all()):
                raise AssertionError(f"non-finite {what} from the {variant} fleet")
        viol = terminal_violation(prob, sol.state_trajectory)
        conv = (sol.status_code == 1) | (sol.status_code == 2)
        conv_txt = (f"{int(conv.sum())} converged, terminal violation max "
                    f"{float(viol[conv].max()):.3e}, mean {float(viol[conv].mean()):.3e}"
                    if bool(conv.any()) else "none converged")
        print(f"[terminal] {variant} fleet B={B_MAIN}: launches {counts}; statuses "
              f"{torch.bincount(sol.status_code.long(), minlength=4).tolist()}; {conv_txt}; "
              f"over all instances max {float(viol.max()):.3e}, mean {float(viol.mean()):.3e}; "
              f"mean cost {float(sol.final_objective.mean()):.4f}")
    for variant in TERMINAL_FLEETS:
        reps = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            batched_solve(probs[variant], x0, "IPDDP", opts)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        print(f"[terminal] {variant} fleet, whole-solve kernel: {dt * 1e3:.2f} ms per "
              f"B={B_MAIN} solve ({B_MAIN / dt:.1f} solves/s, {reps} reps)  [{smi}]")
    timing, work, attrs = {}, {}, {}
    for variant, name in TERMINAL.items():
        timing[name], work[name], attrs[name] = time_terminal_kernel(
            tt, probs[variant], x0, smi, variant)
        print(f"[terminal] {name}: {work[name][0]:.3f} backward attempts and "
              f"{work[name][1]:.3f} sweeps per instance; attributes {attrs[name]}  [{smi}]")
    return launches, timing, work, attrs


def terminal_checks(tt, dev):
    """Phase 12's (a) and (b); returns (a)'s {dtype: errs}."""
    errs = phase_terminal_kernels(tt, dev)
    phase_terminal_per_pass(tt, dev)
    return errs


def phase_terminal(tt, dev, smi, errs):
    """Phase 12, terminal constraints: (a) kernel 7's terminal variants
    against the plain driver and (b) the per-pass engine on both fleets
    (``terminal_checks``, which ``run`` takes earlier: ``errs`` is (a)'s),
    (c) the fleets at B_MAIN. Returns (launches, {dtype: errs}, timing,
    work, attributes)."""
    errs = checked_errs("phase 12", errs)
    launches, timing, work, attrs = phase_terminal_fleets(tt, dev, smi)
    return launches, errs, timing, work, attrs


# --- warm starts (phase 13) ----------------------------------------------------------

WARM_TICKS = 5


def tick(tt, solver, prob, opts, x0):
    """A cold solve of the fleet from x0 by the default engine, then one MPC
    tick: (x1 = X[:, 1], the state plan and the control plan shifted one
    step, the solve's solver state: ``return_state`` for IPDDP and MSIPDDP,
    the gains (k, K) for LogDDP)."""
    p = prob.replace(x0=x0)
    if solver == "LogDDP":
        sol = tt.solve(p, solver, opts)
        st = (sol.feedforward_gains, sol.feedback_gains)
    else:
        sol, st = tt.solve(p, solver, opts, return_state=True)
    X, U = sol.state_trajectory, sol.control_trajectory
    shift = lambda T: torch.cat([T[:, 1:], T[:, -1:]], 1)  # noqa: E731
    return X[:, 1].clone(), shift(X), shift(U), st


def ip_warm_seeds(state, U_plan):
    """A seeds function (``seeded``) of IPDDP's warm start: for x1, the
    seeds ``ipddp.warm_start`` builds from ``state`` and the controls
    ``U_plan``, each cast to x1's type, under the options' warm-start
    fields; with ``state`` None the trajectory warm start from ``U_plan``
    (``ipddp._initialize`` with ``trajectory_warm``: mu0 tiered per
    instance)."""

    def seeds(prob, opts, x1):
        from cddp_tpu_torch.constraints.stack import PathStacker, TerminalStacker
        from cddp_tpu_torch.solvers import ipddp

        p = prob.replace(x0=x1)
        stk, tstk = PathStacker(p), TerminalStacker(p)
        U = U_plan.to(x1.dtype)
        if state is None:
            X, U, Y, S, G, L, mu0 = ipddp._initialize(p, opts, stk, U, True, tstk)
            term = ipddp.initialize_terminal(p, opts, tstk, X, mu0)
            k, K = torch.zeros_like(U), U.new_zeros(U.shape + (p.state_dim,))
        else:
            st = ipddp.IPDDPSolverState(*(t.to(x1.dtype) for t in state))
            X, U, Y, S, G, L, mu0, term, k, K = ipddp.warm_start(p, opts, stk, tstk, U, st)
        return p, (X, U, Y, S, G, L, mu0, k, K), term

    return seeds


def ms_warm_seeds(state, X_plan, U_plan):
    """A seeds function (``barrier_pair``) of MSIPDDP's warm start: the
    state plan with row 0 set to x0 (its shooting nodes carry the tick's
    defects), the control plan, and ``msipddp.warm_start`` from ``state``;
    the state's gains."""

    def seeds(p, opts):
        from cddp_tpu_torch.constraints.stack import PathStacker
        from cddp_tpu_torch.solvers import msipddp

        dt = p.x0.dtype
        X = X_plan.to(dt).clone()
        X[:, 0] = p.x0
        st = msipddp.MSIPDDPSolverState(*(t.to(dt) for t in state))
        return msipddp.warm_start(p, opts, PathStacker(p), X, U_plan.to(dt), st) + (
            st.k_u, st.K_u)

    return seeds


def log_warm_seeds(U_plan, gains):
    """A seeds function (``barrier_pair``) of LogDDP's warm gains: X rolled
    open-loop from the control plan by the plain version, and the gains."""

    def seeds(p, opts):
        from cddp_tpu_torch.ops.kernels import ip_rollout

        U = U_plan.to(p.x0.dtype)
        X = ip_rollout.open_loop_rollout_plain(p.model, p.x0, U, p.timestep)
        return (X, U) + tuple(g.to(p.x0.dtype) for g in gains)

    return seeds


def warm_ip_check(tt, label, prob, opts, x1, seeds_fn, tol=1e-8, dual_rtol=0.0):
    """Kernel 7 against the plain driver from one warm seed in float64
    (``check_ip_solve``'s exact rule); also their gains within ``tol``.
    Returns (status counts, max abs cost err)."""
    kern, plain = ip_solve_pair(tt, prob, opts.replace(warm_start=True), x1, seeds_fn)
    counts, _, err = check_ip_solve(f"warm {label}", kern, plain, True, tol=tol,
                                    dual_rtol=dual_rtol)
    for name, a, b in (("k", kern.feedforward_gains, plain.feedforward_gains),
                       ("K", kern.feedback_gains, plain.feedback_gains)):
        e = float(abs_err(a, b).max())
        if not e <= tol:
            raise AssertionError(f"ipddp_solve f64 warm {label}: gains {name} max abs err {e}")
    return counts, err


def phase_warm_kernels(tt, dev):
    """Phase 13 (a): kernels 7, 8 and 9 against their plain drivers from warm
    seeds at B_CHECK. Each seed is a cold solve of the fleet (the default
    engine, 10 iterations) and one tick: x0 advanced one step and the plans
    shifted. Float64, exactly (``check_ip_solve``; kernel 7's gains too):
    kernel 7 on its m4, m4_track, m5_ball0, m4_ti2 and m4_te3 variants (te3
    at 1e-7), and on the box fleet from a state whose stale steps are
    re-initialised, with the interior repair, with an x0-drift reset that
    splits the batch, at the regularization limit with nonzero gains, and
    from the three trajectory-warm mu tiers; kernel 8 on the box and
    tracking fleets over MS_EXACT_ITERS iterations (ties allowed on
    MS_TIE_SHARE; the box fleet's over MS_WARM_EXACT_ITERS, and at
    MS_WARM_SELF_ITERS against the plain driver's self-agreement), kernel 9
    with warm gains at 10. Float32: kernels 7 and 8
    on the box and tracking fleets and kernel 9 on the box fleet by
    ``check_ip_f32`` and ``check_barrier_f32``; from the box fleet's warm
    seeds the IPDDP and MSIPDDP plain drivers fork from themselves one ulp
    up within the short budget (on the CPU at B=256-512: 60.5% agree at five
    iterations, 71.9% at four), so those two are held there to that floor
    (``early_forks``). Returns {dtype: {kernel: max abs cost err}}."""
    errs = {"float64": {}, "float32": {}}

    def note(tag, name, err):
        errs[tag][name] = max(errs[tag].get(name, 0.0), err)

    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        x0 = torch.rand(B_CHECK, 3, generator=gen, device=dev, dtype=dtype) - 0.5
        fleets = {"m4": ip_problem(tt, dtype, dev), "m4_track": tracking_problem(tt, dtype, dev)}
        if dtype == torch.float64:
            fleets.update(m5_ball0=obstacle_problem(tt, dtype, dev),
                          m4_ti2=terminal_problem(tt, dtype, dev, "m4_ti2"),
                          m4_te3=terminal_problem(tt, dtype, dev, "m4_te3"))
        ticks = {}
        for label, prob in fleets.items():
            x1, _, U1, st = ticks[label] = tick(tt, "IPDDP", prob, opts, x0)
            if dtype == torch.float32:
                prob64 = (ip_problem if label == "m4" else tracking_problem)(tt, torch.float64,
                                                                             dev)
                share, err = check_ip_f32(tt, dev, prob, opts.replace(warm_start=True), x1,
                                          prob64, f"warm {label}", early_forks=label == "m4",
                                          seeds_fn=ip_warm_seeds(st, U1))
                note(tag, "ipddp_solve", err)
                continue
            _, err = warm_ip_check(tt, label, prob, opts, x1, ip_warm_seeds(st, U1),
                                   tol=1e-7 if label == "m4_te3" else 1e-8,
                                   dual_rtol=1e-8 if label == "m5_ball0" else 0.0)
            note(tag, "ipddp_solve", err)
        if dtype == torch.float64:
            phase_warm_branches(tt, dev, opts, fleets["m4"], ticks["m4"], note)
        for solver, name in (("MSIPDDP", "msipddp_solve"), ("LogDDP", "logddp_solve")):
            for label in ("m4", "m4_track") if solver == "MSIPDDP" else ("m4",):
                prob = fleets[label]
                x1, X1, U1, st = tick(tt, solver, prob, opts, x0)
                seeds_fn = (ms_warm_seeds(st, X1, U1) if solver == "MSIPDDP"
                            else log_warm_seeds(U1, st))
                if dtype == torch.float32:
                    share, err = check_barrier_f32(solver, prob, opts, x1, f"warm {label}",
                                                   seeds_fn, early_forks=label == "m4")
                elif solver == "MSIPDDP":
                    its = MS_WARM_EXACT_ITERS if label == "m4" else MS_EXACT_ITERS
                    _, share, err = check_barrier(
                        solver, f"warm {label}, {its} iterations",
                        *barrier_pair(solver, prob, opts.replace(max_iterations=its), x1,
                                      seeds_fn=seeds_fn), True, min_share=1.0 - MS_TIE_SHARE)
                    if label == "m4":
                        check_against_self(solver, f"warm {label}, {MS_WARM_SELF_ITERS} "
                                           f"iterations", prob,
                                           opts.replace(max_iterations=MS_WARM_SELF_ITERS),
                                           x1, True, seeds_fn)
                else:
                    _, share, err = check_barrier(
                        solver, f"warm {label}", *barrier_pair(solver, prob, opts, x1,
                                                              seeds_fn=seeds_fn), True)
                note(tag, name, err)
    return errs


def phase_warm_branches(tt, dev, opts, prob, box_tick, note):
    """Float64 cases of kernel 7 from warm seeds on the box fleet that take
    the warm start's other branches; each asserts its branch was reached."""
    from cddp_tpu_torch.options import RegularizationOptions

    x1, _, U1, st = box_tick
    ip = tt.IPDDPOptions
    gen = torch.Generator(device=dev).manual_seed(SEED + 131)

    def reached(label, seeds_fn, o, x, count):
        p, seeds, _ = seeds_fn(prob, o.replace(warm_start=True), x)
        n = int(count(p, seeds))
        print(f"[warm] {label}: {n} of {x.shape[0]} instances take the branch")
        if not 0 < n:
            raise AssertionError(f"warm {label}: no instance takes the branch")

    # Stale steps: y <= EPS_DUAL on one row of every fourth step of a third
    # of the instances re-initialises those whole steps.
    Y = st.Y.clone()
    Y[::3, ::4, 0] = 0.0
    stale = st._replace(Y=Y)
    reached("stale steps", ip_warm_seeds(stale, U1), opts, x1,
            lambda p, s: ((s[2] != Y).any(-1).any(-1)).sum())
    note("float64", "ipddp_solve", warm_ip_check(tt, "stale steps", prob, opts, x1,
                                                 ip_warm_seeds(stale, U1))[1])
    # The interior repair on slacks and duals hugging their floors.
    S, Y = st.S.clone(), st.Y.clone()
    S[::2, ::5, 1], Y[1::2, ::7, 2] = 1e-9, 2e-5
    hug = st._replace(S=S, Y=Y)
    o = opts.replace(ipddp=ip(warmstart_repair=True, warmstart_staleness_check=False))
    reached("interior repair", ip_warm_seeds(hug, U1), o, x1,
            lambda p, s: ((s[3] != S) | (s[2] != Y)).flatten(1).any(-1).sum())
    note("float64", "ipddp_solve", warm_ip_check(tt, "interior repair", prob, o, x1,
                                                 ip_warm_seeds(hug, U1))[1])
    # The x0-drift reset on half of the batch.
    xr = x1.clone()
    xr[::2, 0] += 0.9
    o = opts.replace(ipddp=ip(warmstart_reset_x0_threshold=0.5))
    reached("x0-drift reset", ip_warm_seeds(st, U1), o, xr,
            lambda p, s: (torch.linalg.vector_norm(p.x0 - st.x0, dim=-1) > 0.5).sum())
    note("float64", "ipddp_solve", warm_ip_check(tt, "x0-drift reset", prob, o, xr,
                                                 ip_warm_seeds(st, U1))[1])
    # Nonzero gains at the regularization limit (an indefinite R): every
    # backward attempt of the first iteration fails.
    limit = ip_problem(tt, torch.float64, dev, horizon=8)
    limit = limit.replace(objective=limit.objective.replace(
        R=-5.0 * torch.eye(2, device=dev, dtype=torch.float64)))
    lo = tt.CDDPOptions(max_iterations=4, regularization=RegularizationOptions(
        initial_value=1e-6, update_factor=10.0, max_value=1e-2))
    xl, _, Ul, stl = tick(tt, "IPDDP", limit, lo, x1)
    stl = stl._replace(
        k_u=0.05 * torch.randn(stl.k_u.shape, generator=gen, device=dev, dtype=torch.float64),
        K_u=0.05 * torch.randn(stl.K_u.shape, generator=gen, device=dev, dtype=torch.float64))
    counts, err = warm_ip_check(tt, "regularization limit, nonzero gains", limit, lo, xl,
                                ip_warm_seeds(stl, Ul))
    if counts[3] != xl.shape[0]:
        raise AssertionError(f"warm regularization limit: statuses {counts}, not all 3")
    note("float64", "ipddp_solve", err)
    # The three trajectory-warm mu tiers, a third of the batch each: the
    # plan clipped inside the box, 0.05 outside it, 0.5 outside it.
    U = torch.clamp(U1, -1.9, 1.9)
    U[1::3, :, 0], U[2::3, :, 0] = 2.05, 2.5
    # (the count: the instances of the smallest of the three tiers)
    reached("trajectory-warm tiers", ip_warm_seeds(None, U), opts, x1,
            lambda p, s: (torch.unique(s[6], return_counts=True)[1].min()
                          if torch.unique(s[6]).numel() == 3 else 0))
    note("float64", "ipddp_solve", warm_ip_check(tt, "trajectory-warm mu tiers", prob, opts,
                                                 x1, ip_warm_seeds(None, U))[1])


class count_work:
    """Within the ``with`` block, each launch of the whole-solve kernel of
    ``mega`` (``mega_ipddp`` or ``mega_msipddp``) goes through its
    ``launch_counting_work``, the same launch with its work rows returned,
    timed by CUDA events around the wrapper. Indexing the block's value
    gives a launch's (wrapper ms, mean work per instance by row, warp
    divergence of the work): backward attempts and sweeps (kernel 7);
    attempts, trials, commits and nominal resets (kernel 8)."""

    def __init__(self, mega):
        self.mega, self.records = mega, []

    def __enter__(self):
        self.launch = self.mega._launch

        def counted(*args, **kw):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.mega.launch_counting_work(*args, **kw)
            stop.record()
            self.records.append((start, stop, out[-1]))
            return out[0] if len(out) == 2 else out[:2]

        self.mega._launch = counted
        return self

    def __exit__(self, *exc):
        self.mega._launch = self.launch

    def __getitem__(self, i):
        """(wrapper ms, mean work per instance by row, warp divergence)."""
        start, stop, rows = self.records[i]
        torch.cuda.synchronize()
        return (start.elapsed_time(stop), [round(float(r.double().mean()), 3) for r in rows],
                warp_divergence(rows))


def phase_warm_mpc(tt, dev, smi):
    """Phase 13 (b): the warm MPC fleet. Phase 11's tracking problem and
    reference under IPDDP and under MSIPDDP, ``make_mpc_controller(...,
    warm_start_solver_state=True)`` and again with False, at B_MAIN,
    float32, 10 iterations, ``WARM_TICKS`` ticks each, the launch counts
    zeroed before every tick: each tick one launch of the solver's tracking
    whole-solve kernel (kernel 7 or 8), and for IPDDP one open-loop rollout
    (the warm start re-rolls X from the plan; the warm MSIPDDP tick takes the
    plan as its shooting nodes, the cold one re-rolls it); finite controls,
    plans and costs. Prints ms a tick (host clock, ending in a synchronize),
    mean iterations, status counts and the mean distance to the reference.
    Each tick's whole-solve launch is the one its controller makes, run
    through the kernel's ``launch_counting_work`` (``count_work``) so that
    the tick also prints the wrapper's ms (CUDA events) and the mean work
    per instance. Then one LogDDP solve of the box fleet with warm gains
    (kernel 9). Returns ({kernel: launches in the warm runs}, {run: ms per
    tick}, {run: mean iterations per tick})."""
    from cddp_tpu_torch.ops.kernels import dispatch_log, mega_ipddp, mega_msipddp

    prob = tracking_problem(tt, torch.float32, dev)
    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x_start = torch.rand(B_MAIN, 3, generator=gen, device=dev) - 0.5

    def distance(x, tick):
        here = tracking_reference(HORIZON, tick, torch.float32, dev)[0, :2]
        return float((x[:, :2] - here).norm(dim=-1).mean())

    launches, ms_runs, its_runs = {}, {}, {}
    for solver, kernel in (("IPDDP", "ipddp_solve_track"), ("MSIPDDP", "msipddp_solve_track")):
        for warm in (True, False):
            run = f"{solver} {'warm' if warm else 'cold'}"
            init_fn, step_fn = tt.make_mpc_controller(
                prob, solver, opts, reference_fn=lambda tick: tracking_reference(
                    HORIZON, tick, torch.float32, dev), warm_start_solver_state=warm)
            x = x_start.clone()
            state = init_fn(x)
            ms, its = [], []
            for k in range(WARM_TICKS):
                dispatch_log.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with count_work(mega_ipddp if solver == "IPDDP" else mega_msipddp) as work:
                    u, state, info = step_fn(state, x, k)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                counts = dict(dispatch_log.launches)
                want = {kernel: 1}
                if solver == "IPDDP" or not warm:
                    want["open_loop_rollout"] = 1
                if counts != want:
                    raise AssertionError(f"{run} MPC tick {k}: launches {counts}, not {want}")
                if warm:
                    for name, v in counts.items():
                        launches[name] = launches.get(name, 0) + v
                mpc = state[0] if warm else state
                for name, t in (("u_apply", u), ("U_plan", mpc.U_plan), ("X_plan", mpc.X_plan),
                                ("cost", info["cost"])):
                    if not bool(t.isfinite().all()):
                        raise AssertionError(f"{run} MPC tick {k}: non-finite {name}")
                its.append(float(info["iterations"].double().mean()))
                x = prob.model.discrete_dynamics(x, u, k * DT, DT)
                kernel_ms, rows, div = work[0]
                print(f"[warm mpc] {run} tick {k}: {ms[-1]:.2f} ms ({B_MAIN / ms[-1] * 1e3:.1f} "
                      f"solves/s; the kernel's wrapper {kernel_ms:.2f} ms, mean work per "
                      f"instance {rows}, warp divergence {div:.3f}), mean iterations "
                      f"{its[-1]:.3f}, statuses "
                      f"{torch.bincount(info['status'].long(), minlength=4).tolist()}, "
                      f"launches {counts}, mean distance to the reference "
                      f"{distance(x, k + 1):.4f}  [{smi}]")
            if not bool(x.isfinite().all()):
                raise AssertionError(f"{run}: non-finite plant states")
            ms_runs[run], its_runs[run] = ms, its
            steady = sum(ms[1:]) / (len(ms) - 1)
            print(f"[warm mpc] {run}, B={B_MAIN}, {WARM_TICKS} ticks: {steady:.2f} ms a tick "
                  f"after the first, first {ms[0]:.2f}; mean iterations a tick "
                  f"{sum(its) / len(its):.3f}; mean distance to the reference "
                  f"{distance(x, WARM_TICKS):.4f} at the end  [{smi}]")
    # LogDDP's warm gains on the box fleet (kernel 9 from warm gains).
    box = ip_problem(tt, torch.float32, dev)
    _, _, U1, gains = tick(tt, "LogDDP", box, opts, x_start)
    dispatch_log.reset()
    sol = tt.solve(box.replace(x0=x_start), "LogDDP", opts.replace(warm_start=True), U0=U1,
                   gains=gains)
    torch.cuda.synchronize()
    counts = dict(dispatch_log.launches)
    if counts.get("logddp_solve", 0) != 1 or not bool(sol.final_objective.isfinite().all()):
        raise AssertionError(f"the warm-gains LogDDP fleet: launches {counts}, or non-finite "
                             f"costs")
    launches["logddp_solve"] = counts["logddp_solve"]
    print(f"[warm mpc] LogDDP box fleet from warm gains: launches {counts}, mean iterations "
          f"{float(sol.iterations_completed.double().mean()):.3f}")
    return launches, ms_runs, its_runs


def phase_certified_fleet(tt, dev, smi):
    """Phase 13 (c): the certified fleet (``bench_fleet_polish.py``'s
    configuration, ``_problem`` :27-43: the IPDDP box fleet, H = 20): the
    float32 fleet at B_MAIN, 20 iterations, tolerance 1e-4, through
    ``batched_solve``, then ``tt.polish(..., tolerance=1e-4)`` in float64 on
    the card, with the launch counts zeroed before it. Prints the path the
    polish took (dual-warm when every instance converged, else
    trajectory-seeded), the certified fraction, the mean iterations after
    the polish, the fleet's and the polish's seconds (host clock, ending in
    a synchronize), the pre-polish relative cost error's p50, p99 and max
    against the polished cost, and kernel 7's float64 launches. Returns
    (launches of the polish, summary)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    prob32, prob64 = ip_problem(tt, torch.float32, dev), ip_problem(tt, torch.float64, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.rand(B_MAIN, 3, generator=gen, device=dev) - 0.5
    opts = tt.CDDPOptions(max_iterations=20, tolerance=1e-4)
    batched_solve(prob32, x0, "IPDDP", opts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol32 = batched_solve(prob32, x0, "IPDDP", opts)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    # The polish's gate (refine.py): an IPDDP fleet dual-warms when every
    # instance converged.
    path = "dual-warm" if bool(sol32.converged_mask().all()) else "trajectory-seeded"
    dispatch_log.reset()
    t0 = time.perf_counter()
    out = tt.polish(prob64, sol32, tolerance=1e-4)
    torch.cuda.synchronize()
    polish_s = time.perf_counter() - t0
    counts = dict(dispatch_log.launches)
    if counts.get("ipddp_solve", 0) != 1 or out.final_objective.dtype != torch.float64:
        raise AssertionError(f"the polish did not run as one float64 launch of kernel 7: "
                             f"{counts}")
    if not bool(out.final_objective.isfinite().all()):
        raise AssertionError("non-finite polished costs")
    c32, c64 = sol32.final_objective.double(), out.final_objective
    rel = (c32 - c64).abs() / torch.clamp(c64.abs(), min=1e-9)
    q = torch.quantile(rel, torch.tensor([0.5, 0.99], dtype=torch.float64, device=dev))
    summary = dict(path=path, converged_f32=float(sol32.converged_mask().double().mean()),
                   certified=float(out.converged_mask().double().mean()),
                   mean_iterations=float(out.iterations_completed.double().mean()),
                   fleet_s=fleet_s, polish_s=polish_s, rel_p50=float(q[0]),
                   rel_p99=float(q[1]), rel_max=float(rel.max()),
                   inf_pr_max=float(out.inf_pr.max()), inf_du_max=float(out.inf_du.max()),
                   launches=counts)
    print(f"[certified] B={B_MAIN}: float32 fleet {fleet_s:.4f} s (converged "
          f"{summary['converged_f32']:.4%}); polish ({path}) in float64 {polish_s:.4f} s, "
          f"certified {summary['certified']:.4%}, mean iterations "
          f"{summary['mean_iterations']:.3f}, statuses "
          f"{torch.bincount(out.status_code.long(), minlength=5).tolist()}, max inf_pr "
          f"{summary['inf_pr_max']:.3e}, max inf_du {summary['inf_du_max']:.3e}; pre-polish "
          f"relative cost error p50 {summary['rel_p50']:.3e}, p99 {summary['rel_p99']:.3e}, "
          f"max {summary['rel_max']:.3e}; kernel 7 float64 launches {counts}  [{smi}]")
    return counts, summary


def seed_ipddp_work(tt, p, opts, seeds):
    """Kernel 7's (inputs, outputs, operations) on ``seeds`` (cold or warm)
    for its bound (``ipddp_solve_work``), its forward trial's operations counted on
    a trial at B=1 from the first instance's seeds with zero gains (the
    count reads shapes, not values)."""
    from cddp_tpu_torch.ops.kernels import ip_rollout

    fc = forward_consts(p, opts, False)
    X, U, Y, S, _, L = one(seeds)[:6]
    N, nu, nx, m = U.shape[1], U.shape[2], X.shape[2], Y.shape[2]
    z = lambda *shape: X.new_zeros(1, *shape)  # noqa: E731
    one_ = X.new_ones(1)
    fwd1 = (X[:, :-1], U, Y, S, z(N, nu), z(N, nu, nx), z(N, nx), z(N, nx, nx), L[:, :-1],
            z(N, m), z(N, m, nx), z(N, m), z(N, m, nx), X[:, 0], one_, one_, 0.99 * one_,
            torch.zeros(1, dtype=torch.bool, device=X.device))
    ops5 = count_ops_steps(ip_rollout.ip_forward_plain, fc, *fwd1)
    out5 = ip_rollout.ip_forward_plain(fc, *fwd1)
    return ipddp_solve_work(tt, p, opts, seeds, ops5, out5, reference_read(p))


def time_warm_kernels(tt, dev, smi):
    """Device ms of kernels 7 and 8 on the warm MPC fleet's tick-1 seeds
    (the tracking problem at B_MAIN, float32: a cold solve and one tick) and
    of kernel 9 from warm gains on the box fleet, each by the profiler
    (``device_ms``) after a CUDA-event warm-up, and each one's bound from
    those seeds and one counted launch's work (``seed_ipddp_work``,
    ``msipddp_solve_work``, ``logddp_solve_work``). Returns {kernel: (ms
    with the wrapper, device ms, source, bound ms, bound by)}."""
    from cddp_tpu_torch.ops.kernels import mega_ipddp, mega_logddp, mega_msipddp

    opts = tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    wopts = opts.replace(warm_start=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.rand(B_MAIN, 3, generator=gen, device=dev) - 0.5
    prob = tracking_problem(tt, torch.float32, dev)
    box = ip_problem(tt, torch.float32, dev)
    out = {}
    x1, _, U1, st = tick(tt, "IPDDP", prob, opts, x0)
    p, seeds, term = ip_warm_seeds(st, U1)(prob, wopts, x1)
    runs = {"ipddp_solve": lambda: mega_ipddp._launch(p, opts, *seeds, terminal=term)}
    work = {"ipddp_solve": lambda: seed_ipddp_work(tt, p, opts, seeds)}
    x1m, X1m, U1m, stm = tick(tt, "MSIPDDP", prob, opts, x0)
    pm = prob.replace(x0=x1m)
    seeds_m = ms_warm_seeds(stm, X1m, U1m)(pm, wopts)
    runs["msipddp_solve"] = lambda: mega_msipddp._launch(pm, opts, *seeds_m)
    work["msipddp_solve"] = lambda: msipddp_solve_work(tt, pm, opts, seeds_m)
    x1l, _, U1l, gains = tick(tt, "LogDDP", box, opts, x0)
    pl = box.replace(x0=x1l)
    seeds_l = log_warm_seeds(U1l, gains)(pl, wopts)
    runs["logddp_solve"] = lambda: mega_logddp._launch(pl, opts, *seeds_l)
    work["logddp_solve"] = lambda: logddp_solve_work(tt, pl, opts, seeds_l)
    for name, fn in runs.items():
        ms = cuda_ms(fn, 5)
        dev_ms, source = device_ms(fn, name, 3)
        ins, outs, ops = work[name]()
        nbytes = unique_bytes(ins) + unique_bytes(outs)
        b_ms, b_by = bound(nbytes, ops, torch.float32)
        out[name] = (ms, dev_ms, source, b_ms, b_by)
        print(f"[timing] {name} from warm seeds at B={B_MAIN}: {ms:.3f} ms with the wrapper, "
              f"{dev_ms:.3f} ms device ({source}), bound {b_ms:.4f} ms by {b_by} "
              f"({nbytes / 1e9:.3f} GB, {ops / 1e9:.3f} G operations)  [{smi}]")
    return out


def phase_warm(tt, dev, smi, errs):
    """Phase 13, warm starts: (a) ``phase_warm_kernels`` (which ``run``
    takes earlier: ``errs`` is its result), (b) ``phase_warm_mpc``, (c)
    ``phase_certified_fleet``, and the warm kernels' device times. Returns
    ({kernel: warm entry}, certified summary)."""
    errs = checked_errs("phase 13", errs)
    launches, ms_runs, its_runs = phase_warm_mpc(tt, dev, smi)
    polish_launches, summary = phase_certified_fleet(tt, dev, smi)
    timing = time_warm_kernels(tt, dev, smi)
    entries = {}
    for name in ("ipddp_solve", "msipddp_solve", "logddp_solve"):
        ms, dev_ms, source, b_ms, b_by = timing[name]
        key = name + ("_track" if name != "logddp_solve" else "")
        entries[name] = {"launches": launches.get(key, 0), "ms": ms, "device_ms": dev_ms,
                         "device_ms_source": source, "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": errs["float32"].get(name),
                         "max_abs_err_f64": errs["float64"].get(name)}
    entries["ipddp_solve"]["polish_f64_launches"] = polish_launches.get("ipddp_solve", 0)
    for name, solver in (("ipddp_solve", "IPDDP"), ("msipddp_solve", "MSIPDDP")):
        entries[name]["mpc_ms"] = {k: v for k, v in ms_runs.items() if k.split()[0] == solver}
        entries[name]["mpc_iterations"] = {k: v for k, v in its_runs.items()
                                           if k.split()[0] == solver}
    return entries, summary


# --- the pendulum, the cart-pole and HCW (phase 14) ---------------------------------

# Iterations of (a)'s whole-solve checks, by model, and of the tracking
# forms' checks and of the runs that drive the other instantiations. On
# the long horizons each plain-driver run takes seconds (the cart-pole's
# 5.7-9.4 s at ten iterations): at ten the whole script took 960.7 s on one
# card and 1193.7 s on another of its 1200 s (PERF.md), so (a) holds
# the goal forms over five iterations, the cart-pole's over three.
ZOO_ITERS = {"pendulum": 5, "cartpole": 3, "hcw": 5}
ZOO_TRACK_ITERS = 2
ZOO_RTOL = 1e-12  # ``check``'s float64 relative term for kernels 1, 2, 4, 5 and 6
# Phase 14's kernels, each an entry of the kernels' JSON line: (entry name,
# dispatch_log name, kernel, model, launcher without its type suffix).
# Kernels 1 and 6 are keyed by shape, so they log it; the entries name the
# model.
ZOO_ENTRIES = tuple(
    (name, logged or name, name.split("@")[0].replace("_track", "").replace("_te6", ""),
     name.split("@")[1], launcher)
    for name, logged, launcher in (
        ("riccati_backward@pendulum", "riccati_backward@2x1", "cddp_riccati_backward_2x1"),
        ("riccati_backward@cartpole", "riccati_backward@4x1", "cddp_riccati_backward_4x1"),
        ("forward_rollout@pendulum", None, "cddp_forward_rollout_pendulum"),
        ("forward_rollout_track@pendulum", None, "cddp_forward_rollout_pendulum_track"),
        ("forward_rollout@cartpole", None, "cddp_forward_rollout_cartpole"),
        ("forward_rollout_track@cartpole", None, "cddp_forward_rollout_cartpole_track"),
        ("clddp_solve@pendulum", None, "cddp_clddp_solve_pendulum"),
        ("clddp_solve_track@pendulum", None, "cddp_clddp_solve_pendulum_track"),
        ("clddp_solve@cartpole", None, "cddp_clddp_solve_cartpole"),
        ("clddp_solve_track@cartpole", None, "cddp_clddp_solve_cartpole_track"),
        ("open_loop_rollout@pendulum", None, "cddp_open_loop_rollout_pendulum"),
        ("open_loop_rollout@cartpole", None, "cddp_open_loop_rollout_cartpole"),
        ("open_loop_rollout@hcw", None, "cddp_open_loop_rollout_hcw"),
        ("ip_forward@pendulum", None, "cddp_ip_forward_pendulum_m2"),
        ("ip_forward_track@pendulum", None, "cddp_ip_forward_pendulum_m2_track"),
        ("ip_forward@hcw", None, "cddp_ip_forward_hcw_m6"),
        ("ip_forward_track@hcw", None, "cddp_ip_forward_hcw_m6_track"),
        ("ipddp_backward@pendulum", "ipddp_backward@2x1x2", "cddp_ipddp_backward_2x1x2"),
        ("ipddp_solve@pendulum", None, "cddp_ipddp_solve_pendulum_m2"),
        ("ipddp_solve_track@pendulum", None, "cddp_ipddp_solve_pendulum_m2_track"),
        ("ipddp_solve_te6@hcw", None, "cddp_ipddp_solve_hcw_m6_te6"),
        ("msipddp_solve@pendulum", None, "cddp_msipddp_solve_pendulum_m2"),
        ("msipddp_solve_track@pendulum", None, "cddp_msipddp_solve_pendulum_m2_track"),
        ("logddp_solve@pendulum", None, "cddp_logddp_solve_pendulum_m2"),
        ("logddp_solve_track@pendulum", None, "cddp_logddp_solve_pendulum_m2_track"),
    ))


def zoo_problem(tt, dtype, device, model, tracking=False, terminal=True):
    """Phase 14's fleets. "pendulum": the pendulum goldens' problem
    (tests/make_goldens.py:50-56; N = 100, dt = 0.02, Q = 0, R = 0.1, Qf =
    100 I, the box +-20, x0 = (pi, 0)); "cartpole": the cart-pole golden's
    (make_goldens.py:58-67; N = 200, dt = 0.02, the box +-100, the goal
    (0, pi, 0, 0)); "hcw": the JAX rendezvous bench's
    (bench_ipddp_fleet.py:56-82; HCW, N = 20, dt = 30, Q = 1e-4 I, R = 1e-2
    I, Qf = I, the box +-0.004, x0 = (10, 5, 2, 0, 0, 0)) with the terminal
    equality x_N = 0 when ``terminal``. ``tracking``: the straight line from
    x0 to the goal as the per-step reference (the pendulum's Q = I, so that
    it counts), no terminal constraint."""
    from cddp_tpu_torch.models import HCW, CartPole, Pendulum

    kw = dict(device=device, dtype=dtype)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    eye = lambda n, v: v * torch.eye(n, dtype=torch.float64)  # noqa: E731
    if model == "pendulum":
        m, N, dt, box = Pendulum(length=0.5, damping=0.01), 100, 0.02, [20.0]
        x0, goal = [math.pi, 0.0], [0.0, 0.0]
        Q, R, Qf = eye(2, 1.0 if tracking else 0.0), eye(1, 0.1), eye(2, 100.0)
    elif model == "cartpole":
        m, N, dt, box = CartPole(), 200, 0.02, [100.0]
        x0, goal = [0.0] * 4, [0.0, math.pi, 0.0, 0.0]
        Q, R, Qf = f64([0.1, 1.0, 0.1, 0.1]).diag(), eye(1, 0.05), f64([100.0, 500.0, 10.0,
                                                                          10.0]).diag()
    else:
        m, N, dt, box = HCW(), 20, 30.0, [0.004] * 3
        x0, goal = [10.0, 5.0, 2.0, 0.0, 0.0, 0.0], [0.0] * 6
        Q, R, Qf = eye(6, 1e-4), eye(3, 1e-2), eye(6, 1.0)
    refs = None
    if tracking:
        frac = torch.linspace(0.0, 1.0, N + 1, dtype=torch.float64)[:, None]
        refs = f64(x0) * (1.0 - frac) + f64(goal) * frac
    obj = tt.quadratic_objective(Q, R, Qf, f64(goal), dt, reference_states=refs, **kw)
    prob = tt.problem(m, obj, f64(x0), N, dt, **kw).add_constraint(
        "ControlConstraint", tt.control_constraint([-b for b in box], box, **kw))
    if model == "hcw" and terminal and not tracking:
        prob = prob.add_terminal_constraint(
            "TerminalEquality", tt.terminal_equality_constraint(f64(goal), **kw))
    return prob


def zoo_options(tt, model, solver):
    """The fleets' options: the goldens' (make_goldens.py:115-150; CLDDP on
    the pendulum 100 iterations, tolerance 1e-3, acceptable 1e-4; the
    interior-point solvers 300, 1e-4, 1e-5; CLDDP on the cart-pole 300,
    1e-4, 1e-6), the rendezvous bench's (bench_ipddp_fleet.py:110: 10
    iterations, tolerance 1e-4)."""
    if model == "hcw":
        return tt.CDDPOptions(max_iterations=10, tolerance=1e-4)
    if model == "cartpole":
        return tt.CDDPOptions(max_iterations=300, tolerance=1e-4, acceptable_tolerance=1e-6)
    if solver == "CLDDP":
        return tt.CDDPOptions(max_iterations=100, tolerance=1e-3, acceptable_tolerance=1e-4)
    return tt.CDDPOptions(max_iterations=300, tolerance=1e-4, acceptable_tolerance=1e-5)


def zoo_maker(model, tracking=False, terminal=True):
    """``zoo_problem`` as a ``make_problem(tt, dtype, device)``."""
    return lambda tt, dtype, dev: zoo_problem(tt, dtype, dev, model, tracking, terminal)


def phase_zoo_clddp_kernels(tt, dev, errs, plain):
    """(a) kernels 1-3 on the pendulum and the cart-pole, goal and tracking
    forms, by ``phase_kernels``' rules; the float32 plain driver's host ms
    at B_CHECK under (a)'s budget (``plain``, from ``LAST_PLAIN_MS``)."""
    for model in ("pendulum", "cartpole"):
        for tracking in (False, True):
            sfx = "_track" if tracking else ""
            iters = ZOO_TRACK_ITERS if tracking else ZOO_ITERS[model]
            opts = zoo_options(tt, model, "CLDDP").replace(max_iterations=iters)
            out = phase_kernels(tt, dev, zoo_maker(model, tracking), f"{model}{sfx}", opts,
                                rtol=ZOO_RTOL, moved=True, chaotic=model == "cartpole")
            for tag, r in out.items():
                for k in ("forward_rollout", "clddp_solve") + (
                        () if tracking else ("riccati_backward",)):
                    errs[tag][f"{k}{sfx if k != 'riccati_backward' else ''}@{model}"] = r[k]
            plain[f"clddp_solve{sfx}@{model}"] = LAST_PLAIN_MS[0]


def zoo_ip_check(tt, dev, label, make, opts, x0_gen_seed, eq=False):
    """Kernel 7 against the plain driver on cold seeds at B_CHECK: float64 by
    ``check_ip_solve`` (the terminal equality within 1e-7 and 1e-8 |plain|,
    as phase 12), float32 by ``check_ip_f32`` (the equality with
    ``early_forks``). Returns ({dtype: cost err}, float32 plain host ms)."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        prob = make(tt, dtype, dev)
        x0 = fleet_x0(prob, B_CHECK, torch.Generator(device=dev).manual_seed(x0_gen_seed))
        if dtype == torch.float64:
            _, _, out[tag] = check_ip_solve(label, *ip_solve_pair(tt, prob, opts, x0), True,
                                            tol=1e-7 if eq else 1e-8, dual_rtol=1e-8)
        else:
            _, out[tag] = check_ip_f32(tt, dev, prob, opts, x0, prob64=make(tt, torch.float64, dev),
                                       label=label, early_forks=eq)
    return out, LAST_PLAIN_MS[0]


def phase_zoo_ip_kernels(tt, dev, errs, plain):
    """(a) kernels 4-7 on the pendulum's control box (m = 2) and HCW's (m =
    6): the open-loop rollout (also on the cart-pole), the condensed
    backward (the pendulum's (2, 1, 2), on the plain driver's and the
    per-pass driver's layouts, same bits) and the forward trial (goal and
    tracking forms, with and without the slack SOC) on the inputs the
    per-pass driver stages (``stage_ip_inputs``), by ``check``; kernel 7 on
    the pendulum (goal and tracking forms) and HCW's rendezvous m6_te6
    (``zoo_ip_check``)."""
    from cddp_tpu_torch.models import rollout
    from cddp_tpu_torch.ops.kernels import ip_rollout
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    as64 = lambda ts: tuple(t.double() if t.is_floating_point() else t  # noqa: E731
                            for t in ts)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        exact = dtype == torch.float64
        gen = torch.Generator(device=dev).manual_seed(SEED + 41)
        for model in ("pendulum", "cartpole", "hcw"):
            prob = zoo_problem(tt, dtype, dev, model, terminal=False)
            x0 = fleet_x0(prob, B_CHECK, gen)
            cc = prob.get_constraint("ControlConstraint")
            U = (2.0 * torch.rand(B_CHECK, prob.horizon, prob.control_dim, generator=gen,
                                  device=dev, dtype=dtype) - 1.0) * cc.upper
            entry = rollout_ops.model_entry(prob.model)
            want = (ip_rollout.open_loop_rollout_plain(prob.model, x0, U, prob.timestep),)
            truth = None if exact else (ip_rollout.open_loop_rollout_plain(
                prob.model, x0.double(), U.double(), prob.timestep),)
            got = (ip_rollout._launch_open_loop(prob.model, entry, x0, U, prob.timestep),)
            if not torch.equal(got[0], rollout(prob.model, x0, U, prob.timestep)):
                raise AssertionError(f"open_loop_rollout@{model}: the public rollout differs")
            moved = None if not exact else (ip_rollout.open_loop_rollout_plain(
                prob.model, *ulp_up((x0, U)), prob.timestep),)
            errs[tag][f"open_loop_rollout@{model}"] = check(f"open_loop_rollout@{model}", got,
                                                            want, truth, rtol=ZOO_RTOL,
                                                            moved=moved)
        for model in ("pendulum", "hcw"):
            for tracking in (False, True):
                sfx = "_track" if tracking else ""
                prob = zoo_problem(tt, dtype, dev, model, tracking, terminal=False)
                opts = zoo_options(tt, model, "IPDDP").replace(max_iterations=10)
                p, ol, back, fwd = stage_ip_inputs(tt, prob, B_CHECK, gen, opts, iterations=1)
                err5 = 0.0
                for soc in (False, True):
                    fc = forward_consts(p, opts, soc)
                    truth = None if exact else ip_rollout.ip_forward_plain(
                        forward_consts(p, opts, soc, f64=True), *as64(fwd))
                    got = ip_rollout._launch_forward(fc, *fwd)
                    moved = (ip_rollout.ip_forward_plain(fc, *ulp_up(fwd)) if exact
                             else None)
                    err5 = max(err5, check(f"ip_forward{sfx}@{model} slack_soc={soc}", got,
                                           ip_rollout.ip_forward_plain(fc, *fwd), truth,
                                           rtol=ZOO_RTOL, moved=moved))
                    print(f"[zoo {tag}] ip_forward{sfx}@{model} slack_soc={soc}: feasible on "
                          f"{float(got[-1].double().mean()):.2%} of {B_CHECK}")
                errs[tag][f"ip_forward{sfx}@{model}"] = err5
                if model == "pendulum" and not tracking:
                    truth = None if exact else ric.ipddp_backward_plain(*as64(back))
                    got = ric._launch(*back)
                    moved = ric.ipddp_backward_plain(*ulp_up(back)) if exact else None
                    errs[tag]["ipddp_backward@pendulum"] = check(
                        "ipddp_backward@pendulum", got, ric.ipddp_backward_plain(*back), truth,
                        rtol=ZOO_RTOL, moved=moved)
                    again = ric._launch(*per_pass_layout(back))
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError("ipddp_backward@pendulum: the per-pass driver's "
                                             "layout gives other bits")
    cases = (  # entry, problem, options, iterations, terminal equality
        ("ipddp_solve@pendulum", zoo_maker("pendulum"), "pendulum", ZOO_ITERS["pendulum"],
         False),
        ("ipddp_solve_track@pendulum", zoo_maker("pendulum", True), "pendulum", ZOO_TRACK_ITERS,
         False),
        ("ipddp_solve_te6@hcw", zoo_maker("hcw"), "hcw", ZOO_ITERS["hcw"], True),
    )
    for name, make, model, iters, eq in cases:
        opts = zoo_options(tt, model, "IPDDP").replace(max_iterations=iters)
        out, plain[name] = zoo_ip_check(tt, dev, name, make, opts, SEED + 43, eq)
        for tag, v in out.items():
            errs[tag][name] = v


def phase_zoo_barrier_kernels(tt, dev, errs, plain):
    """(a) kernels 9 and 8 on the pendulum, goal and tracking forms, by
    ``phase_barrier_kernels``' rules (MSIPDDP over MS_EXACT_ITERS); each
    one's float32 plain driver's host ms at B_CHECK (``plain``: a run of
    its float32 check at the full budget)."""
    for tracking in (False, True):
        sfx = "_track" if tracking else ""
        iters = ZOO_TRACK_ITERS if tracking else ZOO_ITERS["pendulum"]
        opts = zoo_options(tt, "pendulum", "LogDDP").replace(max_iterations=iters)
        out = phase_barrier_kernels(tt, dev, zoo_maker("pendulum", tracking), f"pendulum{sfx}",
                                    opts, plain_ms=plain, suffix=f"{sfx}@pendulum")
        for tag, r in out.items():
            for k in ("logddp_solve", "msipddp_solve"):
                errs[tag][f"{k}{sfx}@pendulum"] = r[k]


def zoo_fleet_run(label, prob, x0, solver, opts, want, mega=None, U0=None):
    """One main-path run of a phase-14 fleet through ``batched_solve`` (from
    the controls ``U0`` (B, N, nu), zeros when None), the launch counts
    zeroed just before it and read just after; they must be ``want``: these
    counts, or for a set these kernels, each at least once. With ``mega``
    the whole-solve launch goes through ``count_work``. Returns (Solution,
    launches, host ms, (wrapper ms, work, divergence) or None)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    dispatch_log.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mega is None:
        sol = batched_solve(prob, x0, solver, opts, U0_batch=U0)
        work = None
    else:
        with count_work(mega) as rec:
            sol = batched_solve(prob, x0, solver, opts, U0_batch=U0)
        work = rec[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(dispatch_log.launches)
    if counts != want if isinstance(want, dict) else set(counts) != want:
        raise AssertionError(f"{label}: launches {counts}, not {want}")
    for what, t in (("cost", sol.final_objective), ("X", sol.state_trajectory),
                    ("U", sol.control_trajectory)):
        if not bool(t.isfinite().all()):
            raise AssertionError(f"{label}: non-finite {what}")
    return sol, counts, ms, work


def zoo_summary(label, sol, ms, work, smi):
    """Print a fleet's converged share, iterations, ms and solves/s, and the
    whole-solve launch's wrapper ms, work and warp divergence."""
    conv = (sol.status_code == 1) | (sol.status_code == 2)
    its = sol.iterations_completed.double()
    extra = ("" if work is None else f"; the kernel's wrapper {work[0]:.2f} ms, mean work per "
             f"instance {work[1]}, warp divergence {work[2]:.4f}")
    print(f"[zoo] {label}, B={sol.status_code.numel()}: converged {float(conv.double().mean()):.4%}"
          f", statuses {torch.bincount(sol.status_code.long(), minlength=5).tolist()}, "
          f"iterations mean {float(its.mean()):.3f} max {int(its.max())}; {ms:.2f} ms "
          f"({sol.status_code.numel() / ms * 1e3:.1f} solves/s){extra}  [{smi}]")


def phase_zoo_fleets(tt, dev, smi):
    """(b)-(d): the pendulum fleet (CLDDP with the golden's CLDDP options,
    IPDDP, LogDDP and MSIPDDP with its interior-point options: one
    whole-solve launch each, the barrier solvers beside one open-loop
    rollout), the cart-pole fleet (one CLDDP whole-solve launch), the HCW
    rendezvous fleet (whole-solve: one open-loop rollout and one m6_te6
    launch; per-pass: kernels 4 and 5 beside the plain reduced LQR), each at
    B_MAIN in float32; then five MPC ticks of the rendezvous warm and cold.
    Runs that drive the other new instantiations follow, each at B_MAIN and
    few iterations (the per-pass engines, the tracking forms, HCW's box
    alone, the cart-pole's open-loop rollout). Returns (launches {entry:
    n}, {fleet: (problem, x0, options)} for the timings)."""
    from cddp_tpu_torch.models import rollout
    from cddp_tpu_torch.ops.kernels import (dispatch_log, mega_clddp, mega_ipddp, mega_logddp,
                                            mega_msipddp)

    t0 = time.perf_counter()
    launches, fleets = {}, {}
    megas = {"CLDDP": mega_clddp, "IPDDP": mega_ipddp, "LogDDP": mega_logddp,
             "MSIPDDP": mega_msipddp}
    kernels = {"CLDDP": "clddp_solve", "IPDDP": "ipddp_solve", "LogDDP": "logddp_solve",
               "MSIPDDP": "msipddp_solve"}
    for model, solvers in (("pendulum", ("CLDDP", "IPDDP", "LogDDP", "MSIPDDP")),
                           ("cartpole", ("CLDDP",))):
        prob = zoo_problem(tt, torch.float32, dev, model)
        x0 = fleet_x0(prob, B_MAIN, torch.Generator(device=dev).manual_seed(SEED))
        for solver in solvers:
            opts = zoo_options(tt, model, solver)
            name = f"{kernels[solver]}@{model}"
            want = {name: 1} if solver == "CLDDP" else {name: 1, f"open_loop_rollout@{model}": 1}
            sol, counts, ms, work = zoo_fleet_run(f"{model} {solver} fleet", prob, x0, solver,
                                                  opts, want, megas[solver])
            launches.update(counts)
            zoo_summary(f"{model} {solver} fleet", sol, ms, work, smi)
            fleets[name] = (prob, x0, opts)

    # (d) The HCW rendezvous fleet on both engines, then the MPC ticks.
    prob = zoo_problem(tt, torch.float32, dev, "hcw")
    x0 = fleet_x0(prob, B_MAIN, torch.Generator(device=dev).manual_seed(SEED))
    opts = zoo_options(tt, "hcw", "IPDDP")
    fleets["ipddp_solve_te6@hcw"] = (prob, x0, opts)
    for engine, o, want, xs in (
            ("whole-solve", opts, {"open_loop_rollout@hcw": 1, "ipddp_solve_te6@hcw": 1}, x0),
            ("per-pass", opts.replace(solve_engine="xla"), {"open_loop_rollout@hcw",
                                                            "ip_forward@hcw"},
             x0[:B_MAIN // PER_PASS_SHARE])):
        sol, counts, ms, work = zoo_fleet_run(f"hcw rendezvous {engine}", prob, xs, "IPDDP", o,
                                              want, mega_ipddp if engine == "whole-solve" else None)
        if engine == "whole-solve":
            launches.update(counts)
        else:
            launches["ip_forward@hcw"] = counts["ip_forward@hcw"]
        viol = terminal_violation(prob, sol.state_trajectory)
        zoo_summary(f"hcw rendezvous fleet, {engine} engine", sol, ms, work, smi)
        print(f"[zoo] hcw rendezvous {engine}: launches {counts}; terminal violation max "
              f"{float(viol.max()):.3e}, mean {float(viol.mean()):.3e}, median "
              f"{float(viol.median()):.3e}")
    for warm in (True, False):
        run = f"hcw rendezvous MPC {'warm' if warm else 'cold'}"
        init_fn, step_fn = tt.make_mpc_controller(prob, "IPDDP", opts,
                                                  warm_start_solver_state=warm)
        x = x0.clone()
        state = init_fn(x)
        ms, its = [], []
        for k in range(WARM_TICKS):
            dispatch_log.reset()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with count_work(mega_ipddp) as work:
                u, state, info = step_fn(state, x, k)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            counts = dict(dispatch_log.launches)
            if counts != {"open_loop_rollout@hcw": 1, "ipddp_solve_te6@hcw": 1}:
                raise AssertionError(f"{run} tick {k}: launches {counts}")
            if not bool(u.isfinite().all()) or not bool(info["cost"].isfinite().all()):
                raise AssertionError(f"{run} tick {k}: non-finite controls or costs")
            its.append(float(info["iterations"].double().mean()))
            x = prob.model.discrete_dynamics(x, u, k * prob.timestep, prob.timestep)
            kernel_ms, rows, div = work[0]
            print(f"[zoo] {run} tick {k}: {ms[-1]:.2f} ms (the kernel's wrapper {kernel_ms:.2f} "
                  f"ms, mean work per instance {rows}, warp divergence {div:.3f}), mean "
                  f"iterations {its[-1]:.3f}, statuses "
                  f"{torch.bincount(info['status'].long(), minlength=4).tolist()}  [{smi}]")
        print(f"[zoo] {run}, B={B_MAIN}, {WARM_TICKS} ticks: {sum(ms[1:]) / (len(ms) - 1):.2f} ms "
              f"a tick after the first, first {ms[0]:.2f}; mean iterations a tick "
              f"{sum(its) / len(its):.3f}; mean |x| at the end "
              f"{float(x[:, :3].norm(dim=-1).mean()):.4f}  [{smi}]")

    # The runs that drive the other instantiations, ZOO_TRACK_ITERS
    # iterations each: (label, model, tracking, terminal, solver, engine, the
    # kernels it launches, the entries it drives).
    ol = {m: f"open_loop_rollout@{m}" for m in ("pendulum", "hcw")}
    drive = (
        ("pendulum CLDDP per-pass", "pendulum", False, True, "CLDDP", "xla",
         {"riccati_backward@2x1", "forward_rollout@pendulum"}, ("forward_rollout@pendulum",)),
        ("cartpole CLDDP per-pass", "cartpole", False, True, "CLDDP", "xla",
         {"riccati_backward@4x1", "forward_rollout@cartpole"}, ("forward_rollout@cartpole",)),
        ("pendulum IPDDP per-pass", "pendulum", False, True, "IPDDP", "xla",
         {ol["pendulum"], "ipddp_backward@2x1x2", "ip_forward@pendulum"},
         ("ip_forward@pendulum",)),
        ("pendulum CLDDP tracking", "pendulum", True, True, "CLDDP", "auto",
         {"clddp_solve_track@pendulum"}, ("clddp_solve_track@pendulum",)),
        ("pendulum CLDDP tracking per-pass", "pendulum", True, True, "CLDDP", "xla",
         {"riccati_backward@2x1", "forward_rollout_track@pendulum"},
         ("forward_rollout_track@pendulum",)),
        ("cartpole CLDDP tracking", "cartpole", True, True, "CLDDP", "auto",
         {"clddp_solve_track@cartpole"}, ("clddp_solve_track@cartpole",)),
        ("cartpole CLDDP tracking per-pass", "cartpole", True, True, "CLDDP", "xla",
         {"riccati_backward@4x1", "forward_rollout_track@cartpole"},
         ("forward_rollout_track@cartpole",)),
        ("pendulum IPDDP tracking", "pendulum", True, True, "IPDDP", "auto",
         {ol["pendulum"], "ipddp_solve_track@pendulum"}, ("ipddp_solve_track@pendulum",)),
        ("pendulum IPDDP tracking per-pass", "pendulum", True, True, "IPDDP", "xla",
         {ol["pendulum"], "ipddp_backward@2x1x2", "ip_forward_track@pendulum"},
         ("ip_forward_track@pendulum",)),
        ("pendulum LogDDP tracking", "pendulum", True, True, "LogDDP", "auto",
         {ol["pendulum"], "logddp_solve_track@pendulum"}, ("logddp_solve_track@pendulum",)),
        ("pendulum MSIPDDP tracking", "pendulum", True, True, "MSIPDDP", "auto",
         {ol["pendulum"], "msipddp_solve_track@pendulum"}, ("msipddp_solve_track@pendulum",)),
        ("hcw IPDDP tracking per-pass", "hcw", True, False, "IPDDP", "xla",
         {ol["hcw"], "ipddp_backward@6x3x6", "ip_forward_track@hcw"},
         ("ip_forward_track@hcw",)),
    )
    for label, model, tracking, terminal, solver, engine, want, driven in drive:
        p = zoo_problem(tt, torch.float32, dev, model, tracking, terminal)
        x = fleet_x0(p, B_MAIN, torch.Generator(device=dev).manual_seed(SEED))
        o = zoo_options(tt, model, solver).replace(max_iterations=ZOO_TRACK_ITERS,
                                                   solve_engine=engine)
        _, counts, ms, _ = zoo_fleet_run(label, p, x, solver, o, want)
        print(f"[zoo] {label}, B={B_MAIN}, {ZOO_TRACK_ITERS} iterations: launches {counts}, "
              f"{ms:.2f} ms")
        for name in want:
            launches.setdefault(name, counts[name])
        for name in driven:
            fleets[name] = (p, x, o.replace(solve_engine="auto"))
    p = zoo_problem(tt, torch.float32, dev, "cartpole")
    x = fleet_x0(p, B_MAIN, torch.Generator(device=dev).manual_seed(SEED))
    dispatch_log.reset()
    X = rollout(p.model, x, x.new_zeros(B_MAIN, p.horizon, 1), p.timestep)
    torch.cuda.synchronize()
    counts = dict(dispatch_log.launches)
    if counts != {"open_loop_rollout@cartpole": 1} or not bool(X.isfinite().all()):
        raise AssertionError(f"the cart-pole's open-loop rollout: launches {counts}")
    launches.update(counts)
    print(f"[zoo] fleets done in {time.perf_counter() - t0:.1f} s")
    return launches, fleets


def time_open_loop(prob, x0, smi):
    """Kernel 4 at B_MAIN from x0 under random controls in the box: its
    times, its plain version's and its bound (``time_kernels``)."""
    from cddp_tpu_torch.ops.kernels import ip_rollout
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    gen = torch.Generator(device=x0.device).manual_seed(SEED)
    cc = prob.get_constraint("ControlConstraint")
    U = (2.0 * torch.rand(B_MAIN, prob.horizon, prob.control_dim, generator=gen,
                          device=x0.device) - 1.0) * cc.upper
    entry, dt = rollout_ops.model_entry(prob.model), prob.timestep
    kernel = lambda: ip_rollout._launch_open_loop(prob.model, entry, x0, U, dt)  # noqa: E731
    ops = count_ops_steps(ip_rollout.open_loop_rollout_plain, prob.model, x0[:1], U[:1], dt)
    runs = {"open_loop_rollout": (kernel, 20, lambda: ip_rollout.open_loop_rollout_plain(
        prob.model, x0, U, dt), 1)}
    work = {"open_loop_rollout": ((x0, U), (kernel()[:, 1:],), ops * B_MAIN)}
    return time_kernels(runs, work, x0.dtype, smi, events_ok="wrapper")["open_loop_rollout"]


def time_zoo_kernels(tt, fleets, plain, smi):
    """Every phase-14 entry's wrapper and device ms, plain ms and bound at
    B_MAIN on the inputs of the run that drives it (``fleets``: the
    problem, x0 and options of each), by the timing functions of phases 4,
    6, 10 and 12: kernels 1, 2, 4, 5 and 6 on the inputs ``stage_inputs``
    and ``stage_ip_inputs`` stage about that run's problem, the whole
    solves from its cold seeds under its options. The whole solves' plain
    ms are the float32 plain drivers' at B_CHECK under (a)'s iterations
    (``plain``): the plain drivers are not run at B_MAIN on these
    horizons. Returns {entry: timing tuple}."""
    out = {}

    def keep(timing, model, sfx, shape_keyed=()):
        for k, v in timing.items():
            out[f"{k}@{model}" if k in shape_keyed else f"{k}{sfx}@{model}"] = v

    for model in ("pendulum", "cartpole"):
        for sfx in ("", "_track"):
            name = f"clddp_solve{sfx}@{model}"
            p, x0, o = fleets[name]
            names = ("forward_rollout", "clddp_solve") + (("riccati_backward",) if not sfx else ())
            keep(time_clddp_kernels(p, x0, o, smi, names=names, events_ok="wrapper",
                                    plain_ms={"clddp_solve": plain[name]}),
                 model, sfx, ("riccati_backward",))
    # HCW's kernels 4 and 5 on the rendezvous fleet, whose per-pass engine
    # runs them; kernel 5's tracking form on the tracking run.
    keys = {("pendulum", ""): "ipddp_solve@pendulum",
            ("pendulum", "_track"): "ipddp_solve_track@pendulum",
            ("hcw", ""): "ipddp_solve_te6@hcw", ("hcw", "_track"): "ip_forward_track@hcw"}
    for model, names in (("pendulum", ("open_loop_rollout", "ip_forward", "ipddp_backward",
                                       "ipddp_solve")),
                         ("hcw", ("open_loop_rollout", "ip_forward"))):
        for sfx in ("", "_track"):
            key = keys[(model, sfx)]
            p, x0, o = fleets[key]
            todo = names if not sfx else tuple(n for n in names if n in (
                "ip_forward",) + (("ipddp_solve",) if model == "pendulum" else ()))
            keep(time_ip_kernels(tt, p, x0, smi, names=todo, opts=o, events_ok="wrapper",
                                 stage_iterations=1,
                                 plain_ms={"ipddp_solve": plain.get(key)}),
                 model, sfx, ("open_loop_rollout", "ipddp_backward"))
    p, x0, _ = fleets["clddp_solve@cartpole"]
    out["open_loop_rollout@cartpole"] = time_open_loop(p, x0, smi)
    for sfx in ("", "_track"):
        p, x0, o = fleets[f"logddp_solve{sfx}@pendulum"]
        keep(time_barrier_kernels(tt, p, x0, smi, opts=o, events_ok="wrapper", plain_ms={
            k: plain[f"{k}{sfx}@pendulum"] for k in ("logddp_solve", "msipddp_solve")}),
             "pendulum", sfx)
    prob, x0, opts = fleets["ipddp_solve_te6@hcw"]
    timing, work, attrs = time_terminal_kernel(tt, prob, x0, smi, "m6_te6", opts=opts,
                                               plain_ms=plain["ipddp_solve_te6@hcw"],
                                               events_ok="wrapper")
    out["ipddp_solve_te6@hcw"] = timing
    print(f"[zoo] ipddp_solve_te6@hcw: {work[0]:.3f} backward attempts and {work[1]:.3f} "
          f"sweeps per instance; attributes {attrs}  [{smi}]")
    return out


def zoo_checks(tt, dev):
    """Phase 14's (a): every new instantiation against its plain version at
    B_CHECK, float64 and float32. Returns ({dtype: {entry: err}}, {entry:
    float32 plain ms})."""
    t0 = time.perf_counter()
    errs, plain = {"float64": {}, "float32": {}}, {}
    phase_zoo_clddp_kernels(tt, dev, errs, plain)
    phase_zoo_ip_kernels(tt, dev, errs, plain)
    phase_zoo_barrier_kernels(tt, dev, errs, plain)
    print(f"[zoo] (a) done in {time.perf_counter() - t0:.1f} s; plain drivers at B={B_CHECK}, "
          f"float32: " + ", ".join(f"{k} {v:.1f} ms" for k, v in plain.items()))
    return errs, plain


def phase_zoo(tt, dev, smi, checked):
    """Phase 14, the pendulum, the cart-pole and HCW: (a) every new
    instantiation against its plain version at B_CHECK, float64 and
    float32; (b)-(d) the fleets at B_MAIN and the runs that drive the other
    instantiations (each entry's times and bound at B_MAIN follow in
    ``time_zoo_kernels``); ``checked``: (a)'s results (``zoo_checks``),
    which ``main`` runs earlier. Returns ({entry: launches}, {dtype: {entry:
    err}}, {fleet: (problem, x0, options)}, {entry: plain ms}, {entry:
    plain-driver batch and iterations})."""
    t0 = time.perf_counter()
    errs, plain = checked
    checked_errs("phase 14", errs)
    launches, fleets = phase_zoo_fleets(tt, dev, smi)
    plain_at = {k: f"B={B_CHECK}, float32, "
                   f"{ZOO_TRACK_ITERS if '_track' in k else ZOO_ITERS[k.split('@')[1]]} iterations"
                   for k in plain}
    print(f"[zoo] phase 14 checks and fleets done in {time.perf_counter() - t0:.1f} s")
    return launches, errs, fleets, plain, plain_at


# --- the discrete car, the forklift and the LTISystem (phase 15) -------------------

CAR_B = 65536  # the car-parking fleet's batch (its horizon is N = 300)
CAR_ITERS = 10
CAR_CHECK_N = 60  # horizon of (a)'s per-pass solves against the plain drivers
# float32 kernels 5 and 6 on the car's N = 300 IPDDP operands: the feedback
# terms K dx of the staged gains cancel, and the kernel sums them in
# another order than the plain version's matrix products (on an H100 the
# forward trial's U reached 2.02x the plain version's largest error against
# float64 while every state kept equal errors), so these two are held per
# instance, at the median and the 99th percentile (``check``'s quantiles,
# the rule of the cart-pole's long-horizon kernels); float64 stays exact.
CAR_F32_QUANTILES = ("ip_forward", "ipddp_backward")
CAR_CHECK_ITERS = 5
# Iterations of the car's MSIPDDP and LogDDP fleets on their plain drivers
# (B_CHECK, N = 300): at ten they took 28.0 and 14.6 s of a full run on an
# H100's host, beyond the script's time; at five 5.8 and 4.4 s (NVIDIA
# H100 80GB HBM3, 700 W).
CAR_PLAIN_ITERS = 2
# Phase 15's kernels, each an entry of the kernels' JSON line: (entry name,
# dispatch_log name, kernel, model, launcher without its type suffix).
DISCRETE_ENTRIES = tuple(
    (name, logged or name, name.split("@")[0], name.split("@")[1], launcher)
    for name, logged, launcher in (
        ("riccati_backward@car", "riccati_backward@4x2", "cddp_riccati_backward_4x2"),
        ("riccati_backward@lti", "riccati_backward@4x2", "cddp_riccati_backward_4x2"),
        ("forward_rollout@car", None, "cddp_forward_rollout_car"),
        ("open_loop_rollout@car", None, "cddp_open_loop_rollout_car"),
        ("open_loop_rollout@forklift", None, "cddp_open_loop_rollout_forklift"),
        ("ip_forward@car", None, "cddp_ip_forward_car_m4"),
        ("ipddp_backward@car", "ipddp_backward@4x2x4", "cddp_ipddp_backward_4x2x4"),
    ))


def car_problem(tt, dtype, device, horizon=300):
    """The car-parking golden's problem (tests/make_goldens.py:110-124): Tassa's
    car, N = 300, dt = 0.03, Q = diag(1e-2, 1e-2, 1e-3, 1e-3), R = 1e-2 I,
    Qf = diag(100, 100, 50, 10), the goal 0, the box [-0.5, -2]..[0.5, 2],
    x0 = (1, 1, 1.5 pi, 0)."""
    from cddp_tpu_torch.models import Car

    kw = dict(device=device, dtype=dtype)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    dt = 0.03
    obj = tt.quadratic_objective(f64([1e-2, 1e-2, 1e-3, 1e-3]).diag(),
                                 1e-2 * torch.eye(2, dtype=torch.float64),
                                 f64([100.0, 100.0, 50.0, 10.0]).diag(), f64([0.0] * 4), dt, **kw)
    prob = tt.problem(Car(wheelbase=2.0, timestep=dt), obj, f64([1.0, 1.0, 1.5 * math.pi, 0.0]),
                      horizon, dt, **kw)
    return prob.add_constraint("ControlConstraint",
                               tt.control_constraint([-0.5, -2.0], [0.5, 2.0], **kw))


def car_options(tt, solver, iterations=CAR_ITERS):
    """The car golden's options (make_goldens.py:177-189: tolerance 1e-4,
    acceptable 1e-6, initial regularization 1e-2, mu_initial 1, MSIPDDP's
    segments of 50 with the nonlinear rollout) over ``iterations``; the
    interior-point solvers take its mu_initial too."""
    from cddp_tpu_torch.options import RegularizationOptions

    barrier = tt.BarrierOptions(mu_initial=1.0)
    return tt.CDDPOptions(
        max_iterations=iterations, tolerance=1e-4, acceptable_tolerance=1e-6,
        regularization=RegularizationOptions(initial_value=1e-2),
        ipddp=tt.IPDDPOptions(barrier=barrier) if solver == "IPDDP" else tt.IPDDPOptions(),
        msipddp=tt.MSIPDDPOptions(segment_length=50, rollout_type="nonlinear",
                                  barrier=barrier))


def lti_problem(tt, dtype, device):
    """tests/test_clddp.py:160-172: the default LTISystem 4x2 (dt = 0.1,
    N = 30, Q = 0.5 I, R = 0.1 I, Qf = 5 I, x0 = (1, -1, 0.5, 0.2)), with the
    control box [-1, 1]^2 so that kernel 1 applies."""
    kw = dict(device=device, dtype=dtype)
    eye = lambda n, v: v * torch.eye(n, dtype=torch.float64)  # noqa: E731
    obj = tt.quadratic_objective(eye(4, 0.5), eye(2, 0.1), eye(4, 5.0),
                                 torch.zeros(4, dtype=torch.float64), 0.1, **kw)
    prob = tt.problem(tt.lti_system(0.1, device=device, dtype=dtype), obj,
                      torch.tensor([1.0, -1.0, 0.5, 0.2], dtype=torch.float64), 30, 0.1, **kw)
    return prob.add_constraint("ControlConstraint",
                               tt.control_constraint([-1.0, -1.0], [1.0, 1.0], **kw))


def forklift_case(B, dtype, device, gen):
    """Kernel 4's forklift operands: the rear-steered truck (wheelbase 2),
    dt = 0.05, N = 100, x0 with |x|, |y| <= 5, any heading, v and the
    steering angle within 1 and 0.5, and controls a in [-1, 1], ddelta in
    [-0.5, 0.5]."""
    from cddp_tpu_torch.models import Forklift

    u = torch.rand(B, 5, generator=gen, device=device, dtype=dtype) * 2.0 - 1.0
    x0 = u * torch.tensor([5.0, 5.0, math.pi, 1.0, 0.5], device=device, dtype=dtype)
    U = (torch.rand(B, 100, 2, generator=gen, device=device, dtype=dtype) * 2.0 - 1.0) * (
        torch.tensor([1.0, 0.5], device=device, dtype=dtype))
    return Forklift(wheelbase=2.0).to(dtype), x0, U, 0.05


# The unconstrained pendulum's budget in (d): its plain-engine iterations
# took 34 s of the script at 200 and 23 s at 40 (on an NVIDIA H100 80GB
# HBM3); it is a drive of the path without path rows, its convergence
# printed, not held.
UNCONSTRAINED_ITERS = 20


def unconstrained_problems(tt, dtype, device):
    """(d)'s problems: the unconstrained pendulum of tests/test_ipddp.py:81-92
    (N = 100, dt = 0.02, Q = 0, R = 0.1, Qf = 100 I, no constraint, its
    tolerance 1e-5, at UNCONSTRAINED_ITERS iterations of its 200) and the scalar terminal
    equality of make_goldens.py:87-97 (x+ = x + u, N = 8, x_N = 0.6, its
    options: 60 iterations, tolerance and acceptable 1e-6, mu_initial 0.1).
    {label: (problem, options, target of x_N)}."""
    from cddp_tpu_torch.models import LTISystem, Pendulum

    kw = dict(device=device, dtype=dtype)
    eye = lambda n, v: v * torch.eye(n, dtype=torch.float64)  # noqa: E731
    pend = tt.problem(Pendulum(length=0.5, mass=1.0, damping=0.01), tt.quadratic_objective(
        eye(2, 0.0), eye(1, 0.1), eye(2, 100.0), torch.zeros(2, dtype=torch.float64), 0.02,
        **kw), torch.tensor([math.pi, 0.0], dtype=torch.float64), 100, 0.02, **kw)
    one = torch.eye(1, dtype=torch.float64, device=device)
    scalar = tt.problem(LTISystem(one, one, 1.0), tt.quadratic_objective(
        eye(1, 0.0), eye(1, 1e-2), eye(1, 100.0), torch.tensor([0.6], dtype=torch.float64), 1.0,
        **kw), torch.zeros(1, dtype=torch.float64), 8, 1.0, **kw).add_terminal_constraint(
        "TerminalEqualityConstraint",
        tt.terminal_equality_constraint(torch.tensor([0.6], dtype=torch.float64), **kw))
    return {
        "unconstrained pendulum": (pend, tt.CDDPOptions(max_iterations=UNCONSTRAINED_ITERS,
                                                        tolerance=1e-5),
                                   [0.0, 0.0]),
        "scalar terminal equality": (scalar, tt.CDDPOptions(
            max_iterations=60, tolerance=1e-6, acceptable_tolerance=1e-6,
            ipddp=tt.IPDDPOptions(barrier=tt.BarrierOptions(mu_initial=1e-1))), [0.6]),
    }


def phase_discrete_kernels(tt, dev, errs):
    """(a) every new instantiation against its plain version at B_CHECK, in
    float64 (within 1e-9 + ZOO_RTOL |v| plus twice the plain version's own
    move from inputs one ulp up, ``check``) and float32 (the float64-truth
    rule of ``check``): kernels 1 and 2 on the car's operands about random
    trajectories (``stage_inputs``), kernel 1 also on the LTISystem's,
    kernel 4 on the car and the forklift, kernels 5 (with and without the
    slack SOC) and 6 on the car's IPDDP operands (``stage_ip_inputs``,
    kernel 6 on both drivers' layouts, same bits); then the car's per-pass
    CLDDP and IPDDP (kernels 1 and 2; 4, 6 and 5) against their plain
    drivers in float64 at N = CAR_CHECK_N over CAR_CHECK_ITERS iterations:
    every status and iteration count equal, X, U and cost within 1e-8 (CLDDP
    plus MOVE_FACTOR times the plain driver's move from x0 one ulp up), the
    duals, slacks and mu too for IPDDP (``check_ip_solve``)."""
    from cddp_tpu_torch.models import rollout
    from cddp_tpu_torch.ops.kernels import dispatch_log, ip_rollout, riccati
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops
    from cddp_tpu_torch.parallel.batch import batched_solve

    as64 = lambda ts: tuple(t.double() if isinstance(t, torch.Tensor)  # noqa: E731
                            and t.is_floating_point() else t for t in ts)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        exact = dtype == torch.float64
        gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        for label, make in (("car", car_problem), ("lti", lti_problem)):
            prob = make(tt, dtype, dev)
            X, U, back, alpha = stage_inputs(prob, B_CHECK, gen)
            want = riccati.riccati_backward_plain(*back)
            errs[tag][f"riccati_backward@{label}"] = check(
                f"riccati_backward@4x2 ({label})", riccati._launch(*back), want,
                None if exact else riccati.riccati_backward_plain(*as64(back)), rtol=ZOO_RTOL,
                moved=riccati.riccati_backward_plain(*ulp_up(back)) if exact else None)
            if label != "car":
                continue
            consts = rollout_ops.lane_consts(prob)
            fwd = (X[:, :-1], U, want[0], want[1], X[:, 0], alpha)
            errs[tag]["forward_rollout@car"] = check(
                "forward_rollout@car", rollout_ops._launch(consts, *fwd),
                rollout_ops.forward_rollout_plain(consts, *fwd),
                None if exact else rollout_ops.forward_rollout_plain(consts_f64(consts),
                                                                     *as64(fwd)),
                rtol=ZOO_RTOL,
                moved=rollout_ops.forward_rollout_plain(consts, *ulp_up(fwd)) if exact else None)
        for model in ("car", "forklift"):
            if model == "car":
                prob = car_problem(tt, dtype, dev)
                x0 = fleet_x0(prob, B_CHECK, gen)
                cc = prob.get_constraint("ControlConstraint")
                U = (2.0 * torch.rand(B_CHECK, prob.horizon, 2, generator=gen, device=dev,
                                      dtype=dtype) - 1.0) * cc.upper
                mdl, dt = copy.deepcopy(prob.model).to(dtype), prob.timestep
            else:
                mdl, x0, U, dt = forklift_case(B_CHECK, dtype, dev, gen)
            entry = rollout_ops.model_entry(mdl)
            got = ip_rollout._launch_open_loop(mdl, entry, x0, U, dt)
            if not torch.equal(got, rollout(mdl, x0, U, dt)):
                raise AssertionError(f"open_loop_rollout@{model}: the public rollout differs")
            m64 = copy.deepcopy(mdl).double()
            errs[tag][f"open_loop_rollout@{model}"] = check(
                f"open_loop_rollout@{model}", (got,),
                (ip_rollout.open_loop_rollout_plain(mdl, x0, U, dt),),
                None if exact else (ip_rollout.open_loop_rollout_plain(m64, x0.double(),
                                                                       U.double(), dt),),
                rtol=ZOO_RTOL, moved=(ip_rollout.open_loop_rollout_plain(
                    mdl, *ulp_up((x0, U)), dt),) if exact else None)
        prob = car_problem(tt, dtype, dev)
        opts = car_options(tt, "IPDDP")
        p, _, back, fwd = stage_ip_inputs(tt, prob, B_CHECK, gen, opts, iterations=1)
        err5 = 0.0
        for soc in (False, True):
            fc = forward_consts(p, opts, soc)
            got = ip_rollout._launch_forward(fc, *fwd)
            err5 = max(err5, check(
                f"ip_forward@car slack_soc={soc}", got, ip_rollout.ip_forward_plain(fc, *fwd),
                None if exact else ip_rollout.ip_forward_plain(
                    forward_consts(p, opts, soc, f64=True), *as64(fwd)),
                rtol=ZOO_RTOL, quantiles="ip_forward" in CAR_F32_QUANTILES,
                moved=ip_rollout.ip_forward_plain(fc, *ulp_up(fwd)) if exact else None))
            print(f"[discrete {tag}] ip_forward@car slack_soc={soc}: feasible on "
                  f"{float(got[-1].double().mean()):.2%} of {B_CHECK}")
        errs[tag]["ip_forward@car"] = err5
        got = ric._launch(*back)
        errs[tag]["ipddp_backward@car"] = check(
            "ipddp_backward@car", got, ric.ipddp_backward_plain(*back),
            None if exact else ric.ipddp_backward_plain(*as64(back)), rtol=ZOO_RTOL,
            quantiles="ipddp_backward" in CAR_F32_QUANTILES,
            moved=ric.ipddp_backward_plain(*ulp_up(back)) if exact else None)
        if not all(torch.equal(a, b) for a, b in zip(got, ric._launch(*per_pass_layout(back)))):
            raise AssertionError("ipddp_backward@car: the per-pass driver's layout gives "
                                 "other bits")

    # The car's per-pass solves against the plain drivers, float64.
    prob = car_problem(tt, torch.float64, dev, horizon=CAR_CHECK_N)
    x0 = fleet_x0(prob, B_CHECK, torch.Generator(device=dev).manual_seed(SEED + 53))
    up = ulp_up((x0,))[0]
    for solver, want in (("CLDDP", {"riccati_backward@4x2", "forward_rollout@car"}),
                         ("IPDDP", {"open_loop_rollout@car", "ipddp_backward@4x2x4",
                                    "ip_forward@car"})):
        opts = car_options(tt, solver, CAR_CHECK_ITERS)
        plain_opts = (opts.replace(backward_engine="scan") if solver == "CLDDP"
                      else plain_ip_options(tt, opts))
        dispatch_log.reset()
        kern = batched_solve(prob, x0, solver, opts)
        torch.cuda.synchronize()
        counts = dict(dispatch_log.launches)
        if set(counts) != want:
            raise AssertionError(f"car {solver} per pass, float64: launches {counts}, not "
                                 f"{sorted(want)}")
        plain = batched_solve(prob, x0, solver, plain_opts)
        if solver == "CLDDP":
            check_solve_f64("car per-pass", kern, plain,
                            moved=batched_solve(prob, up, solver, plain_opts))
        else:
            check_ip_solve("car per-pass", kern, plain, True, dual_rtol=1e-8)
        print(f"[discrete float64] car {solver} per pass at N={CAR_CHECK_N}, "
              f"{CAR_CHECK_ITERS} iterations: launches {counts}; iterations "
              f"{torch.bincount(kern.iterations_completed.long()).tolist()}")


def phase_discrete_fleets(tt, dev, smi):
    """(b)-(d), each run with the launch counts zeroed just before it and read
    just after: (b) the car-parking fleet (x0 + U(-0.1, 0.1)^4, float32,
    CAR_ITERS iterations of the golden's options) at CAR_B / PER_PASS_SHARE
    under CLDDP per pass (kernels 1 and 2) and IPDDP per pass (kernels 4, 6 and 5), and at
    B_CHECK under MSIPDDP (segments of 50, nonlinear) and LogDDP on their
    plain drivers over CAR_PLAIN_ITERS, seeded by kernel 4; the forklift's
    public rollout at
    B_MAIN (kernel 4); (c) the LTISystem 4x2 box fleet at B_MAIN under CLDDP
    per pass (kernel 1 beside the plain rollout); (d) the unconstrained
    pendulum and the scalar terminal equality at B_CHECK under IPDDP (no
    kernel but 4's seed), with the converged share and the terminal
    distance. Returns (launches {entry: n}, {entry: (problem, x0) of the
    run that drives it})."""
    from cddp_tpu_torch.models import rollout
    from cddp_tpu_torch.ops.kernels import dispatch_log

    launches, fleets = {}, {}
    car = car_problem(tt, torch.float32, dev)
    x0 = fleet_x0(car, CAR_B, torch.Generator(device=dev).manual_seed(SEED))
    runs = (  # solver, batch, launches it must make, the entries it drives
        ("CLDDP", CAR_B // PER_PASS_SHARE, {"riccati_backward@4x2", "forward_rollout@car"},
         {"riccati_backward@car": "riccati_backward@4x2",
          "forward_rollout@car": "forward_rollout@car"}),
        ("IPDDP", CAR_B // PER_PASS_SHARE, {"open_loop_rollout@car", "ipddp_backward@4x2x4",
                                            "ip_forward@car"},
         {"open_loop_rollout@car": "open_loop_rollout@car", "ip_forward@car": "ip_forward@car",
          "ipddp_backward@car": "ipddp_backward@4x2x4"}),
        ("MSIPDDP", B_CHECK, {"open_loop_rollout@car": 1}, {}),
        ("LogDDP", B_CHECK, {"open_loop_rollout@car": 1}, {}),
    )
    for solver, B, want, drives in runs:
        label = f"car-parking {solver} fleet" + (" (plain driver)" if B == B_CHECK else
                                                 " (per pass)")
        iters = CAR_ITERS if B != B_CHECK else CAR_PLAIN_ITERS
        sol, counts, ms, _ = zoo_fleet_run(label, car, x0[:B], solver,
                                           car_options(tt, solver, iters), want)
        zoo_summary(label, sol, ms, None, smi)
        dist = (sol.state_trajectory[:, -1] - car.objective.reference_state).norm(dim=-1)
        print(f"[discrete] {label}: launches {counts}; distance of x_N to the goal: median "
              f"{float(dist.median()):.3e}, max {float(dist.max()):.3e}")
        for entry, logged in drives.items():
            launches[entry] = counts[logged]
            fleets[entry] = (car, x0)

    fl, xf, Uf, dt = forklift_case(B_MAIN, torch.float32, dev,
                                   torch.Generator(device=dev).manual_seed(SEED))
    dispatch_log.reset()
    X = rollout(fl, xf, Uf, dt)
    torch.cuda.synchronize()
    counts = dict(dispatch_log.launches)
    if counts != {"open_loop_rollout@forklift": 1} or not bool(X.isfinite().all()):
        raise AssertionError(f"the forklift's open-loop rollout: launches {counts}")
    launches.update(counts)

    lti = lti_problem(tt, torch.float32, dev)
    xl = fleet_x0(lti, B_MAIN, torch.Generator(device=dev).manual_seed(SEED))
    sol, counts, ms, _ = zoo_fleet_run("LTISystem 4x2 box fleet", lti, xl, "CLDDP",
                                       tt.CDDPOptions(max_iterations=10, tolerance=1e-6),
                                       {"riccati_backward@4x2"})
    zoo_summary("LTISystem 4x2 box fleet (CLDDP per pass)", sol, ms, None, smi)
    launches["riccati_backward@lti"] = counts["riccati_backward@4x2"]
    fleets["riccati_backward@lti"] = (lti, xl)

    gen = torch.Generator(device=dev).manual_seed(SEED + 55)
    for label, (p, opts, target) in unconstrained_problems(tt, torch.float32, dev).items():
        nx = p.state_dim
        xd = p.x0 + 0.1 * (2.0 * torch.rand(B_CHECK, nx, generator=gen, device=dev) - 1.0)
        want = {"open_loop_rollout@pendulum": 1} if nx == 2 else {}
        sol, counts, ms, _ = zoo_fleet_run(label, p, xd, "IPDDP", opts, want)
        zoo_summary(f"{label} (IPDDP, no path constraints)", sol, ms, None, smi)
        dist = (sol.state_trajectory[:, -1] - torch.tensor(target, device=dev)).norm(dim=-1)
        conv = (sol.status_code == 1) | (sol.status_code == 2)
        print(f"[discrete] {label}: launches {counts}; converged {float(conv.double().mean()):.4%}"
              f"; |x_N - target|: max {float(dist.max()):.3e}, median "
              f"{float(dist.median()):.3e}; barrier mu {float(sol.barrier_mu.max()):.3e}  "
              f"[{smi}]")
        if sol.dual_trajectories is not None:
            raise AssertionError(f"{label}: dual maps without path constraints")
    return launches, fleets


def time_discrete_kernels(tt, fleets, smi):
    """Every phase-15 entry's wrapper and device ms, plain ms and bound on
    the operands of the run that drives it: kernels 1 and 2 about random
    trajectories of the car fleet (CAR_B, N = 300) and kernel 1 of the
    LTISystem's (B_MAIN), kernel 4 on the car (CAR_B) and the forklift
    (B_MAIN), kernels 5 and 6 on the car's IPDDP operands (CAR_B). Returns
    ({entry: timing tuple}, {entry: batch})."""
    from cddp_tpu_torch.ops.kernels import ip_rollout, riccati
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    out, at = {}, {}
    car, x0 = fleets["riccati_backward@car"]
    lti, _ = fleets["riccati_backward@lti"]
    dev = x0.device
    for label, prob, B in (("car", car, CAR_B), ("lti", lti, B_MAIN)):
        X, U, back, alpha = stage_inputs(prob, B, torch.Generator(device=dev).manual_seed(SEED))
        out1 = riccati._launch(*back)
        # The plain recursions take 0.5-1.5 s a call at these shapes: one
        # call each, without a warm-up.
        runs = {f"riccati_backward@{label}": (lambda back=back: riccati._launch(*back), 20,
                                              lambda back=back: riccati.riccati_backward_plain(
                                                  *back), 1)}
        work = {f"riccati_backward@{label}": (back, out1, count_ops_steps(
            riccati.riccati_backward_plain, *one(back)) * B)}
        if label == "car":
            consts = rollout_ops.lane_consts(prob)
            fwd = (X[:, :-1], U, out1[0], out1[1], X[:, 0], alpha)
            out2 = rollout_ops._launch(consts, *fwd)
            runs["forward_rollout@car"] = (lambda: rollout_ops._launch(consts, *fwd), 20,
                                           lambda: rollout_ops.forward_rollout_plain(consts,
                                                                                     *fwd), 2)
            work["forward_rollout@car"] = (fwd, out2, count_ops_steps(
                rollout_ops.forward_rollout_plain, consts, *one(fwd)) * B)
        out.update(time_kernels(runs, work, torch.float32, smi, events_ok="wrapper", batch=B))
        at.update({k: B for k in runs})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fl, xf, Uf, dtf = forklift_case(B_MAIN, torch.float32, dev, gen)
    cc = car.get_constraint("ControlConstraint")
    Uc = (2.0 * torch.rand(CAR_B, car.horizon, 2, generator=gen, device=dev) - 1.0) * cc.upper
    for name, mdl, xs, Us, dt, B in (("open_loop_rollout@car", car.model, x0, Uc,
                                      car.timestep, CAR_B),
                                     ("open_loop_rollout@forklift", fl, xf, Uf, dtf, B_MAIN)):
        entry = rollout_ops.model_entry(mdl)
        kernel = (lambda mdl=mdl, entry=entry, xs=xs, Us=Us, dt=dt:  # noqa: E731
                  ip_rollout._launch_open_loop(mdl, entry, xs, Us, dt))
        ops = count_ops_steps(ip_rollout.open_loop_rollout_plain, mdl, xs[:1], Us[:1], dt)
        runs = {name: (kernel, 20, lambda mdl=mdl, xs=xs, Us=Us, dt=dt:
                       ip_rollout.open_loop_rollout_plain(mdl, xs, Us, dt), 1)}
        work = {name: ((xs, Us), (kernel()[:, 1:],), ops * B)}
        out.update(time_kernels(runs, work, torch.float32, smi, events_ok="wrapper", batch=B))
        at[name] = B
    opts = car_options(tt, "IPDDP")
    p, _, back_dense, fwd = stage_ip_inputs(tt, car, CAR_B, gen, opts, iterations=1)
    back = per_pass_layout(back_dense)
    fc = forward_consts(p, opts, False)
    out5, out6 = ip_rollout._launch_forward(fc, *fwd), ric._launch(*back)
    runs = {"ip_forward@car": (lambda: ip_rollout._launch_forward(fc, *fwd), 20,
                               lambda: ip_rollout.ip_forward_plain(fc, *fwd), 1),
            "ipddp_backward@car": (lambda: ric._launch(*back), 20,
                                   lambda: ric.ipddp_backward_plain(*back), 1)}
    work = {"ip_forward@car": (fwd, out5, count_ops_steps(ip_rollout.ip_forward_plain, fc,
                                                    *one(fwd)) * CAR_B),
            "ipddp_backward@car": (backward_operands_read(back), out6, count_ops_steps(
                ric.ipddp_backward_plain, *one(back)) * CAR_B)}
    out.update(time_kernels(runs, work, torch.float32, smi, events_ok="wrapper", batch=CAR_B))
    at.update({k: CAR_B for k in runs})
    return out, at


def discrete_checks(tt, dev):
    """Phase 15's (a); returns {dtype: {entry: err}}."""
    t0 = time.perf_counter()
    errs = {"float64": {}, "float32": {}}
    phase_discrete_kernels(tt, dev, errs)
    print(f"[discrete] (a) done in {time.perf_counter() - t0:.1f} s")
    return errs


def phase_discrete(tt, dev, smi, errs):
    """Phase 15, the discrete car, the forklift, the LTISystem and the IPDDP
    regime without path constraints: (a) every new instantiation against
    its plain version at B_CHECK, float64 and float32, and the car's
    per-pass solves against the plain drivers; (b)-(d) the fleets (each
    entry's times and bound on its run's operands follow in
    ``time_discrete_kernels``); ``errs``: (a)'s (``discrete_checks``), which
    ``main`` runs earlier. Returns ({entry: launches}, {dtype: {entry:
    err}}, {entry: (problem, x0) of the run that drives it})."""
    t0 = time.perf_counter()
    errs = checked_errs("phase 15", errs)
    launches, fleets = phase_discrete_fleets(tt, dev, smi)
    print(f"[discrete] checks and fleets done in {time.perf_counter() - t0:.1f} s")
    return launches, errs, fleets


# --- the quadrotor family (phase 16) ------------------------------------------------

QUAD_B = 65536  # the quadrotor and QuadrotorRate fleets' batch
QUAD_N = 60  # the quadrotor golden's horizon (tests/make_goldens.py:69-84)
RATE_N = 50  # the QuadrotorRate fleet's
BENCH_N = 100  # bench_quadrotor.py's single solve
FIG8_N = 150  # the figure-8 anchor (tests/test_parity_anchors.py:72-120)
QUAD_ITERS = 10
QUAD_CHECK_ITERS = 5  # (a)'s per-pass IPDDP solves against the plain driver, float64
# (a)'s per-pass CLDDP solves: their plain driver's line search rolls the
# plain rk4 model out trial by trial, 28k small torch launches a trial at N
# = 60, so over five iterations each model's check took 20-40 s of an H100
# host; three iterations hold the same kernels and driver paths.
QUAD_CLDDP_CHECK_ITERS = 3
# (a)'s checks of kernels 1, 2 and 4 run at the fleets' horizons on the
# first QUAD_KERNEL_B instances: the plain Riccati recursion's 81-set BoxQP
# moves (B, 81, 4, 4) tensors a step, and at B_CHECK and N = 60 its four
# runs a model took 24 s more than at N = 20 on an H100's host.
QUAD_KERNEL_B = 1024
# (a)'s per-pass solves run on the first QUAD_CHECK_B of B_CHECK instances:
# their plain drivers at B_CHECK took most of (a)'s 148 s on an H100's host.
QUAD_CHECK_B = 1024
# The quadrotor's MSIPDDP and LogDDP plain drivers at B_CHECK (at five
# iterations 4.0 and 3.8 s of an NVIDIA H100 80GB HBM3 machine at 700 W).
QUAD_PLAIN_ITERS = 2
QUAD_DRIVE_ITERS = 2  # the QuadrotorRate CLDDP run that drives kernels 1 and 2 at 10x4
FIG8_ITERS = 300  # the figure-8 anchor's budget
# The single solve takes 3.5 s at B = 1 on an H100 (kernel 6 walks the
# horizon on one thread): the median of BENCH_REPS after a warm-up. Its
# plain drivers took 40.5 and 46.1 s for five iterations there (tens of
# thousands of small torch launches an iteration at B = 1), so they are not
# run: the per-pass path is held to the plain driver in (a) and (b), and
# the float32 solve to the float64 one (``phase_quad_single``). Ten
# timed solves took 43.3 s of the script (NVIDIA H100 80GB HBM3, 700 W),
# three 17.8 s with the warm-up; one is timed.
BENCH_REPS = 1
# Seeds of the staged operands (``quad_stage``): hover controls, each
# entry moved by up to this share of its box width, so that A and B differ
# between instances and steps (hover seeds keep every instance at hover:
# x0 moves only the position, and hover thrust cancels gravity).
STAGE_WIDTH = 1.0 / 16.0
GOLDEN = Path(__file__).resolve().parent / "tests" / "goldens" / "quadrotor_ipddp.npz"
# Phase 16's kernels, each an entry of the kernels' JSON line: (entry name,
# dispatch_log name, kernel, model, launcher without its type suffix).
QUAD_ENTRIES = tuple(
    (name, logged or name, name.split("@")[0].replace("_track", ""), name.split("@")[1],
     launcher)
    for name, logged, launcher in (
        ("riccati_backward@quadrotor", "riccati_backward@13x4", "cddp_riccati_backward_13x4"),
        ("riccati_backward@quadrotor_rate", "riccati_backward@10x4",
         "cddp_riccati_backward_10x4"),
        ("forward_rollout@quadrotor", None, "cddp_forward_rollout_quadrotor"),
        ("forward_rollout@quadrotor_rate", None, "cddp_forward_rollout_quadrotor_rate"),
        ("open_loop_rollout@quadrotor", None, "cddp_open_loop_rollout_quadrotor"),
        ("open_loop_rollout@quadrotor_rate", None, "cddp_open_loop_rollout_quadrotor_rate"),
        ("ip_forward@quadrotor", None, "cddp_ip_forward_quadrotor_m8"),
        ("ip_forward_track@quadrotor", None, "cddp_ip_forward_quadrotor_m8_track"),
        ("ip_forward@quadrotor_rate", None, "cddp_ip_forward_quadrotor_rate_m8"),
        ("ipddp_backward@quadrotor", "ipddp_backward@13x4x8", "cddp_ipddp_backward_13x4x8"),
        ("ipddp_backward@quadrotor_rate", "ipddp_backward@10x4x8",
         "cddp_ipddp_backward_10x4x8"),
    ))


def quad_problem(tt, dtype, device, horizon=None, goal=(1.5, 0.0, 1.0), box=9.0,
                 tracking=False):
    """The quadrotor golden's problem (tests/make_goldens.py:69-84): rk4,
    mass 1, inertia diag(0.01, 0.01, 0.02), arm 0.2; N = QUAD_N, dt = 0.02,
    Q = 0.1 on the quaternion's vector part, R = 0.1 I, Qf = diag(500 x3, 1
    x4, 10 x3, 0 x3), from hover at the origin to ``goal`` at hover, the
    rotor box [0, ``box``]^4 (bench_quadrotor.py's single solve: N = 100,
    the goal (3, 0, 2), the box [0, 5]). ``tracking``: the straight line
    from x0 to the goal as the per-step reference. Its tensors and model
    are in ``dtype``, as a solve casts them (the kernels' plain versions
    take the problem as it is)."""
    from cddp_tpu_torch.models import quadrotor
    from cddp_tpu_torch.solvers.base import canonicalize_problem_dtype

    N = horizon or QUAD_N
    kw = dict(device=device, dtype=dtype)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    x0 = f64([0.0, 0.0, 0.0, 1.0] + [0.0] * 9)
    g = x0.clone()
    g[:3] = f64(goal)
    Q = f64([0.0] * 4 + [0.1] * 3 + [0.0] * 6).diag()
    Qf = f64([500.0] * 3 + [1.0] * 4 + [10.0] * 3 + [0.0] * 3).diag()
    frac = torch.linspace(0.0, 1.0, N + 1, dtype=torch.float64)[:, None]
    obj = tt.quadratic_objective(Q, 0.1 * torch.eye(4, dtype=torch.float64), Qf, g, 0.02,
                                 reference_states=x0 * (1.0 - frac) + g * frac if tracking
                                 else None, **kw)
    model = quadrotor(mass=1.0, inertia=f64([0.01, 0.01, 0.02]).diag(), arm_length=0.2,
                      integration_type="rk4", device=device)
    prob = tt.problem(model, obj, x0, N, 0.02, **kw).add_constraint(
        "ControlConstraint", tt.control_constraint([0.0] * 4, [box] * 4, **kw))
    return canonicalize_problem_dtype(prob)


def bench_problem(tt, dtype, device):
    """bench_quadrotor.py's problem (:17-40): the golden's quadrotor at N =
    BENCH_N to (3, 0, 2), the rotor box [0, 5]^4."""
    return quad_problem(tt, dtype, device, BENCH_N, goal=(3.0, 0.0, 2.0), box=5.0)


def rate_problem(tt, dtype, device, horizon=None):
    """(e)'s QuadrotorRate fleet: rk4 (mass 1, gravity 9.81), N = RATE_N,
    dt = 0.02, from hover with q = (1, 0, 0, 0) to (1, 0, 1) at hover, Q =
    0.1 I on position and velocity, R = 0.1 I, Qf = diag(100 x3, 10 x3, 1
    x4), the box [0, 20] x [-5, 5]^3 (the model's max_thrust and max_rate)."""
    from cddp_tpu_torch.models import QuadrotorRate
    from cddp_tpu_torch.solvers.base import canonicalize_problem_dtype

    kw = dict(device=device, dtype=dtype)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    x0 = f64([0.0] * 6 + [1.0, 0.0, 0.0, 0.0])
    g = x0.clone()
    g[0], g[2] = 1.0, 1.0
    obj = tt.quadratic_objective(f64([0.1] * 6 + [0.0] * 4).diag(),
                                 0.1 * torch.eye(4, dtype=torch.float64),
                                 f64([100.0] * 3 + [10.0] * 3 + [1.0] * 4).diag(), g, 0.02, **kw)
    prob = tt.problem(QuadrotorRate(integration_type="rk4", device=device), obj, x0,
                      horizon or RATE_N, 0.02, **kw).add_constraint(
        "ControlConstraint", tt.control_constraint([0.0, -5.0, -5.0, -5.0],
                                                   [20.0, 5.0, 5.0, 5.0], **kw))
    return canonicalize_problem_dtype(prob)


def figure8_problem(tt, dtype, device, horizon=None):
    """The figure-8 anchor (tests/test_parity_anchors.py:72-120): the
    quadrotor (mass 1.2, inertia diag(7.782e-3, 7.782e-3, 1.439e-2), arm
    0.165, rk4) tracking a figure-8 of 3 m at 2 m altitude over N = FIG8_N
    steps of 0.02 s, Q = Qf = I on position and quaternion, R = 0.01 I, the
    rotor box [0, 4]^4, x0 the reference's first point."""
    from cddp_tpu_torch.models import quadrotor

    N = horizon or FIG8_N
    kw = dict(device=device, dtype=dtype)
    Q = torch.tensor([1.0] * 7 + [0.0] * 6, dtype=torch.float64).diag()
    omega = 2.0 * math.pi / (N * 0.02)
    ts = torch.arange(N + 1, dtype=torch.float64) * 0.02
    refs = torch.zeros(N + 1, 13, dtype=torch.float64)
    refs[:, 0] = 3.0 * torch.cos(omega * ts)
    refs[:, 1] = 3.0 * torch.sin(omega * ts) * torch.cos(omega * ts)
    refs[:, 2], refs[:, 3] = 2.0, 1.0
    obj = tt.quadratic_objective(Q, 0.01 * torch.eye(4, dtype=torch.float64), Q, refs[-1],
                                 0.02, reference_states=refs, **kw)
    model = quadrotor(mass=1.2, inertia=torch.tensor([7.782e-3, 7.782e-3, 1.439e-2],
                                                     dtype=torch.float64).diag(),
                      arm_length=0.165, integration_type="rk4", device=device)
    return tt.problem(model, obj, refs[0], N, 0.02, **kw).add_constraint(
        "ControlConstraint", tt.control_constraint([0.0] * 4, [4.0] * 4, **kw))


def quad_options(tt, iterations):
    """The quadrotor golden's options (make_goldens.py:151-158): tolerance
    1e-4, acceptable 1e-5, initial regularization 1e-4; ``iterations``."""
    from cddp_tpu_torch.options import RegularizationOptions

    return tt.CDDPOptions(max_iterations=iterations, tolerance=1e-4, acceptable_tolerance=1e-5,
                          regularization=RegularizationOptions(initial_value=1e-4))


def bench_options(tt, iterations=150):
    """bench_quadrotor.py's options (:59-71): 150 iterations, tolerance 1e-4,
    no acceptable exit, 15 line-search rungs, initial regularization 1e-4,
    the best merit over the ladder (``enable_parallel``), the fused backward
    engine, the IPOPT barrier rule with mu_update_factor 0.2."""
    from cddp_tpu_torch.options import LineSearchOptions, RegularizationOptions

    return tt.CDDPOptions(
        max_iterations=iterations, tolerance=1e-4, acceptable_tolerance=0.0,
        line_search=LineSearchOptions(max_iterations=15),
        regularization=RegularizationOptions(initial_value=1e-4), enable_parallel=True,
        backward_engine="fused", ipddp=tt.IPDDPOptions(barrier=tt.BarrierOptions(
            strategy=tt.BarrierStrategy.IPOPT, mu_update_factor=0.2)))


def hover(prob, B=None):
    """Hover controls of the problem's model, (N, nu), or (B, N, nu) given
    B: each rotor m g / 4 for the quadrotor (bench_quadrotor.py:72), the
    thrust m g and no rates for QuadrotorRate."""
    m = prob.model
    w = float(m.mass) * float(m.gravity)
    u = [w / 4.0] * 4 if type(m).__name__ == "Quadrotor" else [w, 0.0, 0.0, 0.0]
    U = torch.tensor(u, dtype=prob.x0.dtype, device=prob.x0.device).expand(prob.horizon, -1)
    return U if B is None else U.expand(B, -1, -1)


def near_hover(prob, B, gen, width=STAGE_WIDTH):
    """Controls (B, N, nu): hover, each entry moved by up to ``width`` / 2
    of its box's width, uniformly."""
    cc = prob.get_constraint("ControlConstraint")
    noise = torch.rand(B, prob.horizon, prob.control_dim, generator=gen,
                       device=prob.x0.device, dtype=prob.x0.dtype) - 0.5
    return hover(prob, B) + width * (cc.upper - cc.lower) * noise


def assert_varies(label, *ts):
    """Each (B, N, ...) operand differs from instance 0's at every other
    instance and from step 0's at every other step, so that a kernel that
    read another instance's or step's values would not pass its check."""
    for t in ts:
        by_instance = (t != t[:1]).flatten(1).any(1)[1:]
        by_step = (t != t[:, :1]).flatten(2).any(2)[:, 1:]
        if not (bool(by_instance.all()) and bool(by_step.all())):
            raise AssertionError(f"{label}: an operand of shape {tuple(t.shape)} repeats across "
                                 f"{int((~by_instance).sum())} instances and "
                                 f"{int((~by_step).sum())} (instance, step) pairs")


def quad_stage(prob, B, gen):
    """Kernels 1 and 2's operands (``stage_inputs``) about trajectories from
    ``fleet_x0`` under ``near_hover`` controls, which stay near hover over
    the fleets' horizons (controls a quarter of the box width from hover
    tumbled the quadrotor within N = 60 steps), at random regularizations
    with a random ladder step; A and B differ between instances and steps
    (``assert_varies``). Returns (X, U, backward args, alpha)."""
    X, U, back, alpha = stage_inputs(prob, B, gen, near_hover(prob, B, gen))
    assert_varies(f"{type(prob.model).__name__} CLDDP operands", back[0], back[1])
    return X, U, back, alpha


def quad_ip_stage(tt, prob, B, gen, opts):
    """Kernels 4, 5 and 6's operands as a fleet's IPDDP run gives them after
    its first iteration: ``stage_ip_inputs`` with one plain iteration from
    ``near_hover`` seeds, A and B differing between instances and steps."""
    staged = stage_ip_inputs(tt, prob, B, gen, opts, iterations=1, U0=near_hover(prob, B, gen))
    assert_varies(f"{type(prob.model).__name__} IPDDP operands", *staged[2][:2])
    return staged


QUAD_MODELS = ("quadrotor", "quadrotor_rate")


def quad_maker(model):
    """The problem builder of a phase-16 model's fleet."""
    return quad_problem if model == "quadrotor" else rate_problem


def phase_quad_kernels(tt, dev, errs):
    """Phase 16's (a) kernel checks (``phase_lane_kernels``) on the
    quadrotor and QuadrotorRate: kernels 1, 2 and 4 on QUAD_KERNEL_B
    instances about trajectories near hover (``quad_stage``), kernels 5 and
    6 after one plain IPDDP iteration from such seeds (``quad_ip_stage``),
    and kernel 5's tracking form on the quadrotor's operands with a line
    from x0 to the goal as its reference."""
    phase_lane_kernels(tt, dev, errs, "quadrotor", QUAD_MODELS, quad_maker, quad_stage,
                       quad_ip_stage, lambda: quad_options(tt, QUAD_ITERS), QUAD_KERNEL_B,
                       SEED + 61, track={"quadrotor": lambda dtype: quad_problem(
                           tt, dtype, dev, tracking=True)})


def phase_lane_kernels(tt, dev, errs, label, models, maker, stage, ip_stage, options,
                       kernel_b, seed, track=None, riccati_f32_n=None, plain=None):
    """(a) every new instantiation against its plain version, in float64
    (within 1e-9 + ZOO_RTOL |v| plus twice the plain version's move from
    inputs one ulp up, ``check``) and float32 (``check``'s float64-truth
    rule on the median and the 99th percentile; kernel 1's tail by its share
    of BoxQP ties, ``ties``), at the fleets' horizons, on operands that differ between
    instances and steps: kernels 1 and 2 on QUAD_KERNEL_B instances about
    trajectories near hover (``quad_stage``), kernel 4 from them, kernels 5 (with and without the slack SOC) and 6 at B_CHECK on the
    operands the plain IPDDP driver stages after an iteration
    (``quad_ip_stage``; kernel 6 on both drivers' layouts, same bits), on
    each of ``models`` (``maker(model)`` builds its problem, ``stage`` and
    ``ip_stage`` its operands, ``options()`` its IPDDP options), and kernel
    5's tracking form on the operands of each model of ``track`` ({model:
    its tracking problem in a dtype}); kernel 1 not on a model it leaves out
    (``riccati.LEFT_OUT_MODELS``), and in float32 on each model of
    ``riccati_f32_n`` ({model: N}) on operands staged at that horizon
    (``maker(model, N)``, their own generator); errors into ``errs`` under
    "<kernel>@<model>", and with ``plain`` each float32 plain version's
    host ms there (``time_lane_kernels`` reads them: at these shapes each
    takes about a second a call, a run of 5-6 s a model)."""
    from cddp_tpu_torch.models import rollout
    from cddp_tpu_torch.ops.kernels import ip_rollout, riccati
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    as64 = lambda ts: tuple(t.double() if isinstance(t, torch.Tensor)  # noqa: E731
                            and t.is_floating_point() else t for t in ts)
    t0 = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        exact = dtype == torch.float64
        gen = torch.Generator(device=dev).manual_seed(seed)

        def plain_run(name, fn):
            """fn(), its host ms into ``plain`` in the float32 pass."""
            if exact or plain is None:
                return fn()
            out = timed_plain(fn)
            plain[name] = LAST_PLAIN_MS[0]
            return out

        def forward_checks(prob, fwd, name, opts):
            err = 0.0
            for soc in (False, True):
                fc = forward_consts(prob, opts, soc)
                got = ip_rollout._launch_forward(fc, *fwd)
                want = (plain_run(name, lambda: ip_rollout.ip_forward_plain(fc, *fwd))
                        if not soc else ip_rollout.ip_forward_plain(fc, *fwd))
                err = max(err, check(
                    f"{name} slack_soc={soc}", got, want,
                    None if exact else ip_rollout.ip_forward_plain(
                        forward_consts(prob, opts, soc, f64=True), *as64(fwd)),
                    rtol=ZOO_RTOL, quantiles=not exact,
                    moved=ip_rollout.ip_forward_plain(fc, *ulp_up(fwd)) if exact else None))
                print(f"[{label} {tag}] {name} slack_soc={soc}: feasible on "
                      f"{float(got[-1].double().mean()):.2%} of {B_CHECK}")
            errs[tag][name] = err

        for model in models:
            prob = maker(model)(tt, dtype, dev)
            X, U, back, alpha = stage(prob, kernel_b, gen)
            want = riccati.riccati_backward_plain(*back)
            k1 = back
            if not exact and model in (riccati_f32_n or {}):
                k1 = stage(maker(model, riccati_f32_n[model])(tt, dtype, dev), kernel_b,
                           torch.Generator(device=dev).manual_seed(seed + 1))[2]
            if rollout_ops.model_entry(prob.model).cuda_name not in riccati.LEFT_OUT_MODELS:
                name = f"riccati_backward@{model}"
                errs[tag][name] = check(
                    f"riccati_backward@{model} (N={k1[0].shape[1]})", riccati._launch(*k1),
                    plain_run(name, lambda: riccati.riccati_backward_plain(*k1)) if k1 is back
                    else riccati.riccati_backward_plain(*k1),
                    None if exact else riccati.riccati_backward_plain(*as64(k1)), rtol=ZOO_RTOL,
                    quantiles=not exact, ties=not exact,
                    moved=riccati.riccati_backward_plain(*ulp_up(k1)) if exact else None)
            consts = rollout_ops.lane_consts(prob)
            fwd = (X[:, :-1], U, want[0], want[1], X[:, 0], alpha)
            errs[tag][f"forward_rollout@{model}"] = check(
                f"forward_rollout@{model}", rollout_ops._launch(consts, *fwd),
                plain_run(f"forward_rollout@{model}",
                          lambda: rollout_ops.forward_rollout_plain(consts, *fwd)),
                None if exact else rollout_ops.forward_rollout_plain(
                    dataclasses.replace(consts_f64(consts), model=copy.deepcopy(
                        prob.model).double()), *as64(fwd)),
                rtol=ZOO_RTOL, quantiles=not exact,
                moved=rollout_ops.forward_rollout_plain(consts, *ulp_up(fwd)) if exact else None)
            mdl, dt, entry = prob.model, prob.timestep, rollout_ops.model_entry(prob.model)
            got = ip_rollout._launch_open_loop(mdl, entry, X[:, 0], U, dt)
            if not torch.equal(got, rollout(mdl, X[:, 0], U, dt)):
                raise AssertionError(f"open_loop_rollout@{model}: the public rollout differs")
            errs[tag][f"open_loop_rollout@{model}"] = check(
                f"open_loop_rollout@{model}", (got,),
                (plain_run(f"open_loop_rollout@{model}",
                           lambda: ip_rollout.open_loop_rollout_plain(mdl, X[:, 0], U, dt)),),
                None if exact else (ip_rollout.open_loop_rollout_plain(
                    copy.deepcopy(mdl).double(), X[:, 0].double(), U.double(), dt),),
                rtol=ZOO_RTOL, quantiles=not exact, moved=(ip_rollout.open_loop_rollout_plain(
                    mdl, *ulp_up((X[:, 0], U)), dt),) if exact else None)
            opts = options()
            p, _, back, fwd = ip_stage(tt, prob, B_CHECK, gen, opts)
            forward_checks(p, fwd, f"ip_forward@{model}", opts)
            if model in (track or {}):
                forward_checks(track[model](dtype).replace(x0=p.x0), fwd,
                               f"ip_forward_track@{model}", opts)
            got = ric._launch(*back)
            errs[tag][f"ipddp_backward@{model}"] = check(
                f"ipddp_backward@{model}", got,
                plain_run(f"ipddp_backward@{model}", lambda: ric.ipddp_backward_plain(*back)),
                None if exact else ric.ipddp_backward_plain(*as64(back)), rtol=ZOO_RTOL,
                quantiles=not exact,
                moved=ric.ipddp_backward_plain(*ulp_up(back)) if exact else None)
            if not all(torch.equal(a, b) for a, b in zip(got, ric._launch(*per_pass_layout(back)))):
                raise AssertionError(f"ipddp_backward@{model}: the per-pass driver's layout "
                                     "gives other bits")
        print(f"[{label} {tag}] kernels held at {time.perf_counter() - t0:.1f} s")


def quad_check_seeds(tt, model, dev):
    """(a)'s per-pass solves' problem (float64), x0 (QUAD_CHECK_B seeded
    ``fleet_x0``) and hover controls, as both processes build them."""
    prob = quad_maker(model)(tt, torch.float64, dev)
    x0 = fleet_x0(prob, QUAD_CHECK_B, torch.Generator(device=dev).manual_seed(SEED + 63))
    return prob, x0, hover(prob, QUAD_CHECK_B)


def quad_check_options(tt, solver):
    """(a)'s per-pass options of ``solver`` and its plain driver's."""
    opts = quad_options(tt, QUAD_CLDDP_CHECK_ITERS if solver == "CLDDP" else QUAD_CHECK_ITERS)
    plain = (opts.replace(backward_engine="scan") if solver == "CLDDP"
             else plain_ip_options(tt, opts))
    return opts, plain


def quad_plain_refs(tt, dev):
    """The plain drivers' solutions that phase 16 holds its per-pass float64
    solves to: (a)'s CLDDP (and from x0 one ulp up) and IPDDP on each
    model's ``quad_check_seeds``, and (b)'s golden. Returns {key: value}."""
    from cddp_tpu_torch.parallel.batch import batched_solve

    out = {}
    t0 = time.perf_counter()
    prob = quad_problem(tt, torch.float64, dev)
    out["golden"] = tt.solve(prob.replace(x0=prob.x0[None]), "IPDDP",
                             plain_ip_options(tt, quad_options(tt, 120)), U0=hover(prob, 1))
    print(f"golden's plain driver done at {time.perf_counter() - t0:.1f} s", flush=True)
    for model in QUAD_MODELS:
        prob, x0, U0 = quad_check_seeds(tt, model, dev)
        out[("x0", model)] = x0
        for solver in ("CLDDP", "IPDDP"):
            plain = quad_check_options(tt, solver)[1]
            out[(solver, model)] = batched_solve(prob, x0, solver, plain, U0_batch=U0)
        out[("CLDDP moved", model)] = batched_solve(
            prob, ulp_up((x0,))[0], "CLDDP", quad_check_options(tt, "CLDDP")[1], U0_batch=U0)
        print(f"{model}'s plain drivers done at {time.perf_counter() - t0:.1f} s", flush=True)
    return out


class Side:
    """Work of ``SIDE_RUNS[kind]`` in a process of its own (this script with
    ``--side KIND PATH``) on the same card, whose result ``main`` reads when
    it needs it: phases 16, 17 and 18's plain references
    (``quad_plain_refs``, ``attitude_plain_refs``, ``sc_plain_refs``: plain
    drivers only, started beside the kernels' build) and phases 7, 9, 12,
    13, 14 and 15's kernel checks (``side_checks``, ``zoo_side_checks``,
    started after it). Each runs tens of thousands of small torch launches
    beside the main process's checks instead of after them, and none of it
    is timed against the card."""

    def __init__(self, kind):
        self.kind = kind
        self._dir = tempfile.TemporaryDirectory(prefix="chip_smoke_refs_")
        self._path = Path(self._dir.name) / "refs.pt"
        self._log = open(Path(self._dir.name) / "log.txt", "w+")
        self._proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--side", kind,
             str(self._path)], stdout=self._log, stderr=subprocess.STDOUT)
        self._out, self._seen = None, 0

    def _echo(self):
        """Print the lines the process has logged since the last call."""
        self._log.seek(self._seen)
        text = self._log.read()
        self._seen = self._log.tell()
        for line in text.splitlines():
            print(f"[{self.kind} side] {line}")

    def part(self, key):
        """A view of one part of a process that runs several
        (``SIDE_PARTS``): ``result`` is that part, read as soon as the
        process has saved it; ``close`` leaves the process to the view's
        owner."""
        def result(dev):
            saved = part_path(self._path, key)
            while not saved.exists() and self._proc.poll() is None:
                time.sleep(0.5)
            if saved.exists():
                self._echo()
                return torch.load(saved, map_location=dev, weights_only=False)
            return self.result(dev)[key]  # the process ended without it: its log and status

        return types.SimpleNamespace(result=result, close=lambda: None)

    def result(self, dev):
        """The references on ``dev``, once the process has ended."""
        if self._out is not None:
            return self._out
        rc = self._proc.wait(timeout=900)
        self._echo()
        if rc != 0:
            raise AssertionError(f"the {self.kind} side process exited with status {rc}")
        out = torch.load(self._path, map_location=dev, weights_only=False)
        if not out:
            raise AssertionError(f"the {self.kind} side process returned nothing")
        self._out = out
        return out

    def close(self):
        """End the process if it still runs, and remove its files (once)."""
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        if not self._log.closed:
            self._log.close()
            self._dir.cleanup()


def part_path(path, part):
    """Where a side process saves one part of its result (``SIDE_PARTS``)."""
    return Path(path).with_name(f"{part}.pt")


def side_main(kind, path):
    """The ``--side KIND PATH`` process: ``SIDE_RUNS[kind]`` on the card (or
    each of ``SIDE_PARTS[kind]`` in turn, by name), its result saved to
    ``path``. The plain references run plain drivers only and build no
    kernel: ``main`` starts them beside the kernels' build."""
    import cddp_tpu_torch as tt
    from cddp_tpu_torch.ops.kernels import build

    def refuse():
        raise RuntimeError("the plain references' process builds and launches no kernel")

    if kind not in CHECK_SIDES:
        build.library = refuse
    dev = torch.device("cuda", 0)
    if kind in SIDE_PARTS:
        out = {}
        for part in SIDE_PARTS[kind]:
            out[part] = SIDE_RUNS[part](tt, dev)
            torch.cuda.synchronize()
            torch.save(out[part], f"{path}.{part}")
            os.replace(f"{path}.{part}", part_path(path, part))  # whole, once there
    else:
        out = SIDE_RUNS[kind](tt, dev)
    torch.cuda.synchronize()
    torch.save(out, path)


def quad_kernel_solves(tt, dev):
    """(a)'s per-pass float64 solves, CLDDP (kernels 1 and 2) and IPDDP
    (kernels 4, 6 and 5), of both models on ``quad_check_seeds``, each run's
    launches checked. Returns {(solver, model): (Solution, launches, x0)}."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    out = {}
    for model in QUAD_MODELS:
        prob, x0, U0 = quad_check_seeds(tt, model, dev)
        nx = prob.state_dim
        for solver, want in (("CLDDP", {f"riccati_backward@{nx}x4", f"forward_rollout@{model}"}),
                             ("IPDDP", {f"open_loop_rollout@{model}", f"ipddp_backward@{nx}x4x8",
                                        f"ip_forward@{model}"})):
            dispatch_log.reset()
            sol = batched_solve(prob, x0, solver, quad_check_options(tt, solver)[0], U0_batch=U0)
            torch.cuda.synchronize()
            counts = dict(dispatch_log.launches)
            if set(counts) != want:
                raise AssertionError(f"{model} {solver} per pass, float64: launches {counts}, "
                                     f"not {sorted(want)}")
            out[(solver, model)] = (sol, counts, x0)
    return out


def check_quad_solves(solves, refs):
    """(a)'s per-pass solves against the plain drivers: every status and
    iteration count equal, X, U and cost within 1e-8 (CLDDP plus
    MOVE_FACTOR times the plain driver's move from x0 one ulp up), the
    duals, slacks and mu too for IPDDP."""
    for (solver, model), (kern, counts, x0) in solves.items():
        if not torch.equal(x0, refs[("x0", model)]):
            raise AssertionError(f"{model}: the plain references ran from other x0")
        plain = refs[(solver, model)]
        if solver == "CLDDP":
            check_solve_f64(f"{model} per-pass", kern, plain,
                            moved=lambda model=model: refs[("CLDDP moved", model)])
        else:
            check_ip_solve(f"{model} per-pass", kern, plain, True, dual_rtol=1e-8)
        iters = QUAD_CLDDP_CHECK_ITERS if solver == "CLDDP" else QUAD_CHECK_ITERS
        print(f"[quadrotor float64] {model} {solver} per pass at N="
              f"{kern.state_trajectory.shape[1] - 1}, B={x0.shape[0]}, {iters} iterations: "
              f"launches {counts}; iterations "
              f"{torch.bincount(kern.iterations_completed.long()).tolist()}")


def quad_golden_kernel(tt, dev):
    """(b)'s per-pass run: the quadrotor_ipddp golden's problem and options
    (tests/make_goldens.py:69-84, :151-158) in float64 through ``tt.solve``
    from hover controls, its launches (kernels 4, 6 and 5) counted. Returns
    (Solution, launches, host ms)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log

    prob = quad_problem(tt, torch.float64, dev)
    dispatch_log.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kern = tt.solve(prob.replace(x0=prob.x0[None]), "IPDDP", quad_options(tt, 120),
                    U0=hover(prob, 1))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(dispatch_log.launches)
    want = {"open_loop_rollout@quadrotor", "ipddp_backward@13x4x8", "ip_forward@quadrotor"}
    if set(counts) != want or counts["open_loop_rollout@quadrotor"] != 1:
        raise AssertionError(f"the quadrotor golden per pass: launches {counts}")
    return kern, counts, ms


def check_quad_golden(golden, plain):
    """(b): the per-pass golden run against the plain driver on the card
    (``check_ip_solve``: status and iterations equal, values within 1e-8),
    at the golden's status and iteration count, and its deviation from
    tests/goldens/quadrotor_ipddp.npz."""
    import numpy as np

    kern, counts, ms = golden
    check_ip_solve("quadrotor golden per-pass", kern, plain, True, dual_rtol=1e-8)
    g = np.load(GOLDEN)
    status, its = int(kern.status_code[0]), int(kern.iterations_completed[0])
    if (status, its) != (int(g["status"]), int(g["iterations"])):
        raise AssertionError(f"the quadrotor golden on the card: status {status} after {its} "
                             f"iterations, the golden's {int(g['status'])} after "
                             f"{int(g['iterations'])}")
    dev_of = lambda t, w: float(np.abs(t[0].cpu().numpy() - w).max())  # noqa: E731
    print(f"[quadrotor] golden quadrotor_ipddp, float64, per pass: status {status}, {its} "
          f"iterations (the golden's), {ms:.1f} ms (beside the plain references' process); "
          f"launches {counts}; against the golden: cost {float(kern.final_objective[0]):.10f} "
          f"({float(g['cost']):.10f}), max |X - X_g| {dev_of(kern.state_trajectory, g['X']):.3e}"
          f", max |U - U_g| {dev_of(kern.control_trajectory, g['U']):.3e}")


def quad_single64(tt, dev):
    """(c)'s reference: bench_quadrotor.py's single solve per pass in
    float64 (kernels 4, 6 and 5 in their float64 builds)."""
    p64 = bench_problem(tt, torch.float64, dev)
    return tt.solve(p64.replace(x0=p64.x0[None]), "IPDDP", bench_options(tt), U0=hover(p64, 1))


# (c)'s rule for the float32 single solve against the float64 one: the same
# status, and the final cost within this relative distance (``cost_share``'s
# rule of equal cost). The two ran 49 and 53 iterations to costs 7.9e-7
# apart on an H100 (PERF.md).
SINGLE_COST_RTOL = 1e-4


def phase_quad_single(tt, dev, smi, sol64):
    """(c) bench_quadrotor.py's single solve (``bench_problem``,
    ``bench_options``, float32, from hover controls) per pass: its launches
    (kernels 4, 6 and 5), status, iterations, final cost, goal error and ms
    a solve, the median of BENCH_REPS on the host clock after a warm-up;
    held to its float64 run ``sol64`` (``quad_single64``): the same status
    and the final cost within SINGLE_COST_RTOL. Returns (the problem,
    options, controls, solution, median ms, launches)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log

    prob = bench_problem(tt, torch.float32, dev)
    p1, U0, opts = prob.replace(x0=prob.x0[None]), hover(prob, 1), bench_options(tt)
    ms = []
    for rep in range(BENCH_REPS + 1):
        dispatch_log.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = tt.solve(p1, "IPDDP", opts, U0=U0)
        torch.cuda.synchronize()
        if rep == 0:  # the warm-up
            counts = dict(dispatch_log.launches)
        else:
            ms.append((time.perf_counter() - t0) * 1e3)
    if set(counts) != {"open_loop_rollout@quadrotor", "ipddp_backward@13x4x8",
                       "ip_forward@quadrotor"}:
        raise AssertionError(f"the single solve: launches {counts}")
    med = sorted(ms)[len(ms) // 2]
    goal = prob.objective.reference_state
    err = float((sol.state_trajectory[0, -1, :3] - goal[:3]).norm())
    its = int(sol.iterations_completed[0])
    print(f"[quadrotor] single solve (bench_quadrotor.py, N={prob.horizon}, float32, per pass):"
          f" status {sol.status_messages()[0]} ({int(sol.status_code[0])}), {its} iterations, "
          f"final cost {float(sol.final_objective[0]):.6f}, goal error {err:.4e}; "
          f"{med:.2f} ms a solve (median of {BENCH_REPS} after a warm-up; min {min(ms):.2f}, "
          f"max {max(ms):.2f}); launches {counts}  [{smi}]")
    if not bool(sol.state_trajectory.isfinite().all()):
        raise AssertionError("the single solve: non-finite states")

    rel = abs(float(sol.final_objective[0]) - float(sol64.final_objective[0])) / abs(
        float(sol64.final_objective[0]))
    dx = float((sol.state_trajectory.double() - sol64.state_trajectory).abs().max())
    print(f"[quadrotor] single solve per pass in float64: status {int(sol64.status_code[0])}, "
          f"{int(sol64.iterations_completed[0])} iterations, cost "
          f"{float(sol64.final_objective[0]):.7f}, goal error "
          f"{float((sol64.state_trajectory[0, -1, :3] - goal[:3].double()).norm()):.4e}; "
          f"float32 against it: rel cost {rel:.3e} (<= {SINGLE_COST_RTOL:g}, status equal), "
          f"max |dX| {dx:.3e}")
    if int(sol.status_code[0]) != int(sol64.status_code[0]) or not rel <= SINGLE_COST_RTOL:
        raise AssertionError(f"the float32 single solve: status {int(sol.status_code[0])}, rel "
                             f"cost {rel:.3e} against float64's status "
                             f"{int(sol64.status_code[0])}")
    return p1, opts, U0, sol, med, counts


def quad_fleet_run(label, prob, x0, solver, opts, want, smi):
    """``zoo_fleet_run`` from hover controls, with the run's converged
    share, iterations, ms, solves/s, peak device memory and distance of
    the final position to the goal. Returns (Solution, launches)."""
    B = x0.shape[0]
    torch.cuda.reset_peak_memory_stats()
    sol, counts, ms, _ = zoo_fleet_run(label, prob, x0, solver, opts, want, U0=hover(prob, B))
    peak = torch.cuda.max_memory_allocated() / 2**30
    conv = (sol.status_code == 1) | (sol.status_code == 2)
    its = sol.iterations_completed.double()
    dist = (sol.state_trajectory[:, -1, :3] - prob.objective.reference_state[:3]).norm(dim=-1)
    print(f"[quadrotor] {label}, B={B}, {opts.max_iterations} iterations: converged "
          f"{float(conv.double().mean()):.4%}, statuses "
          f"{torch.bincount(sol.status_code.long(), minlength=5).tolist()}, iterations mean "
          f"{float(its.mean()):.3f} max {int(its.max())}; {ms:.2f} ms ({B / ms * 1e3:.1f} "
          f"solves/s); peak device memory {peak:.2f} GiB; launches {counts}; position error "
          f"median {float(dist.median()):.3e}, max {float(dist.max()):.3e}  [{smi}]")
    return sol, counts


def quad_figure8(tt, dev, smi):
    """The figure-8 anchor on the card (``figure8_problem``, float64, IPDDP
    per pass from hover thrust, the anchor's options: FIG8_ITERS = 300
    iterations, tolerance 1e-6, acceptable 1e-5, initial regularization
    1e-4), held to
    its assertions: position error at the end < 0.5, every quaternion norm
    within 0.1 of 1, mean tracking error < 2. Returns its launches (kernel
    5's tracking form among them)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.options import RegularizationOptions

    prob = figure8_problem(tt, torch.float64, dev)
    p1 = prob.replace(x0=prob.x0[None])
    opts = tt.CDDPOptions(max_iterations=FIG8_ITERS, tolerance=1e-6, acceptable_tolerance=1e-5,
                          regularization=RegularizationOptions(initial_value=1e-4))
    dispatch_log.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = tt.solve(p1, "IPDDP", opts, U0=hover(prob, 1))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(dispatch_log.launches)
    if set(counts) != {"open_loop_rollout@quadrotor", "ipddp_backward@13x4x8",
                       "ip_forward_track@quadrotor"}:
        raise AssertionError(f"the figure-8 anchor: launches {counts}")
    X, refs = sol.state_trajectory[0], prob.objective.reference_states
    pos = float((X[-1, :3] - refs[-1, :3]).norm())
    qdev = float((X[:, 3:7].norm(dim=-1) - 1.0).abs().max())
    track = float((X[:, :3] - refs[:, :3]).norm(dim=-1).mean())
    print(f"[quadrotor] figure-8 anchor (float64, N={prob.horizon}, per pass): "
          f"{sol.status_messages()[0]} after {int(sol.iterations_completed[0])} iterations, "
          f"position error {pos:.4f} (< 0.5), max |norm(q) - 1| {qdev:.3e} (< 0.1), mean "
          f"tracking error {track:.4f} (< 2); {ms:.1f} ms (beside the plain references' "
          f"process); launches {counts}  [{smi}]")
    if not (pos < 0.5 and qdev < 0.1 and track < 2.0):
        raise AssertionError("the figure-8 anchor fails its assertions")
    return counts


def phase_quad_fleets(tt, dev, smi, sol64):
    """(c)-(e), each run with the launch counts zeroed just before it and
    read just after: the single solve (held to ``sol64``); the quadrotor
    fleet (the golden's problem from hover + U(-0.5, 0.5)^3 position
    offsets, float32, QUAD_ITERS iterations of the golden's options) at
    QUAD_B / PER_PASS_SHARE under IPDDP per pass (kernels 4, 6, 5) and CLDDP per pass
    (kernels 1, 2), and at B_CHECK under MSIPDDP and LogDDP on their plain
    drivers over QUAD_PLAIN_ITERS (kernel 4's seed alone); the
    QuadrotorRate fleet at QUAD_B / PER_PASS_SHARE under IPDDP per pass and a
    QUAD_DRIVE_ITERS CLDDP run that drives kernels 1 and 2 at 10x4. Returns
    (launches {entry: n}, the single solve)."""
    launches = {}
    t0 = time.perf_counter()
    single = phase_quad_single(tt, dev, smi, sol64)
    print(f"[quadrotor] (c) done in {time.perf_counter() - t0:.1f} s")
    quad = quad_problem(tt, torch.float32, dev)
    x0 = fleet_x0(quad, QUAD_B, torch.Generator(device=dev).manual_seed(SEED))
    ol, k5, k6 = "open_loop_rollout@quadrotor", "ip_forward@quadrotor", "ipddp_backward@13x4x8"
    for solver, B, iters, want, drives in (
            ("IPDDP", QUAD_B // PER_PASS_SHARE, QUAD_ITERS, {ol, k6, k5},
             {ol: ol, k5: k5, "ipddp_backward@quadrotor": k6}),
            ("CLDDP", QUAD_B // PER_PASS_SHARE, QUAD_ITERS,
             {"riccati_backward@13x4", "forward_rollout@quadrotor"},
             {"riccati_backward@quadrotor": "riccati_backward@13x4",
              "forward_rollout@quadrotor": "forward_rollout@quadrotor"}),
            ("MSIPDDP", B_CHECK, QUAD_PLAIN_ITERS, {ol: 1}, {}),
            ("LogDDP", B_CHECK, QUAD_PLAIN_ITERS, {ol: 1}, {})):
        how = "plain driver" if B == B_CHECK else "per pass"
        _, counts = quad_fleet_run(f"quadrotor {solver} fleet ({how})", quad, x0[:B], solver,
                                   quad_options(tt, iters), want, smi)
        launches.update({entry: counts[logged] for entry, logged in drives.items()})
    print(f"[quadrotor] (d) done in {time.perf_counter() - t0:.1f} s")
    rate = rate_problem(tt, torch.float32, dev)
    xr = fleet_x0(rate, QUAD_B, torch.Generator(device=dev).manual_seed(SEED))
    ol = "open_loop_rollout@quadrotor_rate"
    for solver, iters, want in (
            ("IPDDP", QUAD_ITERS, {ol, "ipddp_backward@10x4x8", "ip_forward@quadrotor_rate"}),
            ("CLDDP", QUAD_DRIVE_ITERS, {"riccati_backward@10x4",
                                         "forward_rollout@quadrotor_rate"})):
        _, counts = quad_fleet_run(f"QuadrotorRate {solver} fleet (per pass)", rate,
                                   xr[:QUAD_B // PER_PASS_SHARE], solver,
                                   quad_options(tt, iters), want, smi)
        for name, logged, _, model, _ in QUAD_ENTRIES:
            if model == "quadrotor_rate" and logged in counts:
                launches[name] = counts[logged]
    print(f"[quadrotor] (e) done in {time.perf_counter() - t0:.1f} s")
    return launches, single


def time_quad_kernels(tt, dev, single, smi):
    """Every phase-16 entry's wrapper and device ms, plain ms and bound at
    QUAD_B on the operands of the fleet that drives it, staged as in (a)
    (``quad_stage``, ``quad_ip_stage``): kernels 1 and 2 on the CLDDP
    operands, kernels 4, 5 and 6 on the IPDDP ones, on each
    model, and kernel 5's tracking form on the quadrotor's with a line as
    its reference; then the single solve's split (``time_quad_single``).
    Returns {entry: timing tuple}."""
    from cddp_tpu_torch.ops.kernels import ip_rollout

    t0 = time.perf_counter()
    out, staged = time_lane_kernels(tt, dev, smi, "quadrotor", QUAD_MODELS, quad_maker,
                                    quad_stage, quad_ip_stage,
                                    lambda: quad_options(tt, QUAD_ITERS), QUAD_B)
    opts = quad_options(tt, QUAD_ITERS)
    # The tracking form on the quadrotor's operands, a line as its reference.
    p, fwd5 = staged["quadrotor"]
    prob = quad_problem(tt, torch.float32, dev, tracking=True).replace(x0=p.x0)
    fc = forward_consts(prob, opts, False)
    out5 = ip_rollout._launch_forward(fc, *fwd5)
    timing = time_kernels(
        {"ip_forward": (lambda: ip_rollout._launch_forward(fc, *fwd5), 20,
                        lambda: ip_rollout.ip_forward_plain(fc, *fwd5), 1)},
        {"ip_forward": (fwd5 + reference_read(prob), out5, count_ops_steps(
            ip_rollout.ip_forward_plain, fc, *one(fwd5)) * QUAD_B)},
        torch.float32, smi, label=" (tracking form)", events_ok="wrapper", batch=QUAD_B)
    out["ip_forward_track@quadrotor"] = timing["ip_forward"]
    print(f"[quadrotor] entries timed at {time.perf_counter() - t0:.1f} s")
    time_quad_single(tt, dev, single, smi)
    print(f"[quadrotor] timings done at {time.perf_counter() - t0:.1f} s")
    return out


def time_lane_kernels(tt, dev, smi, label, models, maker, stage, ip_stage, options, batch,
                      plain_b=None, plain=None):
    """Kernels 1, 2, 4, 5 and 6 of each of a family's ``models`` at ``batch``
    (wrapper and device ms, plain ms, bound), on operands staged as its (a)
    stages them (``stage``, ``ip_stage``; ``options()`` the IPDDP options):
    kernels 1 and 2 on the CLDDP operands, then, those freed, kernels 4, 5
    and 6 on the IPDDP ones; the plain versions on all of them, or on the
    first ``plain_b``, but where ``plain`` ({"<kernel>@<model>": ms},
    ``phase_lane_kernels``') gives their time from (a). Returns
    ({"<kernel>@<model>": timing tuple}, {model: (the IPDDP operands'
    problem, kernel 5's inputs)})."""
    from cddp_tpu_torch.ops.kernels import ip_rollout, riccati
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    def cut(ts):
        return tuple(t[:plain_b] if plain_b and isinstance(t, torch.Tensor) and t.dim()
                     and t.shape[0] == batch else t for t in ts)

    def timed(runs, work):
        given = {k: (plain or {}).get(f"{k}@{model}") for k in runs}
        timing = time_kernels(runs, work, torch.float32, smi, events_ok="wrapper", batch=batch,
                              plain_ms=given)
        out.update({f"{k}@{model}": v for k, v in timing.items()})

    out, staged, t0 = {}, {}, time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for model in models:
        prob = maker(model)(tt, torch.float32, dev)
        X, U, back, alpha = stage(prob, batch, gen)
        # The rollout's gains: kernel 1's launch (on a model it leaves out,
        # ``riccati.LEFT_OUT_MODELS``, an untimed staging launch).
        out1 = riccati._launch(*back)
        consts = rollout_ops.lane_consts(prob)
        fwd2 = (X[:, :-1], U, out1[0], out1[1], X[:, 0], alpha)
        out2 = rollout_ops._launch(consts, *fwd2)
        # The plain recursions take seconds a call at these shapes: one call
        # each, without a warm-up.
        runs = {"riccati_backward": (lambda: riccati._launch(*back), 10,
                                     lambda: riccati.riccati_backward_plain(*cut(back)), 1),
                "forward_rollout": (lambda: rollout_ops._launch(consts, *fwd2), 20,
                                    lambda: rollout_ops.forward_rollout_plain(consts,
                                                                              *cut(fwd2)), 1)}
        work = {"riccati_backward": (back, out1, count_ops_steps(
                    riccati.riccati_backward_plain, *one(back)) * batch),
                "forward_rollout": (fwd2, out2, count_ops_steps(
                    rollout_ops.forward_rollout_plain, consts, *one(fwd2)) * batch)}
        if consts.entry.cuda_name in riccati.LEFT_OUT_MODELS:
            del runs["riccati_backward"], work["riccati_backward"]
        timed(runs, work)
        del X, U, back, alpha, out1, fwd2, out2
        torch.cuda.empty_cache()
        opts = options()
        p, ol, back6d, fwd5 = ip_stage(tt, prob, batch, gen, opts)
        back6, fc, entry = per_pass_layout(back6d), forward_consts(p, opts, False), \
            rollout_ops.model_entry(p.model)
        out4 = ip_rollout._launch_open_loop(p.model, entry, *ol, p.timestep)
        out5, out6 = ip_rollout._launch_forward(fc, *fwd5), ric._launch(*back6)
        timed({"open_loop_rollout": (
                  lambda: ip_rollout._launch_open_loop(p.model, entry, *ol, p.timestep), 20,
                  lambda: ip_rollout.open_loop_rollout_plain(p.model, *cut(ol), p.timestep), 1),
               "ip_forward": (lambda: ip_rollout._launch_forward(fc, *fwd5), 20,
                              lambda: ip_rollout.ip_forward_plain(fc, *cut(fwd5)), 1),
               "ipddp_backward": (lambda: ric._launch(*back6), 10,
                                  lambda: ric.ipddp_backward_plain(*cut(back6)), 1)},
              {"open_loop_rollout": (ol, (out4[:, 1:],), count_ops_steps(
                  ip_rollout.open_loop_rollout_plain, p.model, *one(ol), p.timestep) * batch),
               "ip_forward": (fwd5, out5, count_ops_steps(ip_rollout.ip_forward_plain, fc,
                                                     *one(fwd5)) * batch),
               "ipddp_backward": (backward_operands_read(back6), out6, count_ops_steps(
                   ric.ipddp_backward_plain, *one(back6)) * batch)})
        print(f"[{label}] {model}'s entries timed at {time.perf_counter() - t0:.1f} s")
        staged[model] = (p, fwd5)
        del back6d, back6, out4, out5, out6
        torch.cuda.empty_cache()
    return out, staged


def time_quad_single(tt, dev, single, smi):
    """The single solve's split per iteration: kernels 6 and 5's device ms
    at B = 1 on the solve's operands (staged by the plain driver from hover
    controls) times their launches an iteration in the solve, kernel 4's
    once, and the rest of the median host ms as glue; and kernel 6 at B = 1
    against its plain sweep (``backward_engine="scan"``) at B = 1 (ROADMAP
    B.3)."""
    from cddp_tpu_torch.ops.kernels import ip_rollout
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric

    p1, opts, U0, sol, med, counts = single
    its = int(sol.iterations_completed[0])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prob = bench_problem(tt, torch.float32, dev)
    p, _, back, fwd = stage_ip_inputs(tt, prob, 1, gen, opts, iterations=0, U0=hover(prob))
    back, fc = per_pass_layout(back), forward_consts(p, opts, False)
    k6 = lambda: ric._launch(*back)  # noqa: E731
    k5 = lambda: ip_rollout._launch_forward(fc, *fwd)  # noqa: E731
    ms6, src6 = device_ms(k6, "ipddp_backward", 10, "wrapper")
    ms5, src5 = device_ms(k5, "ip_forward", 10, "wrapper")
    n6, n5 = counts["ipddp_backward@13x4x8"] / its, counts["ip_forward@quadrotor"] / its
    plain_ms = cuda_ms(lambda: ric.ipddp_backward_plain(*back), 1, warm=False)
    print(f"[quadrotor] single solve split, {its} iterations, {med:.2f} ms a solve: per "
          f"iteration kernel 6 {ms6 * n6:.3f} ms device ({n6:.2f} launches of {ms6:.4f} ms, "
          f"{src6}), kernel 5 {ms5 * n5:.3f} ms device ({n5:.2f} launches of {ms5:.4f} ms, "
          f"{src5}), glue {med / its - ms6 * n6 - ms5 * n5:.3f} ms (the median solve's ms "
          f"an iteration less the two kernels'); kernel 6 at B=1 {ms6:.4f} ms against its "
          f"plain sweep at B=1 {plain_ms:.3f} ms ({plain_ms / ms6:.1f}x)  [{smi}]")


def quad_checks(tt, dev, smi, refs):
    """Phase 16's (a) and (b), the figure-8 anchor and (c)'s float64 single
    solve beside the plain references' process (``refs``, a ``Side``),
    then (a)'s and (b)'s solves held to the references. Returns (errs, the
    anchor's launches, the float64 single solve)."""
    t0 = time.perf_counter()
    errs = {"float64": {}, "float32": {}}
    try:
        phase_quad_kernels(tt, dev, errs)
        print(f"[quadrotor] (a)'s kernels done in {time.perf_counter() - t0:.1f} s")
        solves = quad_kernel_solves(tt, dev)
        golden = quad_golden_kernel(tt, dev)
        anchor = quad_figure8(tt, dev, smi)
        sol64 = quad_single64(tt, dev)
        print(f"[quadrotor] per-pass solves, golden, anchor and float64 single solve done in "
              f"{time.perf_counter() - t0:.1f} s")
        plain = refs.result(dev)
    finally:
        refs.close()
    print(f"[quadrotor] plain references in at {time.perf_counter() - t0:.1f} s")
    check_quad_solves(solves, plain)
    check_quad_golden(golden, plain["golden"])
    print(f"[quadrotor] (a) and (b) done in {time.perf_counter() - t0:.1f} s")
    return errs, anchor, sol64


def phase_quadrotor(tt, dev, smi, checked):
    """Phase 16, the quadrotor and QuadrotorRate. Beside the plain
    references' process (``Side``): (a) every new instantiation
    against its plain version, float64 and float32, and both models'
    per-pass float64 solves; (b)'s per-pass golden run; the figure-8
    anchor; (c)'s float64 single solve. Then (a)'s and (b)'s solves against
    the plain drivers, and (c)-(e) alone on the card: the single solve and
    the fleets (each entry's times and bound follow in
    ``time_quad_kernels``); ``checked``: ``quad_checks``' results, which
    ``main`` takes earlier. Returns ({entry: launches}, {dtype: {entry:
    err}}, the single solve)."""
    t0 = time.perf_counter()
    errs, anchor, sol64 = checked
    checked_errs("phase 16", errs)
    launches, single = phase_quad_fleets(tt, dev, smi, sol64)
    launches["ip_forward_track@quadrotor"] = anchor["ip_forward_track@quadrotor"]
    print(f"[quadrotor] checks and fleets done in {time.perf_counter() - t0:.1f} s")
    return launches, errs, single


# --- the rigid-body attitude trio (phase 17) -----------------------------------------

ATT_MODELS = ("euler_attitude", "quaternion_attitude", "mrp_attitude")
ATT_CLASSES = {"EulerAttitude": "euler_attitude", "QuaternionAttitude": "quaternion_attitude",
               "MrpAttitude": "mrp_attitude"}
ATT_INERTIA = (10.0, 15.0, 20.0)  # examples/spacecraft_examples.py:61
SLEW_X0 = (0.3, 0.2, -0.25)  # the example's MRP at rest (:67)
SLEW_N = 200  # the example's horizon (:60)
MPC_N = 20  # the onboard attitude MPC's horizon, where the whole solves run
SLEW_B = 65536  # the slew fleets' batch (the quadrotor fleets')
ATT_X0_WIDTH = 0.3  # the fleets' start attitudes: MRPs from U(-0.3, 0.3)^3, at rest
ATT_ITERS = 10  # the fleets' budget
SINGLE_ITERS = 150  # the example's single slew (:73)
SINGLE_REPS = 3  # its timed runs after a warm-up
# (a) holds the whole solves at N = 20 and at the longest horizon each
# takes (``whole_cases``) on B_CHECK instances over
# ATT_WHOLE_ITERS, and the per-pass solves at N = 200 on QUAD_CHECK_B over
# ATT_CHECK_ITERS, to their plain drivers: the plain drivers' runs are the
# phase's largest cost (an iteration of the N = 20 fleet's took about 1 s
# of an NVIDIA H100 80GB HBM3 machine's host at 700 W, the plain drivers
# being torch launches), so a second process runs them
# (``attitude_plain_refs``) beside the kernels' build.
ATT_WHOLE_ITERS = 5
ATT_CHECK_ITERS = 2
ATT_KERNEL_B = 1024  # (a)'s kernels 1, 2 and 4 at N = 200
# (b)'s MSIPDDP and LogDDP fleets on their plain drivers at B_CHECK: one
# iteration after kernel 4's seed (an iteration at N = 200 is seconds of
# torch launches).
ATT_PLAIN_ITERS = 1
def att_entries():
    """Phase 17's kernels, each an entry of the kernels' JSON line: (entry
    name, dispatch_log name, kernel, model, launcher without its type
    suffix); the whole solves where their tables take the model
    (``whole_takes``: kernel 3 leaves the MRP model out, kernel 7 the Euler
    model, ROADMAP C.12)."""
    return tuple(
        (f"{kernel}@{model}", logged, kernel, model, launcher)
        for model in ATT_MODELS
        for kernel, logged, launcher in (
            ("riccati_backward", f"riccati_backward@{6 + (model[0] == 'q')}x3",
             f"cddp_riccati_backward_{6 + (model[0] == 'q')}x3"),
            ("forward_rollout", f"forward_rollout@{model}", f"cddp_forward_rollout_{model}"),
            ("clddp_solve", f"clddp_solve@{model}", f"cddp_clddp_solve_{model}"),
            ("open_loop_rollout", f"open_loop_rollout@{model}",
             f"cddp_open_loop_rollout_{model}"),
            ("ip_forward", f"ip_forward@{model}", f"cddp_ip_forward_{model}_m6"),
            ("ipddp_backward", f"ipddp_backward@{6 + (model[0] == 'q')}x3x6",
             f"cddp_ipddp_backward_{6 + (model[0] == 'q')}x3x6"),
            ("ipddp_solve", f"ipddp_solve@{model}", f"cddp_ipddp_solve_{model}_m6"),
            ("logddp_solve", f"logddp_solve@{model}", f"cddp_logddp_solve_{model}_m6"),
        ) if kernel not in WHOLE_KERNELS.values() or whole_takes(kernel, model))


def attitude_state(model, sigma):
    """States (B, nx) at rest at the attitudes ``sigma`` (B, 3), MRPs, in the
    model's coordinates (``utils/rotations.py``): the MRP itself, its
    quaternion, or its ZYX Euler angles."""
    from cddp_tpu_torch.utils import rotations

    if model == "mrp_attitude":
        att = sigma
    elif model == "quaternion_attitude":
        att = rotations.mrp_to_quat(sigma)
    else:
        att = rotations.rotation_matrix_to_euler_zyx(rotations.mrp_to_rotation_matrix(sigma))
    return torch.cat([att, torch.zeros_like(sigma)], -1)


def attitude_problem(tt, dtype, device, model, horizon=None):
    """The MRP slew of examples/spacecraft_examples.py:59-82 on ``model``:
    rk4, inertia diag(10, 15, 20), dt = 0.05, N = SLEW_N (or ``horizon``), Q
    = 0.1 diag(1, 1, 1, 0.1, 0.1, 0.1), R = 0.01 I, Qf = diag(500 x3, 50 x3)
    (the quaternion's attitude weight repeated over its four entries), the
    torque box +-2, from the example's attitude at rest to the identity at
    rest. Its tensors and model are in ``dtype``, as a solve casts them."""
    from cddp_tpu_torch import models
    from cddp_tpu_torch.solvers.base import canonicalize_problem_dtype

    kw = dict(device=device, dtype=dtype)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    n_att = 4 if model == "quaternion_attitude" else 3
    goal = attitude_state(model, torch.zeros(1, 3, dtype=torch.float64))[0]
    x0 = attitude_state(model, f64([SLEW_X0]))[0]
    obj = tt.quadratic_objective(0.1 * f64([1.0] * n_att + [0.1] * 3).diag(),
                                 0.01 * torch.eye(3, dtype=torch.float64),
                                 f64([500.0] * n_att + [50.0] * 3).diag(), goal, DT, **kw)
    mdl = getattr(models, model)(inertia=f64(ATT_INERTIA).diag(), integration_type="rk4",
                                 device=device)
    prob = tt.problem(mdl, obj, x0, horizon or SLEW_N, DT, **kw).add_constraint(
        "ControlConstraint", tt.control_constraint([-2.0] * 3, [2.0] * 3, **kw))
    return canonicalize_problem_dtype(prob)


def attitude_options(tt, iterations):
    """The example's options (:71-72): tolerance 1e-5, acceptable 1e-6;
    ``iterations``."""
    return tt.CDDPOptions(max_iterations=iterations, tolerance=1e-5, acceptable_tolerance=1e-6)


def attitude_maker(model, horizon=None):
    """``attitude_problem`` as a ``make_problem(tt, dtype, device)``."""
    return lambda tt, dtype, dev: attitude_problem(tt, dtype, dev, model, horizon)


def attitude_ip_stage(tt, prob, B, gen, opts):
    """Kernels 4, 5 and 6's operands after one IPDDP iteration of the
    per-pass engine from the fleet's cold seeds (``stage_ip_inputs``), A
    differing between instances and steps (B = dt [0; I^-1] is the same
    everywhere: the torques enter the rates alone, through the constant
    inertia)."""
    staged = stage_ip_inputs(tt, prob, B, gen, opts, iterations=1, kernels=True)
    assert_varies(f"{type(prob.model).__name__} IPDDP operands", staged[2][0])
    return staged


def attitude_stage(prob, B, gen):
    """Kernels 1 and 2's operands (``stage_inputs``: controls uniform in
    three quarters of the box) about rollouts from the fleet's x0, A
    differing between instances and steps (B is constant,
    ``attitude_ip_stage``)."""
    X, U, back, alpha = stage_inputs(prob, B, gen)
    assert_varies(f"{type(prob.model).__name__} CLDDP operands", back[0])
    return X, U, back, alpha


WHOLE_KERNELS = {"CLDDP": "clddp_solve", "IPDDP": "ipddp_solve", "LogDDP": "logddp_solve"}


def whole_takes(kernel, model):
    """Whether the whole-solve ``kernel`` (3, 7, 8 or 9) is instantiated for
    ``model``'s control box: its table (``rollout.CLDDP_MODELS``,
    ``mega_ipddp.IP_BOX_ROWS``, ``MS_BOX_ROWS``, ``LOG_BOX_ROWS``), which
    leaves out the pairs that forked in float32 (ROADMAP C.12-C.14). The
    horizons it takes the model at are ``rollout.WHOLE_MAX_HORIZON``'s."""
    from cddp_tpu_torch.ops.kernels import mega_ipddp
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    return model in {"clddp_solve": rollout_ops.CLDDP_MODELS,
                     "ipddp_solve": mega_ipddp.IP_BOX_ROWS,
                     "msipddp_solve": mega_ipddp.MS_BOX_ROWS,
                     "logddp_solve": mega_ipddp.LOG_BOX_ROWS}[kernel]


class Family(typing.NamedTuple):
    """A model family whose whole solves (``kernels``, {solver: kernel}: 3,
    7 and 9 in phases 17 and 18, and 8 too in phase 19) are held to their
    plain drivers (where ``whole_takes``): its ``models``, ``problem(tt,
    dtype, device, model, horizon)``, ``options(tt, iterations)``, its MPC
    fleets' horizon, (a)'s iterations, the seed of (a)'s x0, and
    ``controls(problem, B)``, the (B, N, nu) controls every solve of the
    family starts from (None: zeros)."""

    label: str
    models: tuple
    problem: typing.Callable
    options: typing.Callable
    mpc_n: int
    whole_iters: int
    seed: int
    kernels: dict = WHOLE_KERNELS
    controls: typing.Optional[typing.Callable] = None


def seed_controls(fam, prob, B):
    """The family's seed controls for B instances of ``prob``, or None."""
    return None if fam.controls is None else fam.controls(prob, B)


def attitude_family():
    """Phase 17's family, read when called (the dry runs cut its sizes)."""
    return Family("attitude", ATT_MODELS, attitude_problem, attitude_options, MPC_N,
                  ATT_WHOLE_ITERS, SEED + 71)


def whole_solvers(fam, model):
    """The solvers whose whole-solve kernel takes ``model``
    (``whole_takes``)."""
    return tuple(solver for solver, kernel in fam.kernels.items()
                 if whole_takes(kernel, model))


def fleet_horizon(fam, kernel, model):
    """The horizon of the MPC fleet that drives the whole-solve ``kernel`` on
    ``model``: the family's MPC horizon, or the longest the kernel takes the
    model at (``rollout.WHOLE_MAX_HORIZON``, the JAX gates') where that is
    shorter."""
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    return min(fam.mpc_n, rollout_ops.WHOLE_MAX_HORIZON[kernel].get(model, fam.mpc_n))


def whole_cases(fam):
    """(a)'s whole solves: (model, horizon, iterations, solvers), each model
    at the MPC horizon with the solvers whose kernel takes it there, then
    each kernel on each model it takes at the horizon of its fleet where
    that is shorter (``fleet_horizon``) and at the longest horizon it takes
    it (``rollout.WHOLE_MAX_HORIZON``, the JAX gates'; past it the solves run
    per pass)."""
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    at_mpc, edge = {}, {}
    for solver, kernel in fam.kernels.items():
        for model in fam.models:
            if not whole_takes(kernel, model):
                continue
            limit = rollout_ops.WHOLE_MAX_HORIZON[kernel].get(model)
            for horizon in {fleet_horizon(fam, kernel, model), limit} - {None}:
                (at_mpc if horizon == fam.mpc_n else edge).setdefault(
                    (model, horizon), []).append(solver)
    order = {solver: i for i, solver in enumerate(fam.kernels)}
    pick = lambda cases, key: tuple(sorted(cases[key], key=order.get))  # noqa: E731
    return ([(model, fam.mpc_n, fam.whole_iters, pick(at_mpc, (model, fam.mpc_n)))
             for model in fam.models if (model, fam.mpc_n) in at_mpc]
            + [(model, horizon, fam.whole_iters, pick(edge, (model, horizon)))
               for model, horizon in sorted(edge)])


def whole_x0(tt, dev, fam, model, dtype, horizon):
    """(a)'s whole solves' problem (N = ``horizon``) in ``dtype`` and x0:
    B_CHECK seeded ``fleet_x0`` drawn in float32 and cast, so that the
    float64 plain runs are also the float32 ones' truth."""
    prob = fam.problem(tt, dtype, dev, model, horizon)
    p32 = prob if dtype == torch.float32 else fam.problem(tt, torch.float32, dev, model, horizon)
    gen = torch.Generator(device=dev).manual_seed(fam.seed)
    return prob, fleet_x0(p32, B_CHECK, gen).to(dtype)


def whole_run(tt, fam, prob, x0, solver, plain, iterations):
    """One of (a)'s whole solves from x0's cold seeds (each solver's
    ``solve`` builds them), ``iterations`` of the family's options: the
    kernel's launch, or with ``plain`` its plain driver (MSIPDDP: a
    (Solution, state) pair)."""
    from cddp_tpu_torch.ops.kernels import mega_clddp, mega_ipddp, mega_logddp, mega_msipddp
    from cddp_tpu_torch.solvers import clddp, ipddp, logddp, msipddp

    opts = fam.options(tt, iterations)
    U0 = seed_controls(fam, prob, x0.shape[0])
    if solver == "IPDDP":
        # The seed's rollout by the plain version, in both processes: the
        # references' process builds no kernel.
        p, seeds = ip_seeds(prob, plain_ip_options(tt, opts), x0, U0)
        if plain:
            return ipddp._drive(p, plain_ip_options(tt, opts), *seeds)
        return mega_ipddp._launch(p, opts, *seeds)
    p = prob.replace(x0=x0)
    if solver == "LogDDP":
        seeds = barrier_seeds("LogDDP", p, opts, U0=U0)
        return logddp._drive(p, opts, *seeds) if plain else mega_logddp._launch(p, opts, *seeds)
    if solver == "MSIPDDP":
        seeds = barrier_seeds("MSIPDDP", p, opts, U0=U0)
        return msipddp._drive(p, opts, *seeds) if plain else mega_msipddp._launch(p, opts, *seeds)
    seeds = clddp_solve_seeds(x0, p, U0)
    if plain:
        return clddp._solve(p, opts.replace(backward_engine="scan"), *seeds)
    return mega_clddp._launch(p, opts, *seeds)


def whole_refs(tt, dev, fam, out):
    """Into ``out``, the plain drivers' runs that (a)'s whole solves are held
    to (``whole_run``): each case of ``whole_cases`` and solver in float64,
    and in float32 from x0 and from x0 one ulp up, with the float32 run's
    host ms."""
    t0 = time.perf_counter()
    for model, horizon, iters, solvers in whole_cases(fam):
        print(f"{fam.label}: {model} at N={horizon} from {time.perf_counter() - t0:.1f} s",
              flush=True)
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype).replace("torch.", "")
            prob, x0 = whole_x0(tt, dev, fam, model, dtype, horizon)
            for solver in solvers:
                key = (solver, model, horizon)
                out[("whole", *key, tag)] = timed_plain(
                    lambda: whole_run(tt, fam, prob, x0, solver, True, iters))
                if dtype == torch.float32:
                    out[("whole ms", *key)] = LAST_PLAIN_MS[0]
                    out[("whole up", *key)] = solution_of(whole_run(
                        tt, fam, prob, ulp_up((x0,))[0], solver, True, iters))[0]


def solution_of(run):
    """(Solution, MSIPDDP state or None) of a whole solve's run
    (``whole_run``)."""
    return run if isinstance(run, tuple) else (run, None)


def whole_fields(run):
    """(Solution, {field: tensor}) of a whole solve's run, the fields that
    ``check_whole`` holds a float64 LogDDP or MSIPDDP kernel to (X, U, the
    gains and the cost; MSIPDDP also Y, S, F, Lambda and mu)."""
    sol, st = solution_of(run)
    f = {"X": sol.state_trajectory, "U": sol.control_trajectory,
         "k": sol.feedforward_gains, "K": sol.feedback_gains, "cost": sol.final_objective}
    if st is not None:
        f.update(Y=st.Y, S=st.S, F=st.F, Lambda=st.Lambda, mu=sol.barrier_mu)
    return sol, f


def whole_timing(tt, solver, prob, x0, opts, U0=None):
    """A whole solve's timed run and its work (``time_kernels``' two
    items) on the fleet's cold seeds from the controls U0 (zeros when
    None)."""
    from cddp_tpu_torch.ops.kernels import mega_clddp, mega_ipddp, mega_logddp, mega_msipddp

    p = prob.replace(x0=x0)
    if solver == "CLDDP":
        seeds = clddp_solve_seeds(x0, prob, U0)
        return ((lambda: mega_clddp._launch(p, opts, *seeds), 10, None, 1),
                clddp_solve_work(p, opts, seeds))
    if solver == "IPDDP":
        p7, seeds = ip_seeds(prob, opts, x0, U0)
        return ((lambda: mega_ipddp._launch(p7, opts, *seeds), 10, None, 1),
                seed_ipddp_work(tt, p7, opts, seeds))
    seeds = barrier_seeds(solver, p, opts, U0=U0)
    if solver == "MSIPDDP":
        return ((lambda: mega_msipddp._launch(p, opts, *seeds), 10, None, 1),
                msipddp_solve_work(tt, p, opts, seeds))
    return ((lambda: mega_logddp._launch(p, opts, *seeds), 10, None, 1),
            logddp_solve_work(tt, p, opts, seeds))


def time_whole_solves(tt, fam, fleet, opts, plain, smi):
    """Each whole solve the family's tables take (``whole_solvers``) at its
    MPC fleet's batch on that fleet's cold seeds from the family's seed
    controls (``fleet(kernel, model)``: (problem, x0)) under ``opts``: its
    wrapper and device ms and its bound from one counted launch's work
    (``whole_timing``), its plain driver's float32 ms from (a) (``plain``).
    Returns {entry: timing tuple}."""
    out, t0 = {}, time.perf_counter()
    for model in fam.models:
        runs, work = {}, {}
        for solver in whole_solvers(fam, model):
            kernel = fam.kernels[solver]
            prob, x0 = fleet(kernel, model)
            runs[kernel], work[kernel] = whole_timing(tt, solver, prob, x0, opts,
                                                      seed_controls(fam, prob, x0.shape[0]))
        timing = time_kernels(runs, work, torch.float32, smi, events_ok="wrapper",
                              plain_ms={k: plain[f"{k}@{model}"] for k in runs})
        out.update({f"{k}@{model}": v for k, v in timing.items()})
        print(f"[{fam.label}] {model}'s whole solves timed at {time.perf_counter() - t0:.1f} s")
    return out


def solution_rows(sol, rows):
    """The status, iteration count and cost of ``sol``'s instances ``rows``,
    as the float32 checks read them."""
    return types.SimpleNamespace(status_code=sol.status_code[rows],
                                 iterations_completed=sol.iterations_completed[rows],
                                 final_objective=sol.final_objective[rows])


def check_whole(tt, dev, fam, refs, errs, plain):
    """(a) the family's whole solves (``whole_cases``) on B_CHECK instances
    against their plain drivers' runs in ``refs`` (``whole_refs``): float64
    every status and iteration count equal, X, U and cost within 1e-8
    (IPDDP also duals, slacks and mu; LogDDP the gains; MSIPDDP the gains,
    Y, S, F, Lambda and mu, on all but MS_TIE_SHARE of the instances,
    ``check_barrier``'s rule for kernel 8); float32 status, iterations and cost (rel 1e-4) equal on >= 99%
    of the plain driver's stable instances, those on which it agrees so
    with its own run from x0 one ulp up (all of them where its float32
    solve does not fork within these iterations; ROADMAP C.12), and kernel
    7 as accurate against float64 as its plain driver within 2x over all
    instances. Every case is checked and printed before a failure is
    raised. Errors at each kernel's fleet horizon (``fleet_horizon``) into
    ``errs``, each whole solve's float32 plain ms there into ``plain``."""
    failed = []
    for model, horizon, iters, solvers in whole_cases(fam):
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype).replace("torch.", "")
            prob, x0 = whole_x0(tt, dev, fam, model, dtype, horizon)
            for solver in solvers:
                kernel = fam.kernels[solver]
                name, key = f"{kernel}@{model}", (solver, model, horizon)
                label = f"{name} N={horizon}, {iters} iterations"
                fleet = horizon == fleet_horizon(fam, kernel, model)
                kern_run = whole_run(tt, fam, prob, x0, solver, False, iters)
                ref_run = refs[("whole", *key, tag)]
                kern, ref = solution_of(kern_run)[0], solution_of(ref_run)[0]
                same = ((kern.status_code == ref.status_code)
                        & (kern.iterations_completed == ref.iterations_completed))
                err = float((kern.final_objective - ref.final_objective)[same].abs().max())
                if fleet:
                    errs[tag][name] = err
                if dtype == torch.float64:
                    try:
                        if solver == "CLDDP":
                            check_solve_f64(label, kern, ref)
                        elif solver == "IPDDP":
                            check_ip_solve(label, kern, ref, True, dual_rtol=1e-8)
                        else:
                            check_barrier(solver, label, whole_fields(kern_run),
                                          whole_fields(ref_run), True,
                                          min_share=(1.0 - MS_TIE_SHARE if solver == "MSIPDDP"
                                                     else 0.99))
                    except AssertionError as e:
                        failed.append(str(e))
                    continue
                if fleet:
                    plain[name] = refs[("whole ms", *key)]
                stable = cost_agree(refs[("whole up", *key)], ref)
                print(f"[kernels float32] {label}: the kernel agrees with the plain driver on "
                      f"{float(cost_agree(kern, ref).double().mean()):.4%} of {x0.shape[0]}; "
                      f"the plain driver with itself from x0 one ulp up on "
                      f"{int(stable.sum())} (its stable instances, "
                      f"{float(stable.double().mean()):.4%}), held at 99% there")
                k, r = solution_rows(kern, stable), solution_rows(ref, stable)
                try:
                    if solver == "CLDDP":
                        check_solve_f32(f"{label}, stable instances", k, r, 0.99)
                    elif solver in ("LogDDP", "MSIPDDP"):
                        check_barrier(solver, f"{label}, stable instances", (k, None),
                                      (r, None), False)
                    else:
                        check_ip_solve(f"{label}, stable instances", k, r, False)
                except AssertionError as e:
                    failed.append(str(e))
                truth = solution_of(refs[("whole", *key, "float64")])[0].final_objective
                rel = {n: (s.final_objective.double() - truth).abs() / truth.abs()
                       for n, s in (("kernel", kern), ("plain", ref))}
                q = {n: (float(r.median()), float(r.quantile(0.99))) for n, r in rel.items()}
                print(f"[kernels float32] {label} against the float64 plain driver: median rel "
                      f"cost err kernel {q['kernel'][0]:.3e}, plain {q['plain'][0]:.3e}; 99th "
                      f"percentile kernel {q['kernel'][1]:.3e}, plain {q['plain'][1]:.3e}")
                if solver == "IPDDP" and not all(
                        q["kernel"][i] <= 2.0 * q["plain"][i] + 1e-6 for i in (0, 1)):
                    failed.append(f"{label}: rel cost err against float64 {q['kernel']} "
                                  f"exceeds twice the plain driver's {q['plain']}")
    if failed:
        raise AssertionError("; ".join(failed))


def attitude_check_seeds(tt, model, dev):
    """(a)'s per-pass solves' problem (float64, N = SLEW_N) and x0
    (QUAD_CHECK_B seeded ``fleet_x0``), as both processes build them."""
    prob = attitude_problem(tt, torch.float64, dev, model)
    return prob, fleet_x0(prob, QUAD_CHECK_B,
                          torch.Generator(device=dev).manual_seed(SEED + 75))


def attitude_check_options(tt, solver):
    """(a)'s per-pass options of ``solver`` (ATT_CHECK_ITERS) and its plain
    driver's."""
    opts = attitude_options(tt, ATT_CHECK_ITERS).replace(solve_engine="xla")
    return opts, (opts.replace(backward_engine="scan") if solver == "CLDDP"
                  else plain_ip_options(tt, opts))


def attitude_plain_refs(tt, dev):
    """The plain drivers' solutions phase 17 holds its kernels to: (a)'s
    whole solves (``whole_refs``), then its per-pass float64
    CLDDP and IPDDP on each model's ``attitude_check_seeds``. Returns {key:
    value}."""
    from cddp_tpu_torch.parallel.batch import batched_solve

    out, t0 = {}, time.perf_counter()
    whole_refs(tt, dev, attitude_family(), out)
    print(f"the whole solves' plain drivers done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    for model in ATT_MODELS:
        prob, x0 = attitude_check_seeds(tt, model, dev)
        out[("x0", model)] = x0
        for solver in ("CLDDP", "IPDDP"):
            out[(solver, model)] = batched_solve(prob, x0, solver,
                                                 attitude_check_options(tt, solver)[1])
        print(f"{model}'s per-pass plain drivers done at {time.perf_counter() - t0:.1f} s",
              flush=True)
    return out


def attitude_kernel_solves(tt, dev):
    """(a)'s per-pass float64 solves at N = SLEW_N, CLDDP (kernels 1 and 2)
    and IPDDP (kernels 4, 6 and 5), of each model on
    ``attitude_check_seeds``, each run's launches checked. Returns
    {(solver, model): (Solution, launches, x0)}."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    out = {}
    for model in ATT_MODELS:
        prob, x0 = attitude_check_seeds(tt, model, dev)
        nx = prob.state_dim
        for solver, want in (("CLDDP", {f"riccati_backward@{nx}x3", f"forward_rollout@{model}"}),
                             ("IPDDP", {f"open_loop_rollout@{model}", f"ipddp_backward@{nx}x3x6",
                                        f"ip_forward@{model}"})):
            dispatch_log.reset()
            sol = batched_solve(prob, x0, solver, attitude_check_options(tt, solver)[0])
            torch.cuda.synchronize()
            counts = dict(dispatch_log.launches)
            if set(counts) != want:
                raise AssertionError(f"{model} {solver} per pass, float64: launches {counts}, "
                                     f"not {sorted(want)}")
            out[(solver, model)] = (sol, counts, x0)
    return out


def check_attitude_solves(tt, dev, solves, refs):
    """(a)'s per-pass solves against the plain drivers: every status and
    iteration count equal, X, U and cost within 1e-8 (CLDDP plus
    MOVE_FACTOR times the plain driver's move from x0 one ulp up, run here
    only where 1e-8 alone is exceeded), the duals, slacks and mu too for
    IPDDP."""
    from cddp_tpu_torch.parallel.batch import batched_solve

    for (solver, model), (kern, counts, x0) in solves.items():
        if not torch.equal(x0, refs[("x0", model)]):
            raise AssertionError(f"{model}: the plain references ran from other x0")
        plain = refs[(solver, model)]
        if solver == "CLDDP":
            prob = attitude_check_seeds(tt, model, dev)[0]
            check_solve_f64(f"{model} per-pass", kern, plain, moved=lambda prob=prob, x0=x0:
                            batched_solve(prob, ulp_up((x0,))[0], "CLDDP",
                                          attitude_check_options(tt, "CLDDP")[1]))
        else:
            check_ip_solve(f"{model} per-pass", kern, plain, True, dual_rtol=1e-8)
        print(f"[attitude float64] {model} {solver} per pass at N={SLEW_N}, B={x0.shape[0]}, "
              f"{ATT_CHECK_ITERS} iterations: launches {counts}; iterations "
              f"{torch.bincount(kern.iterations_completed.long()).tolist()}")


def slew_single(tt, dev, dtype):
    """(d) the example's single slew through ``tt.solve`` as the example
    calls it (x0 of shape (nx,), X0 the tiled x0, SINGLE_ITERS iterations),
    its launches counted. Returns (Solution, launches, host ms)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log

    prob = attitude_problem(tt, dtype, dev, "mrp_attitude")
    X0 = prob.x0.expand(SLEW_N + 1, -1)
    dispatch_log.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = tt.solve(prob, "CLDDP", attitude_options(tt, SINGLE_ITERS), X0=X0)
    torch.cuda.synchronize()
    return sol, dict(dispatch_log.launches), (time.perf_counter() - t0) * 1e3


def phase_slew_single(tt, dev, smi, sol64):
    """(d) the example's single slew in float32 at B = 1, per pass (kernels
    1 and 2: kernel 3 leaves the MRP model out, ``whole_takes``): status,
    iterations, the final state's distance to the goal, max |u| and ms a
    solve (the median of SINGLE_REPS after a warm-up), held to its float64
    run ``sol64``: the same status and the final cost within
    SINGLE_COST_RTOL."""
    runs = [slew_single(tt, dev, torch.float32) for _ in range(SINGLE_REPS + 1)]
    sol, counts, _ = runs[0]
    if set(counts) != {"riccati_backward@6x3", "forward_rollout@mrp_attitude"}:
        raise AssertionError(f"the single slew: launches {counts}")
    ms = sorted(r[2] for r in runs[1:])
    err = float(sol.state_trajectory[-1].norm())
    rel = abs(float(sol.final_objective) - float(sol64.final_objective)) / abs(
        float(sol64.final_objective))
    print(f"[attitude] the example's slew (MrpAttitude, CLDDP, N={SLEW_N}, float32, B=1): "
          f"status {int(sol.status_code)}, {int(sol.iterations_completed)} iterations, err "
          f"{err:.4f}, max |u| {float(sol.control_trajectory.abs().max()):.3f}, cost "
          f"{float(sol.final_objective):.6f}; {ms[len(ms) // 2]:.2f} ms a solve (median of "
          f"{SINGLE_REPS} after a warm-up; min {ms[0]:.2f}, max {ms[-1]:.2f}); launches "
          f"{counts}  [{smi}]")
    print(f"[attitude] the slew in float64 (kernels 1 and 2's float64 builds): status "
          f"{int(sol64.status_code)}, {int(sol64.iterations_completed)} iterations, err "
          f"{float(sol64.state_trajectory[-1].norm()):.4f}, cost "
          f"{float(sol64.final_objective):.7f}; float32 against it: rel cost {rel:.3e} (<= "
          f"{SINGLE_COST_RTOL:g}, status equal)")
    if not bool(sol.state_trajectory.isfinite().all()):
        raise AssertionError("the single slew: non-finite states")
    if int(sol.status_code) != int(sol64.status_code) or not rel <= SINGLE_COST_RTOL:
        raise AssertionError(f"the float32 slew: status {int(sol.status_code)}, rel cost "
                             f"{rel:.3e} against float64's status {int(sol64.status_code)}")


def family_fleet_run(label, prob, x0, solver, opts, want, smi, mega=None, tag="attitude",
                     U0=None):
    """``zoo_fleet_run`` (from the controls ``U0``, zeros when None) with the
    run's converged share, iterations, ms, solves/s, peak device memory, the
    kernel's work and warp divergence (``mega``), and the final states'
    distance to the goal, printed under ``tag``. Returns launches."""
    B = x0.shape[0]
    torch.cuda.reset_peak_memory_stats()
    sol, counts, ms, work = zoo_fleet_run(label, prob, x0, solver, opts, want, mega, U0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    conv = (sol.status_code == 1) | (sol.status_code == 2)
    its = sol.iterations_completed.double()
    dist = (sol.state_trajectory[:, -1] - prob.objective.reference_state).norm(dim=-1)
    extra = ("" if work is None else f"; the kernel's wrapper {work[0]:.2f} ms, mean work per "
             f"instance {work[1]}, warp divergence {work[2]:.4f}")
    print(f"[{tag}] {label}, B={B}, {opts.max_iterations} iterations: converged "
          f"{float(conv.double().mean()):.4%}, statuses "
          f"{torch.bincount(sol.status_code.long(), minlength=5).tolist()}, iterations mean "
          f"{float(its.mean()):.3f} max {int(its.max())}; {ms:.2f} ms ({B / ms * 1e3:.1f} "
          f"solves/s); peak device memory {peak:.2f} GiB; launches {counts}; |x_N - goal| "
          f"median {float(dist.median()):.3e}, max {float(dist.max()):.3e}{extra}  [{smi}]")
    return counts


def phase_attitude_fleets(tt, dev, smi, sol64):
    """(b)-(d), each run with the launch counts zeroed just before it and
    read just after: on each model, the slew fleet (N = SLEW_N, SLEW_B /
    PER_PASS_SHARE, float32, ATT_ITERS) under CLDDP per pass (kernels 1, 2) and IPDDP per
    pass (kernels 4, 6, 5), and at B_CHECK under MSIPDDP (kernel 8 refuses
    the trio) and LogDDP (``solve_engine="xla"``) on their plain drivers
    over ATT_PLAIN_ITERS (kernel 4's seed alone); the MPC fleet (N =
    MPC_N, B_MAIN, float32, ATT_ITERS) under CLDDP (one launch of kernel 3),
    IPDDP and LogDDP (kernel 4's seed and one launch of kernel 7 or 9), per
    pass (on B_MAIN / PER_PASS_SHARE) where its table leaves the whole
    solve out; then the example's
    single slew (``phase_slew_single``). Returns (launches
    {entry: n}, {(fleet, model): (problem, x0)} for the timings)."""
    from cddp_tpu_torch.ops.kernels import mega_clddp, mega_ipddp, mega_logddp

    launches, fleets, t0 = {}, {}, time.perf_counter()
    for model in ATT_MODELS:
        prob = attitude_problem(tt, torch.float32, dev, model)
        x0 = fleet_x0(prob, SLEW_B, torch.Generator(device=dev).manual_seed(SEED))
        fleets[("slew", model)] = (prob, x0)
        nx = prob.state_dim
        ol, k1, k2 = (f"open_loop_rollout@{model}", f"riccati_backward@{nx}x3",
                      f"forward_rollout@{model}")
        k5, k6 = f"ip_forward@{model}", f"ipddp_backward@{nx}x3x6"
        for solver, B, iters, engine, want, drives in (
                ("CLDDP", SLEW_B // PER_PASS_SHARE, ATT_ITERS, "xla", {k1, k2},
                 {f"riccati_backward@{model}": k1, k2: k2}),
                ("IPDDP", SLEW_B // PER_PASS_SHARE, ATT_ITERS, "xla", {ol, k6, k5},
                 {ol: ol, k5: k5, f"ipddp_backward@{model}": k6}),
                ("MSIPDDP", B_CHECK, ATT_PLAIN_ITERS, "auto", {ol: 1}, {}),
                ("LogDDP", B_CHECK, ATT_PLAIN_ITERS, "xla", {ol: 1}, {})):
            how = "plain driver" if B == B_CHECK else "per pass"
            opts = attitude_options(tt, iters).replace(solve_engine=engine)
            counts = family_fleet_run(f"{model} slew {solver} fleet ({how})", prob, x0[:B],
                                        solver, opts, want, smi)
            launches.update({entry: counts[logged] for entry, logged in drives.items()})
    print(f"[attitude] (b) done in {time.perf_counter() - t0:.1f} s")
    opts = attitude_options(tt, ATT_ITERS)
    for model in ATT_MODELS:
        prob = attitude_problem(tt, torch.float32, dev, model, MPC_N)
        x0 = fleet_x0(prob, B_MAIN, torch.Generator(device=dev).manual_seed(SEED))
        fleets[("mpc", model)] = (prob, x0)
        nx = prob.state_dim
        per_pass = {"CLDDP": {f"riccati_backward@{nx}x3", f"forward_rollout@{model}"},
                    "IPDDP": {f"open_loop_rollout@{model}", f"ipddp_backward@{nx}x3x6",
                              f"ip_forward@{model}"}}
        for solver, kernel, mega in (("CLDDP", "clddp_solve", mega_clddp),
                                     ("IPDDP", "ipddp_solve", mega_ipddp),
                                     ("LogDDP", "logddp_solve", mega_logddp)):
            name = f"{kernel}@{model}"
            label = f"{model} MPC {solver} fleet (N={MPC_N})"
            if not whole_takes(kernel, model):
                family_fleet_run(f"{label}, per pass", prob, x0[:B_MAIN // PER_PASS_SHARE],
                                 solver, opts, per_pass[solver], smi)
                continue
            want = ({name: 1} if solver == "CLDDP"
                    else {name: 1, f"open_loop_rollout@{model}": 1})
            counts = family_fleet_run(label, prob, x0, solver, opts, want, smi, mega)
            launches[name] = counts[name]
    print(f"[attitude] (c) done in {time.perf_counter() - t0:.1f} s")
    phase_slew_single(tt, dev, smi, sol64)
    print(f"[attitude] (d) done in {time.perf_counter() - t0:.1f} s")
    return launches, fleets


def attitude_checks(tt, dev, smi, refs):
    """Phase 17's (a) and (d)'s float64 slew beside the plain references'
    process (``refs``, a ``Side``), then the whole and per-pass solves held
    to its runs. Returns (errs, {entry: float32 plain ms}, the float64
    slew)."""
    t0 = time.perf_counter()
    errs, plain = {"float64": {}, "float32": {}}, {}
    try:
        phase_lane_kernels(tt, dev, errs, "attitude", ATT_MODELS, attitude_maker, attitude_stage,
                           attitude_ip_stage, lambda: attitude_options(tt, ATT_ITERS),
                           ATT_KERNEL_B, SEED + 77, plain=plain)
        print(f"[attitude] (a)'s per-pass kernels done in {time.perf_counter() - t0:.1f} s")
        solves = attitude_kernel_solves(tt, dev)
        sol64 = slew_single(tt, dev, torch.float64)[0]
        print(f"[attitude] per-pass solves and the float64 slew done in "
              f"{time.perf_counter() - t0:.1f} s")
        refs_out = refs.result(dev)
    finally:
        refs.close()
    print(f"[attitude] plain references in at {time.perf_counter() - t0:.1f} s")
    check_whole(tt, dev, attitude_family(), refs_out, errs, plain)
    print(f"[attitude] (a)'s whole solves done in {time.perf_counter() - t0:.1f} s")
    check_attitude_solves(tt, dev, solves, refs_out)
    return errs, plain, sol64


def phase_attitude(tt, dev, smi, checked):
    """Phase 17, the attitude trio. Beside the plain references' process
    (``Side("attitude")``, which runs (a)'s plain drivers): (a) every
    new instantiation of kernels 1, 2, 4, 5 and 6 against its plain version
    at the slew's horizon (``phase_lane_kernels``), the per-pass float64
    solves at N = SLEW_N, and (d)'s float64 slew. Then the whole solves 3, 7
    and 9 (``whole_cases``) against their plain drivers' runs
    (``check_whole``), the per-pass solves against theirs, and
    (b)-(d) alone on the card (each entry's times and bound follow in
    ``time_attitude_kernels``); ``checked``: ``attitude_checks``' results,
    which ``main`` takes earlier. Returns ({entry: launches}, {dtype:
    {entry: err}}, {(fleet, model): (problem, x0)}, {entry: plain ms})."""
    t0 = time.perf_counter()
    errs, plain, sol64 = checked
    checked_errs("phase 17", errs)
    launches, fleets = phase_attitude_fleets(tt, dev, smi, sol64)
    print(f"[attitude] checks and fleets done in {time.perf_counter() - t0:.1f} s")
    return launches, errs, fleets, plain


def time_attitude_kernels(tt, dev, fleets, plain, smi):
    """(e) every phase-17 entry's wrapper and device ms, plain ms and bound:
    kernels 1, 2, 4, 5 and 6 at SLEW_B on the slew's operands, staged as in
    (a) by the per-pass kernels (``time_lane_kernels``; their plain versions
    timed on the first ATT_KERNEL_B instances), the whole solves at B_MAIN
    on the MPC fleets' cold seeds, each one's bound from one counted
    launch's work (their plain drivers' float32 ms from (a), ``plain``).
    Returns {entry: timing tuple}."""
    out, _ = time_lane_kernels(
        tt, dev, smi, "attitude", ATT_MODELS, attitude_maker,
        lambda prob, B, gen: stage_inputs(prob, B, gen),
        lambda tt, prob, B, gen, opts: stage_ip_inputs(tt, prob, B, gen, opts, iterations=1,
                                                       kernels=True),
        lambda: attitude_options(tt, ATT_ITERS), SLEW_B, plain_b=ATT_KERNEL_B, plain=plain)
    out.update(time_whole_solves(tt, attitude_family(), lambda k, m: fleets[("mpc", m)],
                                 attitude_options(tt, ATT_ITERS), plain, smi))
    return out


# --- phase 18: the other spacecraft models ----------------------------------------

SC_MODELS = ("sc_linear_fuel", "sc_nonlinear", "sc_landing2d", "sc_twobody")
SC_CLASSES = {"SpacecraftLinearFuel": "sc_linear_fuel", "SpacecraftNonlinear": "sc_nonlinear",
              "SpacecraftLanding2D": "sc_landing2d", "SpacecraftTwobody": "sc_twobody"}
# (nx, nu, m: the control box's rows) of each model.
SC_SHAPES = {"sc_linear_fuel": (8, 3, 6), "sc_nonlinear": (10, 3, 6),
             "sc_landing2d": (6, 2, 4), "sc_twobody": (6, 3, 6)}
TWOBODY_MU = 398600.4418  # km^3/s^2, SpacecraftTwobody's default
TWOBODY_R = 7000.0  # km: the circular LEO of tests/test_model_lanes.py:64-65
# Each model's MPC problem: (dt, x0 (None: the circular LEO), x0 widths, Q,
# R and Qf diagonals, the control box's lower and upper bounds); a fleet's
# x0 is x0 + widths (U(0, 1) - 0.5) (``fleet_x0``) and its goal 0, but the
# two-body model's, the circular orbit's state at t = N dt.
# sc_linear_fuel: the JAX rendezvous bench's HCW problem
#   (bench_ipddp_fleet.py:63-81, x0 spread :127-129: +-0.5 on positions,
#   +-0.005 on velocities) with the mass and effort states appended
#   (weight 0), without its terminal equality; rendezvous planners that
#   track propellant.
# sc_nonlinear: normalised units, mass = mu = 1 (tests/test_model_lanes.py:
#   58-60), the chief on its circular orbit; formation keeping.
# sc_landing2d: the default lander from tests/test_model_lanes.py:61-63's
#   state, dispersed; powered-descent guidance.
# sc_twobody: station keeping of a LEO constellation.
SC_SPECS = {
    "sc_linear_fuel": (30.0, (10.0, 5.0, 2.0, 0.0, 0.0, 0.0, 1.0, 0.0),
                       (1.0,) * 3 + (0.01,) * 3 + (0.0,) * 2, (1e-4,) * 6 + (0.0,) * 2,
                       (1e-2,) * 3, (1.0,) * 6 + (0.0,) * 2, (-0.004,) * 3, (0.004,) * 3),
    "sc_nonlinear": (0.01, (0.0,) * 6 + (1.0, 0.0, 0.0, 1.0), (0.02,) * 3 + (0.0,) * 7,
                     (0.0,) * 10, (1.0,) * 3, (1e3,) * 6 + (0.0,) * 4, (-0.05,) * 3,
                     (0.05,) * 3),
    "sc_landing2d": (0.5, (0.0, 10.0, 1000.0, -30.0, 0.05, 0.01),
                     (20.0, 2.0, 100.0, 5.0, 0.05, 0.01), (1e-2,) * 4 + (1.0,) * 2, (1.0, 10.0),
                     (10.0,) * 4 + (1e3,) * 2, (0.4, -0.3), (1.0, 0.3)),
    "sc_twobody": (10.0, None, (1.0,) * 3 + (1e-3,) * 3, (0.0,) * 6, (1.0,) * 3,
                   (1.0,) * 3 + (1e4,) * 3, (-1e-3,) * 3, (1e-3,) * 3),
}
SC_LONG_N = 100  # (c)'s long-horizon fleets, per pass past every JAX gate
SC_LONG_B = 65536
SC_ITERS = 10  # the fleets' budget, at tolerance 1e-4
# (b)'s LogDDP fleets on their plain driver at B_CHECK (at SC_ITERS the
# nonlinear model's took 9.2 s, the lander's 4.4 s on an NVIDIA H100 80GB
# HBM3, 700.00 W): they prove kernel 4's seed launch.
SC_PLAIN_ITERS = 2
SC_KERNEL_B = 1024  # (a)'s kernels 1, 2 and 4 at N = SC_LONG_N
SC_WHOLE_ITERS = 5  # (a)'s whole solves
# (a)'s kernel 1 in float32 on the lander at the MPC horizon, in float64 at
# SC_LONG_N: float32 cannot carry the lander's Riccati recursion over N =
# 100 (on 1,024 staged operands on an NVIDIA H100 80GB HBM3, kernel and
# plain version each left float64 by more than TIE_ERR on 54.2% of the
# instances at N = 100, on none at N = 20; ROADMAP C.13). Kernel 1 leaves
# the two-body model out (``riccati.LEFT_OUT_MODELS``).
SC_RICCATI_F32_N = {"sc_landing2d": MPC_N}
def sc_entries():
    """Phase 18's kernels, each an entry of the kernels' JSON line: (entry
    name, dispatch_log name, kernel, model, launcher without its type
    suffix); kernels 1 and 6 log their shape; the whole solves where their
    tables take the model (``whole_takes``, ROADMAP C.13)."""
    out = []
    for model in SC_MODELS:
        nx, nu, m = SC_SHAPES[model]
        for kernel, logged, launcher in (
                ("riccati_backward", f"riccati_backward@{nx}x{nu}",
                 f"cddp_riccati_backward_{nx}x{nu}"),
                ("forward_rollout", f"forward_rollout@{model}", f"cddp_forward_rollout_{model}"),
                ("clddp_solve", f"clddp_solve@{model}", f"cddp_clddp_solve_{model}"),
                ("open_loop_rollout", f"open_loop_rollout@{model}",
                 f"cddp_open_loop_rollout_{model}"),
                ("ip_forward", f"ip_forward@{model}", f"cddp_ip_forward_{model}_m{m}"),
                ("ipddp_backward", f"ipddp_backward@{nx}x{nu}x{m}",
                 f"cddp_ipddp_backward_{nx}x{nu}x{m}"),
                ("ipddp_solve", f"ipddp_solve@{model}", f"cddp_ipddp_solve_{model}_m{m}"),
                ("logddp_solve", f"logddp_solve@{model}", f"cddp_logddp_solve_{model}_m{m}")):
            if (kernel not in WHOLE_KERNELS.values() or whole_takes(kernel, model)) and (
                    kernel != "riccati_backward" or riccati_takes(model)):
                out.append((f"{kernel}@{model}", logged, kernel, model, launcher))
    return tuple(out)


def riccati_takes(model):
    """Whether kernel 1 takes ``model``'s CLDDP (``riccati.LEFT_OUT_MODELS``
    leaves the two-body model out)."""
    from cddp_tpu_torch.ops.kernels import riccati

    return model not in riccati.LEFT_OUT_MODELS


def circular_state(t):
    """The circular LEO's state (km, km/s) at time t (s): radius TWOBODY_R in
    the x-y plane, at x on the x axis at t = 0."""
    v = math.sqrt(TWOBODY_MU / TWOBODY_R)
    a = v / TWOBODY_R * t
    return (TWOBODY_R * math.cos(a), TWOBODY_R * math.sin(a), 0.0,
            -v * math.sin(a), v * math.cos(a), 0.0)


def sc_problem(tt, dtype, device, model, horizon=None):
    """``model``'s MPC problem (``SC_SPECS``) at N = ``horizon`` (SC_LONG_N
    when None): rk4, the model's default parameters. Its tensors and model
    are in ``dtype``, as a solve casts them."""
    from cddp_tpu_torch import models
    from cddp_tpu_torch.solvers.base import canonicalize_problem_dtype

    N = horizon or SC_LONG_N
    dt, x0, _, Q, R, Qf, lower, upper = SC_SPECS[model]
    kw = dict(device=device, dtype=dtype)
    diag = lambda v: torch.as_tensor(v, dtype=torch.float64).diag()  # noqa: E731
    twobody = model == "sc_twobody"
    goal = circular_state(N * dt) if twobody else (0.0,) * len(Q)
    x0 = circular_state(0.0) if twobody else x0
    cls = next(c for c, m in SC_CLASSES.items() if m == model)
    obj = tt.quadratic_objective(diag(Q), diag(R), diag(Qf), list(goal), dt, **kw)
    prob = tt.problem(getattr(models, cls)(integration_type="rk4"), obj, list(x0), N, dt,
                      **kw).add_constraint("ControlConstraint",
                                           tt.control_constraint(list(lower), list(upper), **kw))
    return canonicalize_problem_dtype(prob)


def sc_options(tt, iterations):
    """The fleets' options: tolerance 1e-4, ``iterations``."""
    return tt.CDDPOptions(max_iterations=iterations, tolerance=1e-4)


def sc_maker(model, horizon=None):
    """``sc_problem`` as a ``make_problem(tt, dtype, device)``."""
    return lambda tt, dtype, dev: sc_problem(tt, dtype, dev, model, horizon)


def sc_family():
    """Phase 18's family, read when called (the dry run cuts its sizes)."""
    return Family("spacecraft", SC_MODELS, sc_problem, sc_options, MPC_N, SC_WHOLE_ITERS,
                  SEED + 81)


def sc_stage(prob, B, gen, operands=lambda back: back[0]):
    """Kernels 1 and 2's operands (``stage_inputs``) about rollouts from the
    fleet's x0 under controls uniform in the middle three quarters of the
    box, ``operands(back)`` (A) differing between instances and steps."""
    cc = prob.get_constraint("ControlConstraint")
    r = torch.rand(B, prob.horizon, prob.control_dim, generator=gen, device=prob.x0.device,
                   dtype=prob.x0.dtype)
    X, U, back, alpha = stage_inputs(prob, B, gen, U=cc.lower + (cc.upper - cc.lower) * (
        0.125 + 0.75 * r))
    assert_varies(f"{type(prob.model).__name__} CLDDP operands", operands(back))
    return X, U, back, alpha


def sc_ip_stage(tt, prob, B, gen, opts, operands=lambda back: back[0]):
    """Kernels 4, 5 and 6's operands after one IPDDP iteration of the
    per-pass engine from cold seeds at the fleet's x0 and the box's
    midpoint (zero but for the lander's thrust, whose box excludes 0),
    ``operands(back)`` (A) differing between instances and steps."""
    cc = prob.get_constraint("ControlConstraint")
    mid = ((cc.lower + cc.upper) / 2).expand(prob.horizon, -1)
    staged = stage_ip_inputs(tt, prob, B, gen, opts, iterations=1, U0=mid, kernels=True)
    assert_varies(f"{type(prob.model).__name__} IPDDP operands", operands(staged[2]))
    return staged



def sc_lane_checks(tt, dev, models, plain=None):
    """(a) every new instantiation of kernels 1, 2, 4, 5 and 6 on ``models``
    against its plain version at N = SC_LONG_N (``phase_lane_kernels``:
    float64 within ZOO_RTOL plus twice the plain version's one-ulp move,
    float32 by ``check``'s rule, kernel 1 with ``ties``, on the lander at
    SC_RICCATI_F32_N, not on the two-body model; with ``plain`` the float32
    plain versions' ms). Returns {dtype: {entry: err}}."""
    errs = {"float64": {}, "float32": {}}
    phase_lane_kernels(tt, dev, errs, "spacecraft", models, sc_maker, sc_stage, sc_ip_stage,
                       lambda: sc_options(tt, SC_ITERS), SC_KERNEL_B,
                       SEED + 83 + SC_MODELS.index(models[0]),
                       riccati_f32_n=SC_RICCATI_F32_N, plain=plain)
    return errs


def sc_mpc_x0(tt, dev, model, horizon, B):
    """The MPC fleet's problem (float32, N = ``horizon``) and its B x0
    (``fleet_x0`` from SEED), as both processes draw them."""
    prob = sc_problem(tt, torch.float32, dev, model, horizon)
    return prob, fleet_x0(prob, B, torch.Generator(device=dev).manual_seed(SEED))


def sc_plain_refs(tt, dev):
    """The plain drivers phase 18 holds its whole solves to
    (``whole_refs``), and (b)'s MSIPDDP fleets on their plain driver (the
    JAX gate refuses kernel 8 the four models at N = MPC_N): the first
    B_CHECK of each MPC fleet's x0, SC_ITERS iterations, no kernel
    (``solve_engine="xla"``, ``backward_engine="scan"``), with its host ms.
    Returns {key: value}."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    out, t0 = {}, time.perf_counter()
    whole_refs(tt, dev, sc_family(), out)
    print(f"the whole solves' plain drivers done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    opts = sc_options(tt, SC_ITERS).replace(solve_engine="xla", backward_engine="scan")
    for model in SC_MODELS:
        prob, x0 = sc_mpc_x0(tt, dev, model, MPC_N, B_MAIN)
        dispatch_log.reset()
        sol = timed_plain(lambda: batched_solve(prob, x0[:B_CHECK], "MSIPDDP", opts))
        out[("msipddp", model)] = (sol, LAST_PLAIN_MS[0], dict(dispatch_log.launches))
        print(f"{model}'s MSIPDDP fleet done at {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def sc_checks(tt, dev, refs):
    """Phase 18's (a): kernels 1, 2, 4, 5 and 6 (``sc_lane_checks``), then
    the whole solves 3, 7 and 9 (``whole_cases``) against the plain
    references' process's runs (``refs``, a ``Side``). Returns (errs,
    {entry: float32 plain ms}, the references)."""
    t0 = time.perf_counter()
    plain = {}
    try:
        errs = sc_lane_checks(tt, dev, SC_MODELS, plain)
        print(f"[spacecraft] (a)'s kernels done in {time.perf_counter() - t0:.1f} s")
        refs_out = refs.result(dev)
    finally:
        refs.close()
    print(f"[spacecraft] plain references in at {time.perf_counter() - t0:.1f} s")
    check_whole(tt, dev, sc_family(), refs_out, errs, plain)
    print(f"[spacecraft] (a)'s whole solves done in {time.perf_counter() - t0:.1f} s")
    return errs, plain, refs_out


def sc_per_pass(model):
    """The kernels a per-pass CLDDP and IPDDP run of ``model`` launches."""
    nx, nu, m = SC_SHAPES[model]
    clddp = {f"forward_rollout@{model}"}
    if riccati_takes(model):
        clddp.add(f"riccati_backward@{nx}x{nu}")
    return {"CLDDP": clddp,
            "IPDDP": {f"open_loop_rollout@{model}", f"ipddp_backward@{nx}x{nu}x{m}",
                      f"ip_forward@{model}"},
            "LogDDP": {f"open_loop_rollout@{model}": 1}}


def sc_fleet_x0(x0, solver, model):
    """A per-pass or plain fleet's x0: its first B_CHECK under LogDDP's plain
    driver and under CLDDP on a model whose recursion runs the plain version
    (``riccati_takes``: 9.0 and 11.7 s a fleet at B = 262,144 and 65,536 on
    an NVIDIA H100 80GB HBM3), its first 1 / PER_PASS_SHARE otherwise."""
    plain = solver == "LogDDP" or (solver == "CLDDP" and not riccati_takes(model))
    return x0[:B_CHECK] if plain else x0[:x0.shape[0] // PER_PASS_SHARE]


def plain_fleet_summary(label, run, tag, smi):
    """Print a plain-driver fleet a side process ran ((Solution, host ms,
    launches)): its converged share, statuses, iterations and ms; raises if
    it launched a kernel."""
    sol, ms, counts = run
    if counts:
        raise AssertionError(f"{label}: launches {counts}")
    conv = (sol.status_code == 1) | (sol.status_code == 2)
    print(f"[{tag}] {label}, B={sol.status_code.numel()}, at most "
          f"{int(sol.iterations_completed.max())} iterations: converged {float(conv.double().mean()):.4%}, statuses "
          f"{torch.bincount(sol.status_code.long(), minlength=5).tolist()}, iterations mean "
          f"{float(sol.iterations_completed.double().mean()):.3f}; {ms:.2f} ms; launches "
          f"{{}}  [{smi}]")


def phase_sc_fleets(tt, dev, smi, refs):
    """(b) the MPC fleets (N = MPC_N, B_MAIN, float32, SC_ITERS at
    tolerance 1e-4) under CLDDP, IPDDP and LogDDP through the default
    engine, each with the launch counts zeroed just before it and read
    just after: one whole-solve launch (kernel 4's seed before kernels 7 and
    9) where the tables take the model at N = MPC_N, else per pass (LogDDP:
    the plain driver at B_CHECK over SC_PLAIN_ITERS after kernel 4's seed; the two-body model's
    CLDDP, whose Riccati recursion runs the plain version, at B_CHECK); each
    whole solve the tables take only at a shorter horizon (the nonlinear
    model's kernels 3 and 7) on the same fleet at that horizon; the
    MSIPDDP fleets on their plain driver (the side process's, ``refs``).
    (c) the long-horizon fleets (N = SC_LONG_N, SC_LONG_B; the two-body
    model's CLDDP at B_CHECK) under CLDDP and IPDDP per pass, as JAX runs
    them there. Returns (launches {entry: n},
    {fleet key: (problem, x0)} for the timings)."""
    from cddp_tpu_torch.ops.kernels import mega_clddp, mega_ipddp, mega_logddp

    megas = {"CLDDP": mega_clddp, "IPDDP": mega_ipddp, "LogDDP": mega_logddp}
    fam, opts = sc_family(), sc_options(tt, SC_ITERS)
    launches, fleets, t0 = {}, {}, time.perf_counter()
    for model in SC_MODELS:
        per_pass = sc_per_pass(model)
        for solver, kernel in WHOLE_KERNELS.items():
            name = f"{kernel}@{model}"
            whole = whole_takes(kernel, model)
            at = fleet_horizon(fam, kernel, model) if whole else None
            for N in sorted({MPC_N, at} - {None}):
                prob, x0 = sc_mpc_x0(tt, dev, model, N, B_MAIN)
                label = f"{model} MPC {solver} fleet (N={N})"
                if N != at:
                    # LogDDP without its kernel is the plain driver (kernel 4
                    # seeds it), and CLDDP without kernel 1 runs the plain
                    # Riccati recursion (the two-body model): at B_CHECK, as
                    # phase 17's plain fleets.
                    plain = solver == "LogDDP"
                    family_fleet_run(label + (", plain driver" if plain else ", per pass"), prob,
                                     sc_fleet_x0(x0, solver, model), solver,
                                     sc_options(tt, SC_PLAIN_ITERS) if plain else opts,
                                     per_pass[solver], smi, tag="spacecraft")
                    continue
                fleets[("mpc", kernel, model)] = (prob, x0)
                want = ({name: 1} if solver == "CLDDP"
                        else {name: 1, f"open_loop_rollout@{model}": 1})
                counts = family_fleet_run(label, prob, x0, solver, opts, want, smi,
                                          megas[solver], tag="spacecraft")
                launches[name] = counts[name]
        plain_fleet_summary(f"{model} MPC MSIPDDP fleet (N={MPC_N}, plain driver, the side "
                            f"process)", refs[("msipddp", model)], "spacecraft", smi)
    print(f"[spacecraft] (b) done in {time.perf_counter() - t0:.1f} s")
    for model in SC_MODELS:
        prob, x0 = sc_mpc_x0(tt, dev, model, SC_LONG_N, SC_LONG_B)
        per_pass = sc_per_pass(model)
        for solver in ("CLDDP", "IPDDP"):
            counts = family_fleet_run(f"{model} N={SC_LONG_N} {solver} fleet, per pass", prob,
                                      sc_fleet_x0(x0, solver, model), solver, opts,
                                      per_pass[solver], smi, tag="spacecraft")
            launches.update({e[0]: counts[e[1]] for e in sc_entries()
                             if e[3] == model and e[1] in per_pass[solver]})
        del prob, x0
        torch.cuda.empty_cache()
    print(f"[spacecraft] (c) done in {time.perf_counter() - t0:.1f} s")
    return launches, fleets


def phase_spacecraft(tt, dev, smi, checked):
    """Phase 18, the other spacecraft models. (a) ran before it
    (``sc_checks``: ``checked``); then (b) and (c) alone on the card
    (``phase_sc_fleets``; every entry's times and bound follow in
    ``time_sc_kernels``). Returns ({entry: launches}, {dtype: {entry:
    err}}, {fleet key: (problem, x0)}, {entry: plain ms})."""
    t0 = time.perf_counter()
    errs, plain, refs = checked
    checked_errs("phase 18", errs)
    launches, fleets = phase_sc_fleets(tt, dev, smi, refs)
    print(f"[spacecraft] fleets done in {time.perf_counter() - t0:.1f} s")
    return launches, errs, fleets, plain


def time_sc_kernels(tt, dev, fleets, plain, smi):
    """(d) every phase-18 entry's wrapper and device ms, plain ms and bound:
    kernels 1, 2, 4, 5 and 6 at SC_LONG_B on (c)'s operands, staged as in
    (a) (``time_lane_kernels``; their plain versions timed on the first
    SC_KERNEL_B instances), the whole solves at B_MAIN on their MPC fleets'
    cold seeds, each one's bound from one counted launch's work (their
    plain drivers' float32 ms from (a), ``plain``). Returns {entry: timing
    tuple}."""
    out, _ = time_lane_kernels(tt, dev, smi, "spacecraft", SC_MODELS, sc_maker, sc_stage,
                               sc_ip_stage, lambda: sc_options(tt, SC_ITERS), SC_LONG_B,
                               plain_b=SC_KERNEL_B, plain=plain)
    out.update(time_whole_solves(tt, sc_family(), lambda k, m: fleets[("mpc", k, m)],
                                 sc_options(tt, SC_ITERS), plain, smi))
    return out


# --- phase 19: the small models ------------------------------------------------

SMALL_MODELS = ("bicycle", "dubins_car", "dreyfus_rocket", "acrobot")
SMALL_CLASSES = {"Bicycle": "bicycle", "DubinsCar": "dubins_car",
                 "DreyfusRocket": "dreyfus_rocket", "Acrobot": "acrobot"}
# (nx, nu, m: the control box's rows) of each model.
SMALL_SHAPES = {"bicycle": (4, 2, 4), "dubins_car": (3, 1, 2), "dreyfus_rocket": (2, 1, 2),
                "acrobot": (4, 1, 2)}


class SmallSpec(typing.NamedTuple):
    """A small model's MPC problem: the model's parameters (its class's
    keywords), dt, x0 and its widths (a fleet's x0 is x0 + widths (U(0, 1)
    - 0.5), ``fleet_x0``), the Q, R and Qf diagonals, the goal and the
    control box."""

    params: dict
    dt: float
    x0: tuple
    widths: tuple
    Q: tuple
    R: tuple
    Qf: tuple
    goal: tuple
    lower: tuple
    upper: tuple


# Parameters and x0 are the JAX package's lane tests'
# (tests/test_model_lanes.py:40-47), rk4 throughout.
# bicycle: lane-keeping and parking MPC for car-like robots: from 1 m/s at
#   a heading of 0.3 rad to rest at (2, 1), heading 0; acceleration +-2
#   m/s^2, steering +-0.5 rad.
# dubins_car: fixed-speed UAV and boat heading: at 1.2 m/s onto the line y
#   = 1 at heading 0 (x is free: the speed cannot stop at a point), turn
#   rate +-1 rad/s.
# dreyfus_rocket: ascent guidance (the defaults' 64 and 32 ft/s^2): to a
#   hover 2 ft up, the thrust angle in [0, 1.5] rad.
# acrobot: the JAX whole-solve case's costs, box and dt
#   (tests/test_mega_clddp.py:364-376): swing toward 0 under a +-5 torque.
SMALL_SPECS = {
    "bicycle": SmallSpec({"wheelbase": 1.4}, 0.1, (0.0, 0.0, 0.3, 1.0), (0.5, 0.5, 0.2, 0.4),
                         (1.0, 1.0, 0.1, 0.1), (0.1, 0.1), (50.0, 50.0, 5.0, 5.0),
                         (2.0, 1.0, 0.0, 0.0), (-2.0, -0.5), (2.0, 0.5)),
    "dubins_car": SmallSpec({"speed": 1.2}, 0.1, (0.0, 0.0, 0.2), (1.0, 1.0, 0.4),
                            (0.0, 1.0, 0.1), (0.1,), (0.0, 10.0, 1.0), (0.0, 1.0, 0.0),
                            (-1.0,), (1.0,)),
    "dreyfus_rocket": SmallSpec({}, 0.05, (0.0, 0.0), (0.5, 1.0), (1.0, 0.1), (0.1,),
                                (100.0, 10.0), (2.0, 0.0), (0.0,), (1.5,)),
    "acrobot": SmallSpec({}, 0.05, (0.1, -0.2, 0.05, 0.1), (0.2,) * 4, (0.1,) * 4, (0.05,),
                         (100.0,) * 4, (0.0,) * 4, (-5.0,), (5.0,)),
}
SMALL_KERNELS = {**WHOLE_KERNELS, "MSIPDDP": "msipddp_solve"}
SMALL_LONG_N = 100  # (c)'s long-horizon fleets
SMALL_LONG_B = 65536
SMALL_ITERS = 10  # the fleets' budget, at tolerance 1e-4
SMALL_KERNEL_B = 1024  # (a)'s kernels 1, 2 and 4 at N = SMALL_LONG_N
# (a)'s whole solves: kernel 8's exact budget (its filter forks at roundoff
# ties past it, ROADMAP C.1), the others' too.
SMALL_WHOLE_ITERS = MS_EXACT_ITERS


def small_entries():
    """Phase 19's kernels, each an entry of the kernels' JSON line: (entry
    name, dispatch_log name, kernel, model, launcher without its type
    suffix); kernels 1 and 6 log their shape; the whole solves where their
    tables take the model (``whole_takes``)."""
    out = []
    for model in SMALL_MODELS:
        nx, nu, m = SMALL_SHAPES[model]
        for kernel, logged, launcher in (
                ("riccati_backward", f"riccati_backward@{nx}x{nu}",
                 f"cddp_riccati_backward_{nx}x{nu}"),
                ("forward_rollout", f"forward_rollout@{model}", f"cddp_forward_rollout_{model}"),
                ("clddp_solve", f"clddp_solve@{model}", f"cddp_clddp_solve_{model}"),
                ("open_loop_rollout", f"open_loop_rollout@{model}",
                 f"cddp_open_loop_rollout_{model}"),
                ("ip_forward", f"ip_forward@{model}", f"cddp_ip_forward_{model}_m{m}"),
                ("ipddp_backward", f"ipddp_backward@{nx}x{nu}x{m}",
                 f"cddp_ipddp_backward_{nx}x{nu}x{m}"),
                ("ipddp_solve", f"ipddp_solve@{model}", f"cddp_ipddp_solve_{model}_m{m}"),
                ("msipddp_solve", f"msipddp_solve@{model}", f"cddp_msipddp_solve_{model}_m{m}"),
                ("logddp_solve", f"logddp_solve@{model}", f"cddp_logddp_solve_{model}_m{m}")):
            if kernel not in SMALL_KERNELS.values() or whole_takes(kernel, model):
                out.append((f"{kernel}@{model}", logged, kernel, model, launcher))
    return tuple(out)


def small_problem(tt, dtype, device, model, horizon=None):
    """``model``'s MPC problem (``SMALL_SPECS``) at N = ``horizon``
    (SMALL_LONG_N when None), rk4. Its tensors and model are in ``dtype``,
    as a solve casts them."""
    from cddp_tpu_torch import models
    from cddp_tpu_torch.solvers.base import canonicalize_problem_dtype

    s = SMALL_SPECS[model]
    kw = dict(device=device, dtype=dtype)
    diag = lambda v: torch.as_tensor(v, dtype=torch.float64).diag()  # noqa: E731
    cls = next(c for c, m in SMALL_CLASSES.items() if m == model)
    obj = tt.quadratic_objective(diag(s.Q), diag(s.R), diag(s.Qf), list(s.goal), s.dt, **kw)
    prob = tt.problem(getattr(models, cls)(**s.params, integration_type="rk4"), obj,
                      list(s.x0), horizon or SMALL_LONG_N, s.dt, **kw).add_constraint(
        "ControlConstraint", tt.control_constraint(list(s.lower), list(s.upper), **kw))
    return canonicalize_problem_dtype(prob)


def small_options(tt, iterations):
    """The fleets' options: tolerance 1e-4, ``iterations``."""
    return tt.CDDPOptions(max_iterations=iterations, tolerance=1e-4)


def small_maker(model, horizon=None):
    """``small_problem`` as a ``make_problem(tt, dtype, device)``."""
    return lambda tt, dtype, dev: small_problem(tt, dtype, dev, model, horizon)


def box_midpoint(prob, B):
    """(B, N, nu) controls at the control box's midpoint."""
    cc = prob.get_constraint("ControlConstraint")
    return ((cc.lower + cc.upper) / 2).expand(B, prob.horizon, -1).contiguous()


def small_family():
    """Phase 19's family, with kernel 8, every solve seeded at the box's
    midpoint (read when called: the dry run cuts its sizes). The midpoint
    is zero but for DreyfusRocket's thrust angle, where zero controls would
    hold every solve still: cos has no slope there, so the backward pass
    sees B = 0 and a gradient of 0, and CLDDP stops at its first iteration
    with the cold seed's cost."""
    return Family("small", SMALL_MODELS, small_problem, small_options, MPC_N,
                  SMALL_WHOLE_ITERS, SEED + 91, SMALL_KERNELS, box_midpoint)


def linearization(back):
    """A, B and lx of a backward's operands side by side, (batch, N, nx (nx
    + nu + 1)): DreyfusRocket's A and DubinsCar's B are the same at every
    instance and step, and DreyfusRocket's B, one value, repeats by chance
    among millions of float32 draws; the three together do not."""
    return torch.cat([back[0].flatten(2), back[1].flatten(2), back[2]], -1)


def small_stage(prob, B, gen):
    """``sc_stage``'s operands, their linearization differing between
    instances and steps."""
    return sc_stage(prob, B, gen, linearization)


def small_ip_stage(tt, prob, B, gen, opts):
    """``sc_ip_stage``'s operands, their linearization differing between
    instances and steps."""
    return sc_ip_stage(tt, prob, B, gen, opts, linearization)


def small_lane_checks(tt, dev, models):
    """(a) every new instantiation of kernels 1, 2, 4, 5 and 6 on ``models``
    against its plain version at N = SMALL_LONG_N, staged as phase 18
    stages them (``small_stage``, ``small_ip_stage``; ``phase_lane_kernels``: float64 within ZOO_RTOL plus twice
    the plain version's one-ulp move, float32 by ``check``'s rule, kernel 1
    with ``ties``). Returns {dtype: {entry: err}}."""
    errs = {"float64": {}, "float32": {}}
    phase_lane_kernels(tt, dev, errs, "small", models, small_maker, small_stage, small_ip_stage,
                       lambda: small_options(tt, SMALL_ITERS), SMALL_KERNEL_B,
                       SEED + 93 + SMALL_MODELS.index(models[0]))
    return errs


def small_mpc_x0(tt, dev, model, horizon, B):
    """The fleet's problem (float32, N = ``horizon``) and its B x0
    (``fleet_x0`` from SEED)."""
    prob = small_problem(tt, torch.float32, dev, model, horizon)
    return prob, fleet_x0(prob, B, torch.Generator(device=dev).manual_seed(SEED))


def small_plain_fleets():
    """(model, solver) of (b)'s MPC fleets that run the plain driver: LogDDP
    and MSIPDDP where the whole solve does not take the model at N = MPC_N
    (kernel 8 on the acrobot, ROADMAP C.14)."""
    fam = small_family()
    return [(model, solver) for model in SMALL_MODELS for solver in ("LogDDP", "MSIPDDP")
            if not (whole_takes(SMALL_KERNELS[solver], model)
                    and fleet_horizon(fam, SMALL_KERNELS[solver], model) == MPC_N)]


def small_plain_refs(tt, dev):
    """The plain drivers phase 19 holds its whole solves to
    (``whole_refs``), and (b)'s MPC fleets that run the plain driver
    (``small_plain_fleets``), as phase 18's run in this process: the first
    B_CHECK of the fleet's x0 from the box's midpoint, SMALL_ITERS
    iterations, no kernel (``solve_engine="xla"``, ``backward_engine="scan"``),
    with its host ms and launches. Returns {key: value}."""
    from cddp_tpu_torch.ops.kernels import dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve

    out, t0 = {}, time.perf_counter()
    fam = small_family()
    whole_refs(tt, dev, fam, out)
    print(f"the small models' whole solves' plain drivers done at "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    opts = small_options(tt, SMALL_ITERS).replace(solve_engine="xla", backward_engine="scan")
    for model, solver in small_plain_fleets():
        prob, x0 = small_mpc_x0(tt, dev, model, MPC_N, B_MAIN)
        dispatch_log.reset()
        sol = timed_plain(lambda: batched_solve(prob, x0[:B_CHECK], solver, opts,
                                                U0_batch=seed_controls(fam, prob, B_CHECK)))
        out[("plain fleet", model, solver)] = (sol, LAST_PLAIN_MS[0],
                                               dict(dispatch_log.launches))
    return out


def small_checks(tt, dev, refs):
    """Phase 19's (a) in the main process: the whole solves 3, 7, 8 and 9
    (``whole_cases``) against the plain references' process's runs
    (``refs``, a ``Side``); kernels 1, 2, 4, 5 and 6 are checked in a side
    process (``small_lane_checks`` in ``zoo_side_checks``). Returns
    ({dtype: {entry: err}}, {entry: float32 plain ms}, the references)."""
    t0 = time.perf_counter()
    try:
        refs_out = refs.result(dev)
    finally:
        refs.close()
    print(f"[small] plain references in at {time.perf_counter() - t0:.1f} s")
    errs, plain = {"float64": {}, "float32": {}}, {}
    check_whole(tt, dev, small_family(), refs_out, errs, plain)
    print(f"[small] (a)'s whole solves done in {time.perf_counter() - t0:.1f} s")
    return errs, plain, refs_out


def small_per_pass(model):
    """The kernels a per-pass CLDDP and IPDDP run of ``model`` launches."""
    nx, nu, m = SMALL_SHAPES[model]
    return {"CLDDP": {f"forward_rollout@{model}", f"riccati_backward@{nx}x{nu}"},
            "IPDDP": {f"open_loop_rollout@{model}", f"ipddp_backward@{nx}x{nu}x{m}",
                      f"ip_forward@{model}"}}


def phase_small_fleets(tt, dev, smi, refs):
    """(b) the MPC fleets (N = MPC_N, B_MAIN, float32, SMALL_ITERS at
    tolerance 1e-4) under CLDDP, IPDDP, MSIPDDP and LogDDP through the
    default engine, each with the launch counts zeroed just before it and
    read just after: one whole-solve launch (kernel 4's seed before kernels
    7, 8 and 9) where the tables take the model, else per pass (CLDDP,
    IPDDP) or the plain driver (LogDDP, MSIPDDP: the side process's run at
    B_CHECK, ``refs``); a whole solve the gates take only at a shorter
    horizon, on the same fleet at that horizon (``fleet_horizon``; none at
    full size).
    (c) the long-horizon fleets (N = SMALL_LONG_N, SMALL_LONG_B)
    under CLDDP and IPDDP through the default engine, whose route follows
    the gates (``rollout.WHOLE_MAX_HORIZON``), and where that route is a
    whole solve, again through the per-pass engine (``solve_engine="xla"``),
    which then drives kernels 1, 2, 5 and 6. Returns (launches {entry: n},
    {fleet key: (problem, x0)} for the timings)."""
    from cddp_tpu_torch.ops.kernels import mega_clddp, mega_ipddp, mega_logddp, mega_msipddp
    from cddp_tpu_torch.ops.kernels import rollout as rollout_ops

    megas = {"CLDDP": mega_clddp, "IPDDP": mega_ipddp, "MSIPDDP": mega_msipddp,
             "LogDDP": mega_logddp}
    fam, opts = small_family(), small_options(tt, SMALL_ITERS)
    launches, fleets, t0 = {}, {}, time.perf_counter()

    def run_(label, prob, x0, solver, o, want, mega=None):
        return family_fleet_run(label, prob, x0, solver, o, want, smi, mega, tag="small",
                                U0=seed_controls(fam, prob, x0.shape[0]))

    def whole_run_(label, prob, x0, solver, kernel, model):
        name = f"{kernel}@{model}"
        want = ({name: 1} if solver == "CLDDP"
                else {name: 1, f"open_loop_rollout@{model}": 1})
        counts = run_(label, prob, x0, solver, opts, want, megas[solver])
        launches[name] = launches.get(name, 0) + counts[name]

    for model in SMALL_MODELS:
        per_pass = small_per_pass(model)
        for solver, kernel in SMALL_KERNELS.items():
            at = fleet_horizon(fam, kernel, model) if whole_takes(kernel, model) else None
            for N in sorted({MPC_N, at} - {None}):
                prob, x0 = small_mpc_x0(tt, dev, model, N, B_MAIN)
                label = f"{model} MPC {solver} fleet (N={N})"
                if N == at:
                    fleets[("mpc", kernel, model)] = (prob, x0)
                    whole_run_(label, prob, x0, solver, kernel, model)
                elif solver in ("CLDDP", "IPDDP"):
                    run_(label + ", per pass", prob, x0, solver, opts, per_pass[solver])
                else:
                    plain_fleet_summary(f"{label}, plain driver, the side process",
                                        refs[("plain fleet", model, solver)], "small", smi)
    print(f"[small] (b) done in {time.perf_counter() - t0:.1f} s")
    for model in SMALL_MODELS:
        prob, x0 = small_mpc_x0(tt, dev, model, SMALL_LONG_N, SMALL_LONG_B)
        per_pass = small_per_pass(model)
        lane = rollout_ops.lane_consts(prob)
        for solver, kernel in (("CLDDP", "clddp_solve"), ("IPDDP", "ipddp_solve")):
            label = f"{model} N={SMALL_LONG_N} {solver} fleet"
            whole = (whole_takes(kernel, model)
                     and rollout_ops.whole_horizon_ok(kernel, lane, SMALL_LONG_N))
            if whole:
                whole_run_(label, prob, x0, solver, kernel, model)
            counts = run_(label + ", per pass", prob, x0, solver,
                          opts.replace(solve_engine="xla") if whole else opts, per_pass[solver])
            launches.update({e[0]: counts[e[1]] for e in small_entries()
                             if e[3] == model and e[1] in per_pass[solver]})
        del prob, x0
        torch.cuda.empty_cache()
    print(f"[small] (c) done in {time.perf_counter() - t0:.1f} s")
    return launches, fleets


def phase_small(tt, dev, smi, checked, lane_errs):
    """Phase 19, the small models. (a) ran before it (``small_checks``:
    ``checked``; the side process's ``small_lane_checks``: ``lane_errs``);
    then (b) and (c) alone on the card (``phase_small_fleets``; every
    entry's times and bound follow in ``time_small_kernels``). Returns
    ({entry: launches}, {dtype: {entry: err}}, {fleet key: (problem, x0)},
    {entry: plain ms})."""
    t0 = time.perf_counter()
    (whole_errs, plain, refs), lane_errs = checked, checked_errs("phase 19", lane_errs)
    errs = {tag: {**lane_errs[tag], **whole_errs[tag]} for tag in lane_errs}
    checked_errs("phase 19", errs)
    launches, fleets = phase_small_fleets(tt, dev, smi, refs)
    print(f"[small] fleets done in {time.perf_counter() - t0:.1f} s")
    return launches, errs, fleets, plain


def time_small_kernels(tt, dev, fleets, plain, smi):
    """(d) every phase-19 entry's wrapper and device ms, plain ms and bound:
    kernels 1, 2, 4, 5 and 6 at SMALL_LONG_B on operands staged as in (a)
    (``time_lane_kernels``; their plain versions timed on the first
    SMALL_KERNEL_B instances), the whole solves at B_MAIN on their MPC
    fleets' cold seeds, each one's bound from one counted launch's work
    (their plain drivers' float32 ms from (a), ``plain``). Returns {entry:
    timing tuple}."""
    out, _ = time_lane_kernels(tt, dev, smi, "small", SMALL_MODELS, small_maker, small_stage,
                               small_ip_stage, lambda: small_options(tt, SMALL_ITERS),
                               SMALL_LONG_B, plain_b=SMALL_KERNEL_B)
    out.update(time_whole_solves(tt, small_family(), lambda k, m: fleets[("mpc", k, m)],
                                 small_options(tt, SMALL_ITERS), plain, smi))
    return out


# --- phase 20: the MPCC racing fleet (examples/mpcc_lib_torch.py) -------------------

MPCC_B = 1024  # bench_mpcc.py's fleet (BASELINE.json config 5, "1k instances")
MPCC_BIG_B = 65536  # kernel 7 at four blocks of 128 threads on each of 132 SMs, and more
MPCC_ITERS = 15  # bench_mpcc.py's cold tick
MPCC_WARM_ITERS = 5  # its warm ticks (MPCC_WARM_ITERS)
MPCC_COEFFS = 64  # its Chebyshev window (MPCC_LOCAL_COEFFS), n_cp = 323
MPCC_WARM_TICKS = 3  # timed warm ticks after the settling one
MPCC_GOLDEN = Path(__file__).resolve().parent / "tests" / "goldens" / "mpcc_tick.npz"
# The phase's entries: (entry name, dispatch_log name, kernel, launcher
# without its type suffix, whether the lane library holds it).
MPCC_ENTRIES = (
    ("open_loop_rollout@bicycle7", "open_loop_rollout@bicycle7", "open_loop_rollout",
     "cddp_open_loop_rollout_bicycle7", True),
    ("ip_forward_mpcc@bicycle7", "ip_forward_mpcc@bicycle7", "ip_forward",
     "cddp_ip_forward_bicycle7_mpcc_m6", True),
    ("ipddp_backward@mpcc", "ipddp_backward@7x3x6", "ipddp_backward",
     "cddp_ipddp_backward_7x3x6", False),
    ("ipddp_solve_mpcc_gn@bicycle7", "ipddp_solve_mpcc_gn@bicycle7", "ipddp_solve",
     "cddp_ipddp_solve_bicycle7_mpcc_gn_m6", True),
)


def mpcc_lib():
    """examples/mpcc_lib_torch.py (which registers the MPCC lanes)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import mpcc_lib_torch

    return mpcc_lib_torch


def mpcc_fleet(m, dev, dtype, B, iters=None):
    """bench_mpcc.py's cold tick: the synthetic track (240 points), the
    Chebyshev windows of MPCC_COEFFS coefficients, ``iters`` iterations, B
    cars spread over 90% of the lap on the centerline (bench_mpcc.py:
    32-37). Returns (track, config, x0 (B, 7))."""
    track = m.synthetic_track(n_points=240, device=dev)
    cfg = m.MpccConfig(max_iterations=iters or MPCC_ITERS, track_eval="local",
                       local_coeffs=MPCC_COEFFS)
    s0 = torch.linspace(0.0, float(track.length) * 0.9, B, dtype=torch.float64, device=dev)
    return track, cfg, m.place(track, s0).to(dtype)


def mpcc_seeds_fn(m, track, cfg):
    """``seeded``'s seeds_fn for the MPCC tick: each car's window and seed
    controls at its x0, the cold start ``ipddp.solve`` builds from them."""
    def fn(prob, opts, x0):
        trk = m.solve_track(track, cfg, x0[:, 3])
        p = m.build_problem(trk, cfg, x0)
        return ip_seeds(p, opts, x0, m.seed_controls(trk, cfg, x0[:, 3])) + (None,)
    return fn


def mpcc_stage(tt, m, track, cfg, x0, gen, iterations=2):
    """Kernels 6 and 5's operands as the per-pass driver stages them on the
    MPCC tick: the per-pass driver (its kernels 5 and 6: the plain driver's
    iterations take seconds) takes ``iterations`` from the cold start,
    then the backward's inputs about its iterate and a trial of the
    backward's gains at a random ladder step within the fraction-to-boundary
    maxima (so that the trials are feasible; a quarter's steps tripled past
    them, which fail), the slack SOC flag on half. Returns (problem,
    backward args, forward args)."""
    from cddp_tpu_torch.constraints.stack import PathStacker
    from cddp_tpu_torch.options import line_search_alphas
    from cddp_tpu_torch.solvers import ipddp

    dev, dtype = x0.device, x0.dtype
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=dtype)  # noqa: E731
    opts = m.solver_options(cfg)
    p, seeds, _ = mpcc_seeds_fn(m, track, cfg)(None, opts, x0)
    stk = PathStacker(p)
    sol = ipddp._drive(p, opts.replace(max_iterations=iterations), *seeds)
    X, U, Lam = sol.state_trajectory, sol.control_trajectory, sol.costate_trajectory
    Y = torch.cat([sol.dual_trajectories[n] for n in stk.names], -1)
    S = torch.cat([sol.slack_trajectories[n] for n in stk.names], -1)
    G = ipddp._eval_path(stk, X, U)
    mu, reg = sol.barrier_mu, sol.final_regularization
    back = ipddp.backward_inputs(p, stk, X, U, Y, S, G, mu, reg)
    bp = ipddp._backward_condensed(p, opts, stk, X, U, Y, S, G, mu, reg)
    a_pr_max, a_du_max = ipddp._max_step_sizes(S, Y, bp.dS, bp.dY, mu, opts)
    ladder = torch.tensor(line_search_alphas(opts.line_search)[:4], device=dev, dtype=dtype)
    B = x0.shape[0]
    alpha = ladder[torch.randint(0, len(ladder), (B,), generator=gen, device=dev)]
    over = torch.where(rand(B) < 0.25, 3.0, 1.0).to(dtype)
    fwd = (X[:, :-1], U, Y, S, bp.k_u, bp.K_u, bp.k_lambda[:, :-1], bp.K_lambda[:, :-1],
           Lam[:, :-1], bp.k_y, bp.K_y, bp.k_s, bp.K_s, x0,
           torch.minimum(alpha, a_pr_max * over), torch.minimum(alpha, a_du_max * over),
           ipddp._tau(opts, mu), rand(B) < 0.5)
    return p, back, fwd


def mpcc_check_x0(m, dev):
    """(a)'s cars: bench_mpcc.py's fleet at B_CHECK, off the centerline by up
    to 2 cm and 0.05 rad (so that the instances differ in more than their
    progress), float32-representable (so that the float64 run is the
    float32 one's truth). Returns (track, config, x0 float64)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    track, cfg, x0 = mpcc_fleet(m, dev, torch.float64, B_CHECK)
    jitter = torch.rand(B_CHECK, 3, generator=gen, device=dev, dtype=torch.float64) - 0.5
    x0 = x0 + torch.cat([jitter * torch.tensor([0.04, 0.04, 0.1], device=dev,
                                               dtype=torch.float64),
                         x0.new_zeros(B_CHECK, 4)], -1)
    return track, cfg, x0.float().double()


def mpcc_plain_refs(tt, dev):
    """Phase 20's plain references, in the plain references' process beside
    the build (no kernel): (a)'s cold seeds and plain-driver runs (float64,
    float32, and float32 from x0 one ulp up: the stable instances) over
    MPCC_ITERS iterations, and (b)'s cold tick on the plain engine at MPCC_B
    with its host ms and launches. Returns {key: value}."""
    from cddp_tpu_torch.solvers import ipddp

    m, out, t0 = mpcc_lib(), {}, time.perf_counter()
    track, cfg, x0_64 = mpcc_check_x0(m, dev)
    plain = plain_ip_options(tt, m.solver_options(cfg))
    seeds_fn = mpcc_seeds_fn(m, track, cfg)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        x0 = x0_64.to(dtype)
        for key, x in (("", x0), (" up", torch.nextafter(x0, torch.full_like(x0, math.inf)))):
            if key and dtype == torch.float64:
                continue
            p, seeds, _ = seeds_fn(None, plain, x)
            out[("seeds" + key, tag)] = seeds
            out[("plain" + key, tag)] = timed_plain(lambda: ipddp._drive(p, plain, *seeds))
            out[("plain ms" + key, tag)] = LAST_PLAIN_MS[0]
    print(f"phase 20's plain drivers done at {time.perf_counter() - t0:.1f} s", flush=True)
    track, cfg, x0 = mpcc_fleet(m, dev, torch.float32, MPCC_B)
    run = mpcc_tick_run(m, track, cfg, x0, plain_ip_options(tt, m.solver_options(cfg)), "plain",
                        warm=False)
    out["plain tick"] = run
    print(f"phase 20's plain tick done at {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def mpcc_checks(tt, dev, m, refs):
    """(a) the phase's kernels against their plain versions at B_CHECK on
    the fleet's operands (``mpcc_check_x0``: cars over 90% of the lap, their
    windows and seed controls): kernel 4 on the bicycle lane from the seed
    controls; kernels 6 (7x3x6) and 5 (the MPCC cost lane, with and without
    the slack SOC) on operands the plain driver stages after two iterations
    (``mpcc_stage``), each by ``check``'s rules (float64 within 1e-9 +
    ZOO_RTOL |v| plus twice the plain version's move from inputs one ulp
    up; float32 as accurate against float64 as the plain version within 2x,
    on the median and 99th percentile); kernel 7's GN build against the
    plain driver from the same cold seeds over MPCC_ITERS iterations, the
    plain runs ``refs`` (``mpcc_plain_refs``): float64 every status and
    iteration count equal, X, U, cost and mu within 1e-8, duals and slacks
    within 1e-8 + 1e-8 |plain|; float32 status, iterations and cost (rel
    1e-4) equal on >= 99% of the plain driver's stable instances (those on
    which it agrees so with its own run from x0 one ulp up, ``cost_agree``)
    and as accurate against float64 as the plain driver within 2x. Returns
    {dtype: {entry: max abs err}}."""
    from cddp_tpu_torch.ops.kernels import ip_rollout, mega_ipddp
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric

    errs = {"float64": {}, "float32": {}}
    as64 = lambda ts: tuple(t.double() if isinstance(t, torch.Tensor)  # noqa: E731
                            and t.is_floating_point() else t for t in ts)
    t0 = time.perf_counter()
    track, cfg, x0_64 = mpcc_check_x0(m, dev)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        exact = dtype == torch.float64
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        x0 = x0_64.to(dtype)
        opts = m.solver_options(cfg)
        trk = m.solve_track(track, cfg, x0[:, 3])
        prob = m.build_problem(trk, cfg, x0)
        U0 = m.seed_controls(trk, cfg, x0[:, 3])
        mdl, entry = prob.model, ip_rollout.model_lane(prob.model)
        got = ip_rollout._launch_open_loop(mdl, entry, x0, U0, cfg.dt)
        errs[tag]["open_loop_rollout@bicycle7"] = check(
            "open_loop_rollout@bicycle7", (got,),
            (ip_rollout.open_loop_rollout_plain(mdl, x0, U0, cfg.dt),),
            None if exact else (ip_rollout.open_loop_rollout_plain(
                mdl, x0.double(), U0.double(), cfg.dt),), rtol=ZOO_RTOL, quantiles=not exact,
            moved=(ip_rollout.open_loop_rollout_plain(mdl, *ulp_up((x0, U0)), cfg.dt),)
            if exact else None)
        p, back, fwd = mpcc_stage(tt, m, track, cfg, x0, gen)
        assert_varies("MPCC operands", back[0], back[2], back[4])
        got = ric._launch(*back)
        errs[tag]["ipddp_backward@mpcc"] = check(
            "ipddp_backward@7x3x6 (MPCC)", got, ric.ipddp_backward_plain(*back),
            None if exact else ric.ipddp_backward_plain(*as64(back)), rtol=ZOO_RTOL,
            quantiles=not exact, moved=ric.ipddp_backward_plain(*ulp_up(back)) if exact else None)
        err = 0.0
        for soc in (False, True):
            fc = forward_consts(p, opts, soc)
            if fc is None or fc.cost is None:
                raise AssertionError("the MPCC tick did not resolve kernel 5's cost lane")
            got = ip_rollout._launch_forward(fc, *fwd)
            err = max(err, check(
                f"ip_forward_mpcc@bicycle7 slack_soc={soc}", got,
                ip_rollout.ip_forward_plain(fc, *fwd),
                None if exact else ip_rollout.ip_forward_plain(
                    forward_consts(p, opts, soc, f64=True), *as64(fwd)),
                rtol=ZOO_RTOL, quantiles=not exact,
                moved=ip_rollout.ip_forward_plain(fc, *ulp_up(fwd)) if exact else None))
            print(f"[mpcc {tag}] ip_forward_mpcc slack_soc={soc}: feasible on "
                  f"{float(got[-1].double().mean()):.2%} of {B_CHECK}")
        errs[tag]["ip_forward_mpcc@bicycle7"] = err
        # Kernel 7 from the plain references' own cold seeds.
        pk = m.build_problem(trk, cfg, x0)
        if not mega_ipddp.mega_eligible(pk, opts):
            raise AssertionError("the MPCC tick is not eligible for kernel 7's GN build")
        kern = mega_ipddp._launch(pk, opts, *refs[("seeds", tag)])
        plain = refs[("plain", tag)]
        label = (f"ipddp_solve_mpcc_gn@bicycle7 N={cfg.horizon}, M={MPCC_COEFFS}, "
                 f"{cfg.max_iterations} iterations")
        same = ((kern.status_code == plain.status_code)
                & (kern.iterations_completed == plain.iterations_completed))
        errs[tag]["ipddp_solve_mpcc_gn@bicycle7"] = float(
            (kern.final_objective - plain.final_objective)[same].abs().max())
        if exact:
            check_ip_solve(label, kern, plain, True, dual_rtol=1e-8)
            truth64 = plain.final_objective
            continue
        stable = cost_agree(refs[("plain up", tag)], plain)
        print(f"[mpcc float32] {label}: the kernel agrees with the plain driver on "
              f"{cost_share(kern, plain):.4%} of {B_CHECK}; the plain driver with itself "
              f"from x0 one ulp up on {int(stable.sum())} (its stable instances, "
              f"{float(stable.double().mean()):.4%}), held at 99% there")
        check_ip_solve(f"{label}, stable instances", solution_rows(kern, stable),
                       solution_rows(plain, stable), False)
        rel = {n: (s.final_objective.double() - truth64).abs() / truth64.abs()
               for n, s in (("kernel", kern), ("plain", plain))}
        q = {n: (float(r.median()), float(r.quantile(0.99))) for n, r in rel.items()}
        print(f"[mpcc float32] {label} against the float64 plain driver: median rel cost "
              f"err kernel {q['kernel'][0]:.3e}, plain {q['plain'][0]:.3e}; 99th percentile "
              f"kernel {q['kernel'][1]:.3e}, plain {q['plain'][1]:.3e}")
        if not all(q["kernel"][i] <= 2.0 * q["plain"][i] + 1e-6 for i in (0, 1)):
            raise AssertionError(f"{label}: rel cost err against float64 {q['kernel']} "
                                 f"exceeds twice the plain driver's {q['plain']}")
    print(f"[mpcc] kernels held at {time.perf_counter() - t0:.1f} s")
    return errs


MPCC_LAUNCHES = {
    "whole": {"open_loop_rollout@bicycle7": 1, "ipddp_solve_mpcc_gn@bicycle7": 1},
    "per-pass": ("open_loop_rollout@bicycle7", "ip_forward_mpcc@bicycle7",
                 "ipddp_backward@7x3x6"),
}


def mpcc_tick_run(m, track, cfg, x0, opts, engine, reps=1, warm=True):
    """One engine's cold tick of the fleet (``batched_mpcc_step_costs``):
    a warm-up tick (with ``warm``), then ``reps`` timed ticks with the
    launch counts of the last. Returns (u, cost, iterations, status, ms a
    tick, launches)."""
    from cddp_tpu_torch.ops.kernels import dispatch_log

    if warm:
        m.batched_mpcc_step_costs(track, cfg, x0, options=opts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dispatch_log.reset()
        out = m.batched_mpcc_step_costs(track, cfg, x0, options=opts)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    launches = dict(dispatch_log.launches)
    u, cost, iters, status = out
    B = x0.shape[0]
    if engine == "whole" and launches != MPCC_LAUNCHES["whole"]:
        raise AssertionError(f"the MPCC tick at B={B} did not run as kernels 4 and 7: {launches}")
    if engine == "per-pass" and (set(launches) != set(MPCC_LAUNCHES["per-pass"])
                                 or launches["open_loop_rollout@bicycle7"] != 1):
        raise AssertionError(f"the per-pass MPCC tick at B={B} did not run on kernels 4, 5 "
                             f"and 6 alone: {launches}")
    if engine == "plain" and launches:
        raise AssertionError(f"the plain MPCC tick launched kernels: {launches}")
    lo = torch.tensor([cfg.speed_min, -cfg.delta_max, cfg.v_theta_min], device=u.device,
                      dtype=u.dtype)
    hi = torch.tensor([cfg.speed_max, cfg.delta_max, cfg.v_theta_max], device=u.device,
                      dtype=u.dtype)
    if not (bool(torch.isfinite(cost).all()) and bool(torch.isfinite(u).all())
            and bool(((u >= lo) & (u <= hi)).all()) and tuple(u.shape) == (B, 3)):
        raise AssertionError(f"the {engine} MPCC tick at B={B}: non-finite or out-of-box "
                             f"controls, or non-finite costs")
    return u, cost, iters, status, ms, launches


def mpcc_fleets(tt, dev, m, smi, refs):
    """(b) the cold fleet tick on each engine at MPCC_B (the plain driver
    too, run by the plain references' process, ``mpcc_plain_refs``, beside
    the build) and MPCC_BIG_B, float32: launch counts, ticks/s, mean iterations,
    statuses, the kernels' agreement with the plain driver's statuses; then
    the warm fleet (``warm_fleet_init``, then ticks of MPCC_WARM_ITERS
    iterations with the plant's step, bench_mpcc.py:39-69) at both sizes.
    Returns ({entry: launches in the runs that drive it}, {(B, engine):
    ms a tick}, operands captured from the per-pass run at MPCC_BIG_B for
    (d), the B = MPCC_BIG_B seeds of kernel 7)."""
    from cddp_tpu_torch.ops.kernels import ip_rollout
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric

    launches, ms = {}, {}
    captured = {}
    for B in (MPCC_B, MPCC_BIG_B):
        track, cfg, x0 = mpcc_fleet(m, dev, torch.float32, B)
        opts = m.solver_options(cfg)
        engines = {"whole": opts, "per-pass": opts.replace(solve_engine="xla")}
        if B == MPCC_B:
            engines["plain"] = None
        outs = {}
        for engine, o in engines.items():
            if engine == "plain":
                outs[engine] = refs["plain tick"]
            elif engine == "per-pass" and B == MPCC_BIG_B:
                # Capture the last operands of kernels 5 and 6 for (d).
                fwd, back = ip_rollout.ip_forward, ric.ipddp_backward

                def keep_fwd(fc, *a, _f=fwd):
                    captured["ip_forward"] = (fc, a)
                    return _f(fc, *a)

                def keep_back(*a, _f=back):
                    captured["ipddp_backward"] = a
                    return _f(*a)

                ip_rollout.ip_forward, ric.ipddp_backward = keep_fwd, keep_back
                try:
                    outs[engine] = mpcc_tick_run(m, track, cfg, x0, o, engine, warm=False)
                finally:
                    ip_rollout.ip_forward, ric.ipddp_backward = fwd, back
            else:
                # The per-pass tick (5.3 s on an NVIDIA H100 80GB HBM3) runs
                # once, after phase 20's checks ran its kernels.
                whole = engine == "whole"
                outs[engine] = mpcc_tick_run(m, track, cfg, x0, o, engine,
                                             reps=3 if whole else 1, warm=whole)
            u, cost, iters, status, t, counts = outs[engine]
            ms[(B, engine)] = t
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            agree = float((status == outs["whole"][3]).double().mean())
            print(f"[mpcc] cold tick, {engine} at B={B}: {B / t * 1e3:.1f} ticks/s ({t:.2f} ms "
                  f"a tick); mean iterations {float(iters.double().mean()):.2f}; statuses "
                  f"{torch.bincount(status.long(), minlength=4).tolist()}; status agrees with "
                  f"the whole solve's on {agree:.4%}; launches {counts}  [{smi}]")
        if B == MPCC_BIG_B:
            p, seeds, _ = mpcc_seeds_fn(m, track, cfg)(None, opts, x0)
            captured["ipddp_solve"] = (p, opts, seeds)
            captured["open_loop_rollout"] = (p.model, x0, seeds[1], cfg.dt)
        # The warm fleet: one cold solve of the whole budget seeds it.
        from cddp_tpu_torch.ops.kernels import dispatch_log

        cfg_w = dataclasses.replace(cfg, max_iterations=MPCC_WARM_ITERS)
        U, st = m.warm_fleet_init(track, cfg, x0)
        x, U, st, it = m.warm_fleet_step(track, cfg_w, x0, U, st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MPCC_WARM_TICKS):
            dispatch_log.reset()
            x, U, st, it = m.warm_fleet_step(track, cfg_w, x, U, st)
        torch.cuda.synchronize()
        t = (time.perf_counter() - t0) * 1e3 / MPCC_WARM_TICKS
        counts = dict(dispatch_log.launches)
        if counts != MPCC_LAUNCHES["whole"]:
            raise AssertionError(f"the warm MPCC tick at B={B} did not run as kernels 4 and 7: "
                                 f"{counts}")
        if not bool(torch.isfinite(x).all()) or tuple(U.shape) != (B, cfg.horizon, 3):
            raise AssertionError(f"the warm MPCC fleet at B={B}: non-finite states or plans")
        ms[(B, "warm")] = t
        print(f"[mpcc] warm tick ({MPCC_WARM_ITERS} iterations, the plant's step included) at "
              f"B={B}: {B / t * 1e3:.1f} ticks/s ({t:.2f} ms a tick); mean iterations "
              f"{float(it.double().mean()):.2f}; launches {counts}  [{smi}]")
    return launches, ms, captured


def mpcc_golden(tt, dev, m):
    """(c) tests/goldens/mpcc_tick.npz on the card in float64: the Fourier
    track's tick (15 iterations from ``initial_state``; the lanes decline a
    Fourier track, so the solve runs per pass, kernels 4 and 6 with the
    plain trial), held as tests/test_goldens.py holds the JAX package
    (cost rel 1e-9, X and U 1e-7 + 1e-9, status and iterations equal).
    Returns its launches."""
    import numpy as np

    from cddp_tpu_torch.ops.kernels import dispatch_log

    g = np.load(MPCC_GOLDEN)
    track = m.synthetic_track(device=dev)
    cfg = m.MpccConfig(max_iterations=15)
    x0 = m.initial_state(track, cfg)
    dispatch_log.reset()
    _, sol = m.mpc_tick(track, cfg, x0)
    torch.cuda.synchronize()
    launches = dict(dispatch_log.launches)
    if set(launches) != {"open_loop_rollout@bicycle7", "ipddp_backward@7x3x6"}:
        raise AssertionError(f"the golden tick's launches: {launches}")
    np.testing.assert_allclose(float(sol.final_objective), g["cost"], rtol=1e-9)
    np.testing.assert_allclose(sol.state_trajectory.cpu().numpy(), g["X"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(sol.control_trajectory.cpu().numpy(), g["U"], rtol=1e-7,
                               atol=1e-9)
    if int(sol.iterations_completed) != int(g["iterations"]) or int(sol.status_code) != int(
            g["status"]):
        raise AssertionError("the golden tick's status or iterations differ")
    print(f"[mpcc] golden mpcc_tick float64 on the card: cost {float(sol.final_objective)!r} "
          f"(golden {float(g['cost'])!r}), {int(sol.iterations_completed)} iterations, status "
          f"{int(sol.status_code)}; launches {launches}")
    return launches


def mpcc_gn_cost_ops(p, X, U):
    """Operations of the GN cost's derivatives on one instance's horizon
    (``p`` from ``first_instance``, X (1, N + 1, nx), U (1, N, nu)), each
    taken once, as kernel 7's GN policy needs them. At a step (every step
    does the same): the residuals with their tangent along theta, the one
    state the track window reads (one forward-mode pass, its arithmetic
    counted by ``count_ops``); one operation for each other Jacobian entry
    (a scaled constant of the residuals' affine terms); then 2 J'r and the
    blocks 2 Jx'Jx, 2 Ju'Ju and 2 Ju'Jx. At the terminal the same for its
    residuals, plus the affine extra's constant gradient. The plain
    objective does more: ``jacfwd`` carries all nx + nu tangents through
    the track lookup, and it takes the Jacobians once for the gradients
    and again for the Hessians."""
    from cddp_tpu_torch.costs import objective as objectives

    obj = p.objective
    if obj.batched:
        obj = dataclasses.replace(objectives._with_leaves(
            obj, [t[0] for t in objectives._leaves(obj)]), batched=False)
    theta = mpcc_lib().IDX_THETA
    nx, nu, N = X.shape[-1], U.shape[-1], U.shape[1]

    def along_theta(fn, x):
        e = torch.zeros_like(x)
        e[theta] = 1.0
        n_r = fn(x).numel()
        return count_ops(lambda: torch.func.jvp(fn, (x,), (e,)), moves=_AD_MOVES), n_r

    c, n_r = along_theta(lambda x: obj.running_residuals(x, U[0, 0], 0), X[0, 0])
    n = nx + nu
    blocks = nx * nx + nu * nu + nu * nx
    step = c + n_r * (n - 1) + (2 * n_r + 1) * n + (2 * n_r + 1) * blocks
    c_T, n_t = along_theta(obj.terminal_residuals, X[0, -1])
    terminal = c_T + n_t * (nx - 1) + (2 * n_t + 1) * nx + nx + (2 * n_t + 1) * nx * nx
    return N * step + terminal


def time_mpcc_kernels(tt, dev, m, captured, fleet_ms, smi):
    """(d) each entry's wrapper and device ms, plain ms and bound at
    MPCC_BIG_B, float32: kernel 4 on the fleet's seed controls, kernels 5
    and 6 on the last operands of the per-pass tick (``mpcc_fleets``),
    kernel 7 on the fleet's cold seeds (its bound from one counted launch's
    work, ``ipddp_solve_work``; its plain ms the plain engine's tick at
    MPCC_B). Returns {entry: timing tuple}."""
    from cddp_tpu_torch.ops.kernels import ip_rollout
    from cddp_tpu_torch.ops.kernels import ipddp_riccati as ric
    from cddp_tpu_torch.ops.kernels import mega_ipddp

    mdl, x0, U0, dt = captured["open_loop_rollout"]
    entry = ip_rollout.model_lane(mdl)
    fc, fwd = captured["ip_forward"]
    back = captured["ipddp_backward"]
    p, opts, seeds = captured["ipddp_solve"]
    fc1 = dataclasses.replace(fc, cost=dataclasses.replace(fc.cost, params=fc.cost.params[:1]))
    out5 = ip_rollout.ip_forward_plain(fc1, *one(fwd))
    ops5 = count_ops(lambda: ip_rollout.ip_forward_plain(fc1, *one(fwd)))
    cp = fc.cost.cp(x0.shape[0], x0)
    runs = {
        "open_loop_rollout@bicycle7": (
            lambda: ip_rollout._launch_open_loop(mdl, entry, x0, U0, dt), 20,
            lambda: ip_rollout.open_loop_rollout_plain(mdl, x0, U0, dt), 3),
        "ip_forward@mpcc": (lambda: ip_rollout._launch_forward(fc, *fwd), 20,
                            lambda: ip_rollout.ip_forward_plain(fc, *fwd), 3),
        "ipddp_backward@mpcc": (lambda: ric._launch(*back), 10,
                                lambda: ric.ipddp_backward_plain(*back), 2),
        "ipddp_solve@mpcc_gn": (lambda: mega_ipddp._launch(p, opts, *seeds), 3, None, 0),
    }
    X = ip_rollout.open_loop_rollout_plain(mdl, x0, U0, dt)
    work = {
        "open_loop_rollout@bicycle7": ((x0, U0), (X[:, 1:],), x0.shape[0] * count_ops(
            lambda: ip_rollout.open_loop_rollout_plain(mdl, x0[:1], U0[:1], dt))),
        "ip_forward@mpcc": (fwd + (cp,), ip_rollout.ip_forward_plain(fc, *fwd),
                            x0.shape[0] * ops5),
        "ipddp_backward@mpcc": (backward_operands_read(back), ric.ipddp_backward_plain(*back),
                                x0.shape[0] * count_ops(lambda: ric.ipddp_backward_plain(
                                    *one(back)))),
        "ipddp_solve@mpcc_gn": ipddp_solve_work(tt, p, opts, seeds, ops5, out5, (cp,),
                                                cost_ops=mpcc_gn_cost_ops),
    }
    plain = {"ipddp_solve@mpcc_gn": fleet_ms[(MPCC_B, "plain")]}
    runs["ipddp_solve@mpcc_gn"] = runs["ipddp_solve@mpcc_gn"][:2] + (None, 0)
    # The last timings of the run: where the profiler records no launch (as
    # of kernel 6 in phases 7 and 16-19), CUDA events around the wrapper,
    # which for kernel 6 copies nothing ("cuda_events"), for the others
    # with their layout copies ("cuda_events_wrapper").
    six = "ipddp_backward@mpcc"
    timing = time_kernels({k: v for k, v in runs.items() if k != six}, work, torch.float32, smi,
                          label=" (MPCC)", events_ok="wrapper", plain_ms=plain,
                          batch=MPCC_BIG_B)
    timing.update(time_kernels({six: runs[six]}, work, torch.float32, smi, label=" (MPCC)",
                               events_ok=True, batch=MPCC_BIG_B))
    names = dict(zip(("open_loop_rollout@bicycle7", "ip_forward@mpcc", "ipddp_backward@mpcc",
                      "ipddp_solve@mpcc_gn"), (e[0] for e in MPCC_ENTRIES)))
    return {names[k]: v for k, v in timing.items()}


def phase_mpcc(tt, dev, smi, refs):
    """Phase 20: the MPCC racing fleet (examples/mpcc_lib_torch.py, BASELINE
    config 5): (a) ``mpcc_checks``, (b) ``mpcc_fleets``, (c) ``mpcc_golden``,
    on the plain references of ``refs`` (a ``Side`` part that ran
    ``mpcc_plain_refs``). Returns (launches by entry, errors, fleet ms,
    captured operands)."""
    m = mpcc_lib()
    plain = refs.result(dev)
    errs = mpcc_checks(tt, dev, m, plain)
    launches, fleet_ms, captured = mpcc_fleets(tt, dev, m, smi, plain)
    golden = mpcc_golden(tt, dev, m)
    launches = {e[0]: launches.get(e[1], 0) for e in MPCC_ENTRIES}
    print(f"[mpcc] launches by entry in the fleets' runs: {launches}; the golden's {golden}")
    for name, _, _, _, _ in MPCC_ENTRIES:
        if not launches[name]:
            raise AssertionError(f"phase 20: {name} was launched no time in the fleets' runs")
    return launches, errs, fleet_ms, captured


def mpcc_record(tt, dev, m, launches, errs, timing):
    """Phase 20's entries of the kernels' JSON line."""
    from cddp_tpu_torch.ops.kernels import build

    out = []
    sources = {"open_loop_rollout": ("cddp_tpu_torch/ops/csrc/open_loop_rollout.cuh",
                                     "cddp_tpu/ops/pallas/ip_rollout.py:612"),
               "ip_forward": ("cddp_tpu_torch/ops/csrc/ip_forward.cuh",
                              "cddp_tpu/ops/pallas/ip_rollout.py:248"),
               "ipddp_backward": ("cddp_tpu_torch/ops/csrc/ipddp_backward_attitude.cu",
                                  "cddp_tpu/ops/pallas/ipddp_riccati.py:215"),
               "ipddp_solve": ("cddp_tpu_torch/ops/csrc/ipddp_solve.cuh",
                               "cddp_tpu/ops/pallas/mega_ipddp.py:555")}
    for name, logged, kernel, launcher, lane in MPCC_ENTRIES:
        a = build.kernel_attributes(f"{launcher}_f32", m.LANES_HEADER if lane else None)
        ms, plain, b_ms, b_by, dev_ms, source = timing[name]
        src, rep = sources[kernel]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "variant_of": kernel,
            "model": "bicycle7", "dispatch_name": logged,
            "lane": "examples/mpcc_lanes.cuh" if lane else None, "launches": launches[name],
            "max_abs_err": errs["float32"][name], "max_abs_err_f64": errs["float64"][name],
            "ms": ms, "device_ms": dev_ms, "device_ms_source": source, "plain_ms": plain,
            "plain_at": (f"B={MPCC_B}, float32, the plain engine's cold tick beside the "
                         "kernels' build" if kernel == "ipddp_solve"
                         else f"B={MPCC_BIG_B}, float32"),
            "batch": MPCC_BIG_B, "horizon": 20, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "registers": a["registers"], "spill_bytes": a["spill_bytes"],
            "smem_bytes": a["static_smem_bytes"] + a["dynamic_smem_bytes"],
            "blocks_per_sm": a["blocks_per_sm"]})
    return out


def side_checks(tt, dev):
    """Phases 9, 12, 13 and 15's kernel-against-plain checks, which a side
    process runs while the main process runs phases 3, 16, 17 and 18's and
    a second one phases 7, 11 and 14's (``zoo_side_checks``): the discrete
    models' (``discrete_checks``), kernels 9 and 8
    (``phase_barrier_kernels``), kernel 7's terminal variants and the
    per-pass engine on the terminal fleets (``terminal_checks``) and the
    warm seeds (``phase_warm_kernels``). Returns their errors by phase."""
    t0 = time.perf_counter()
    out = {"discrete": discrete_checks(tt, dev)}
    print(f"phase 15's checks done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["barrier"] = phase_barrier_kernels(tt, dev)
    print(f"phase 9's checks done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["terminal"] = terminal_checks(tt, dev)
    print(f"phase 12's checks done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["warm"] = phase_warm_kernels(tt, dev)
    print(f"phase 13's checks done at {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def zoo_side_checks(tt, dev):
    """Phases 7, 11, 14 and 19's kernel-against-plain checks, which a second
    side process runs beside ``side_checks``: kernel 7's ball variants and
    kernel 6 at m = 5 (``phase_obstacle_kernels``), the tracking variants
    (``tracking_checks``), phase 14's (a) (``zoo_checks``) and phase 19's
    kernels 1, 2, 4, 5 and 6 (``small_lane_checks``). Returns their results
    by phase."""
    t0 = time.perf_counter()
    out = {"zoo": zoo_checks(tt, dev)}
    print(f"phase 14's checks done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["obstacle"] = phase_obstacle_kernels(tt, dev)
    print(f"phase 7's checks done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["tracking"] = tracking_checks(tt, dev)
    print(f"phase 11's checks done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["small"] = small_lane_checks(tt, dev, SMALL_MODELS)
    print(f"phase 19's per-pass kernels' checks done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


SIDE_RUNS = {"quadrotor": quad_plain_refs, "attitude": attitude_plain_refs,
             "mpcc": mpcc_plain_refs,
             "spacecraft": sc_plain_refs, "small": small_plain_refs, "checks": side_checks,
             "zoo": zoo_side_checks}
# The side processes that check kernels (and so build the library); the
# others run plain drivers only.
CHECK_SIDES = ("checks", "zoo")
# Side processes that run several of SIDE_RUNS in turn, each part's result
# under its name: phase 16's plain references are in by 120-180 s, well
# before they are read, so phase 18's and 19's follow them in the same
# process (one process fewer sharing the card and the host's cores; after
# phase 17's, phase 19's held the main process up by 73 s on an NVIDIA
# H100 80GB HBM3).
SIDE_PARTS = {"quadrotor+spacecraft+small+mpcc": ("quadrotor", "spacecraft", "small",
                                                   "mpcc")}


def main():
    t_start = time.perf_counter()
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
    # Phases 16 and 17's plain references run plain drivers only: their
    # processes start now, beside the kernels' build, and are done before
    # the phases read them.
    refs = {kind: Side(kind) for kind in ("quadrotor+spacecraft+small+mpcc", "attitude")}
    try:
        run(t_start, smi, dev, kind, refs)
    finally:
        for r in refs.values():
            r.close()


def run(t_start, smi, dev, kind, refs):
    """Phases 2-19 and the result lines (``main``)."""
    import cddp_tpu_torch as tt
    from cddp_tpu_torch.ops.kernels import build, dispatch_log
    from cddp_tpu_torch.parallel.batch import batched_solve
    from cddp_tpu_torch.solvers import base

    # --- phase 2: build ------------------------------------------------------
    # The main library first; the MPCC lane library (phase 20's kernels)
    # compiles after it, beside phases 3 and 16-19's checks, and is joined
    # before phase 20 (a failed build raises there).
    t0 = time.perf_counter()
    lanes = mpcc_lib().LANES_HEADER
    fresh = not build.library_path().exists()
    build.build_all()
    print(f"[build] {'built' if fresh else 'loaded'} {build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")
    print_ptxas(build.library_path())
    lane_build = ThreadPoolExecutor(max_workers=1)
    lane_built = lane_build.submit(build.build_all, [lanes])
    lane_build.shutdown(wait=False)
    attrs = print_kernel_attributes(smi)
    print(f"[clock] phase 2 done at {time.perf_counter() - t_start:.1f} s")

    # --- phases 3, 16, 17 and 18's kernel checks, while two side processes
    # run phases 9, 12, 13 and 15's (``side_checks``) and 7, 11 and 14's
    # (``zoo_side_checks``); the fleets and every timing come after all
    # three, with the card to themselves. They run the plain drivers, and
    # every torch launch of a plain driver takes 1.6-1.7x as long once the
    # profiler has run in the process (PERF.md).
    sides = [Side(kind) for kind in CHECK_SIDES]
    try:
        errs = phase_kernels(tt, dev)
        print(f"[clock] phase 3 done at {time.perf_counter() - t_start:.1f} s")
        side_refs = refs["quadrotor+spacecraft+small+mpcc"]
        quad_checked = quad_checks(tt, dev, smi, side_refs.part("quadrotor"))
        att_checked = attitude_checks(tt, dev, smi, refs["attitude"])
        sc_checked = sc_checks(tt, dev, side_refs.part("spacecraft"))
        small_checked = small_checks(tt, dev, side_refs.part("small"))
        print(f"[clock] phases 16, 17, 18 and 19's checks done at "
              f"{time.perf_counter() - t_start:.1f} s")
        side_errs = {}
        for side in sides:
            side_errs.update(side.result(dev))
            print(f"[clock] the {side.kind} side process's checks in at "
                  f"{time.perf_counter() - t_start:.1f} s")
    finally:
        for side in sides:
            side.close()
    zoo_launches, zoo_errs, zoo_fleets, zoo_plain, zoo_plain_at = phase_zoo(tt, dev, smi,
                                                                            side_errs["zoo"])
    print(f"[clock] phase 14 fleets done at {time.perf_counter() - t_start:.1f} s")
    dis_launches, dis_errs, dis_fleets = phase_discrete(tt, dev, smi, side_errs["discrete"])
    print(f"[clock] phase 15 fleets done at {time.perf_counter() - t_start:.1f} s")
    quad_launches, quad_errs, quad_single = phase_quadrotor(tt, dev, smi, checked=quad_checked)
    print(f"[clock] phase 16 fleets done at {time.perf_counter() - t_start:.1f} s")
    att_launches, att_errs, att_fleets, att_plain = phase_attitude(tt, dev, smi,
                                                                   checked=att_checked)
    print(f"[clock] phase 17 fleets done at {time.perf_counter() - t_start:.1f} s")
    sc_launches, sc_errs, sc_fleets, sc_plain = phase_spacecraft(tt, dev, smi, sc_checked)
    print(f"[clock] phase 18 fleets done at {time.perf_counter() - t_start:.1f} s")
    small_launches, small_errs, small_fleets, small_plain = phase_small(
        tt, dev, smi, small_checked, side_errs["small"])
    print(f"[clock] phase 19 fleets done at {time.perf_counter() - t_start:.1f} s")
    lane_secs = lane_built.result()
    print(f"[build] built {build.lane_library_path(lanes).name} in {lane_secs:.1f} s beside "
          f"the checks; in at {time.perf_counter() - t_start:.1f} s")
    print_ptxas(build.lane_library_path(lanes))
    mpcc_launches, mpcc_errs, mpcc_ms, mpcc_captured = phase_mpcc(
        tt, dev, smi, side_refs.part("mpcc"))
    print(f"[clock] phase 20's checks and fleets done at {time.perf_counter() - t_start:.1f} s")
    zoo_timing = time_zoo_kernels(tt, zoo_fleets, zoo_plain, smi)
    dis_timing, dis_at = time_discrete_kernels(tt, dis_fleets, smi)
    print(f"[clock] phases 14-15 timings done at {time.perf_counter() - t_start:.1f} s")

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

    # Each engine's launch counts, zeroed just before its own run; the plain
    # driver runs on the first B_CHECK instances, timed (``plain_at``).
    sols, counts, took = {}, {}, {}
    for name, o in engines.items():
        dispatch_log.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols[name] = batched_solve(prob, fleet_batch(name, x0), "CLDDP", o)
        torch.cuda.synchronize()
        took[name] = time.perf_counter() - t0
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
    # Launches of each kernel in the default engine's run of each fleet.
    default = {"CLDDP fleet": counts["whole-solve kernel"]}

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
    rel = (cost[:B_CHECK] - plain_cost).abs() / plain_cost.abs()
    close = float((rel <= 1e-4).double().mean())
    print(f"[main] whole-solve kernel cost within rel 1e-4 of the plain driver's "
          f"on {close:.4%} of the first {B_CHECK} (median rel {float(rel.median()):.3e})")
    if close < 0.99:
        raise AssertionError(f"whole-solve kernel and plain driver costs agree on "
                             f"{close:.4%} of instances (need >= 99%)")

    reps = {"whole-solve kernel": 20, "per-pass kernels": 3}
    rates = {}
    for name, o in engines.items():
        def run(o=o):
            return batched_solve(prob, x0, "CLDDP", o).final_objective

        if name == "plain driver":  # timed in its one run above
            dt, n, n_reps = took[name], B_CHECK, 1
        else:
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps[name]):
                run()
            torch.cuda.synchronize()
            dt, n, n_reps = (time.perf_counter() - t0) / reps[name], B_MAIN, reps[name]
        rates[name] = n / dt
        agree = float((sols[name].status_code == whole.status_code[:n]).double().mean())
        print(f"[main] {name}: {rates[name]:.1f} solves/s ({dt * 1e3:.2f} ms per "
              f"B={n} solve, {n_reps} reps); status agrees with the "
              f"whole-solve kernel on {agree:.4%}  [{smi}]")

    # Kernel times at the main path's batch against their plain versions,
    # and each one's bound from this run's inputs. A whole solve's plain
    # time is its fleet's plain-driver run above, at B_CHECK.
    timing = time_clddp_kernels(prob, x0, opts, smi,
                                plain_ms={"clddp_solve": plain_run_ms(rates)})

    # --- phase 5: the IPDDP kernels against their plain versions ----------------
    errs.update({k: {**errs[k], **v} for k, v in phase_ip_kernels(tt, dev).items()})

    # --- phase 6: the IPDDP box fleet through batched_solve ----------------------
    ip_launches, default["IPDDP fleet"], ip_rates, ip_prob, ip_x0 = phase_ip_fleet(tt, dev, smi)
    launches.update(ip_launches)
    timing.update(time_ip_kernels(tt, ip_prob, ip_x0, smi,
                                  plain_ms={"ipddp_solve": plain_run_ms(ip_rates)}))
    print(f"[clock] phases 1-6 done at {time.perf_counter() - t_start:.1f} s")

    # --- phase 7: kernel 7's ball variant and kernel 6 at m = 5 (checked by
    # the side process) -------------------------------------------------------
    obstacle_errs = side_errs["obstacle"]
    print(f"[clock] phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # --- phase 8: the IPDDP obstacle fleet through batched_solve -----------------
    ob_launches, default["IPDDP obstacle fleet"], ob_rates, ob_prob, ob_x0 = phase_ip_fleet(
        tt, dev, smi, obstacle=True)
    ob_timing = time_obstacle_kernels(tt, ob_prob, ob_x0, smi,
                                      plain_ms={"ipddp_solve": plain_run_ms(ob_rates)})
    print(f"[clock] phase 8 done at {time.perf_counter() - t_start:.1f} s")

    # --- phase 9: kernels 9 and 8 against their plain drivers (the side
    # process) ----------------------------------------------------------------
    errs.update({k: {**errs[k], **v} for k, v in side_errs["barrier"].items()})
    print(f"[clock] phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # --- phase 10: the LogDDP and MSIPDDP box fleets through batched_solve -------
    bar_launches, bar_default, bar_rates, bar_prob, bar_x0 = phase_barrier_fleets(tt, dev, smi)
    launches.update(bar_launches)
    default.update(bar_default)
    timing.update(time_barrier_kernels(tt, bar_prob, bar_x0, smi, plain_ms={
        kernel: plain_run_ms(bar_rates[solver])
        for solver, kernel in (("LogDDP", "logddp_solve"), ("MSIPDDP", "msipddp_solve"))}))
    print(f"[clock] phase 10 done at {time.perf_counter() - t_start:.1f} s")

    # --- phase 11: tracking MPC --------------------------------------------------
    tr_launches, tr_default, tr_errs, tr_timing = phase_tracking(tt, dev, smi,
                                                                 side_errs["tracking"])
    print(f"[clock] phase 11 done at {time.perf_counter() - t_start:.1f} s")

    # --- phase 12: terminal constraints ---------------------------------------------
    te_launches, te_errs, te_timing, te_work, te_attrs = phase_terminal(tt, dev, smi,
                                                                        side_errs["terminal"])
    print(f"[clock] phase 12 done at {time.perf_counter() - t_start:.1f} s")

    # --- phase 13: warm starts --------------------------------------------------------
    warm_entries, certified = phase_warm(tt, dev, smi, side_errs["warm"])
    print(f"[clock] phase 13 done at {time.perf_counter() - t_start:.1f} s")

    # --- phase 16's timings come last: with them beside phases 14-15's, the
    # profiler recorded no launch of kernel 6 in any later session (phase 6's
    # included) on an H100 machine, a limit of the profiler's sessions a
    # process can hold; here kernel 6 falls back to CUDA events around its
    # wrapper, which copies nothing.
    quad_timing = time_quad_kernels(tt, dev, quad_single, smi)
    print(f"[clock] phase 16 timings done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    att_timing = time_attitude_kernels(tt, dev, att_fleets, att_plain, smi)
    print(f"[clock] phase 17 timings done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    sc_timing = time_sc_kernels(tt, dev, sc_fleets, sc_plain, smi)
    print(f"[clock] phase 18 timings done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    small_timing = time_small_kernels(tt, dev, small_fleets, small_plain, smi)
    print(f"[clock] phase 19 timings done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    mpcc_timing = time_mpcc_kernels(tt, dev, mpcc_lib(), mpcc_captured, mpcc_ms, smi)
    del mpcc_captured
    print(f"[clock] phase 20 timings done at {time.perf_counter() - t_start:.1f} s")

    sources = {
        "riccati_backward": ("cddp_tpu_torch/ops/csrc/riccati_backward.cu",
                             "cddp_tpu/ops/pallas/riccati.py:236"),
        "forward_rollout": ("cddp_tpu_torch/ops/csrc/forward_rollout.cu",
                            "cddp_tpu/ops/pallas/rollout.py:616"),
        "clddp_solve": ("cddp_tpu_torch/ops/csrc/clddp_solve.cu",
                        "cddp_tpu/ops/pallas/mega_clddp.py:303"),
        "open_loop_rollout": ("cddp_tpu_torch/ops/csrc/open_loop_rollout.cu",
                              "cddp_tpu/ops/pallas/ip_rollout.py:612"),
        "ip_forward": ("cddp_tpu_torch/ops/csrc/ip_forward.cu",
                       "cddp_tpu/ops/pallas/ip_rollout.py:248"),
        "ipddp_backward": ("cddp_tpu_torch/ops/csrc/ipddp_backward.cu",
                           "cddp_tpu/ops/pallas/ipddp_riccati.py:215"),
        "ipddp_solve": ("cddp_tpu_torch/ops/csrc/ipddp_solve.cu",
                        "cddp_tpu/ops/pallas/mega_ipddp.py:555"),
        "msipddp_solve": ("cddp_tpu_torch/ops/csrc/msipddp_solve.cu",
                          "cddp_tpu/ops/pallas/mega_msipddp.py:302"),
        "logddp_solve": ("cddp_tpu_torch/ops/csrc/logddp_solve.cu",
                         "cddp_tpu/ops/pallas/mega_logddp.py:192"),
    }
    # No single PyTorch call computes any of these functions, so library_ms
    # is null for each. The whole solves' plain ms of phases 4-13 are their
    # plain drivers' on the first B_CHECK instances ("plain_at").
    # "launches" counts the run that drives the kernel
    # (the default engine's, or for kernels 1, 2, 5 and 6 the per-pass
    # engine's); "default_launches" the default engine's runs of the five
    # fleets (the four box fleets and the obstacle fleet). "ms" is CUDA
    # events around the wrapper, "device_ms" the kernel alone, by the
    # profiler or, where it recorded no launch, by CUDA events around a
    # wrapper that copies nothing ("device_ms_source").
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "default_launches": sum(c.get(name, 0) for c in default.values()),
         "max_abs_err": errs["float32"][name],
         "ms": timing[name][0], "device_ms": timing[name][4],
         "device_ms_source": timing[name][5], "plain_ms": timing[name][1],
         "plain_at": plain_at() if name in WHOLE_SOLVES else f"B={B_MAIN}, float32",
         "bound_ms": timing[name][2], "bound_by": timing[name][3], "library_ms": None,
         "registers": attrs[name]["registers"], "spill_bytes": attrs[name]["spill_bytes"],
         "smem_bytes": attrs[name]["static_smem_bytes"] + attrs[name]["dynamic_smem_bytes"],
         "blocks_per_sm": attrs[name]["blocks_per_sm"]}
        for name, (src, rep) in sources.items()
    ]}
    # This slice's path, the obstacle fleet: kernel 7's ball variant (its
    # launches in phase 8's default-engine run, its times and bound from this
    # run's obstacle seeds) and kernel 6 at m = 5 (launches in phase 8's
    # per-pass run); kernel 5 takes no ball and shows 0 there.
    by_name = {k["name"]: k for k in record["kernels"]}
    for name, variant, key in (("ipddp_solve", "cddp_ipddp_solve_unicycle_m5_ball0", "obstacle"),
                               ("ipddp_backward", "cddp_ipddp_backward_3x2x5", "obstacle_m5"),
                               ("ip_forward", None, "obstacle")):
        entry = {"launches": ob_launches.get(name, 0)}
        if variant is not None:
            a = build.kernel_attributes(f"{variant}_f32")
            ms, plain_ms, b_ms, b_by, dev_ms, source = ob_timing[name]
            entry.update(ms=ms, device_ms=dev_ms, device_ms_source=source,
                         plain_ms=plain_ms, bound_ms=b_ms,
                         plain_at=plain_at() if name in WHOLE_SOLVES else f"B={B_MAIN}, float32",
                         bound_by=b_by, max_abs_err=obstacle_errs["float32"][name],
                         max_abs_err_f64=obstacle_errs["float64"][name],
                         registers=a["registers"], spill_bytes=a["spill_bytes"],
                         smem_bytes=a["static_smem_bytes"] + a["dynamic_smem_bytes"],
                         blocks_per_sm=a["blocks_per_sm"])
        by_name[name][key] = entry
    # Phase 11's tracking variants, each an entry of its own: launches in
    # the tracking run that drives it (the MPC ticks for kernel 3's, the
    # per-pass fleets for kernels 2 and 5's, the whole-solve fleets for
    # kernels 7, 8 and 9's), "default_launches" in the tracking MPC ticks
    # and whole-solve fleets; times and bounds on the tracking fleet's
    # inputs; attributes of the m = 4 (box) variant, and kernel 7's
    # m5_ball0 variant's errors and attributes under "ball".
    track_stems = {k: next(s for s in stems if s.endswith("_track"))
                   for k, stems in launchers().items() if k in TRACKING}
    for name, track in TRACKING.items():
        a = build.kernel_attributes(f"{track_stems[name]}_f32")
        ms, plain_ms, b_ms, b_by, dev_ms, source = tr_timing[track]
        src, rep = sources[name]
        entry = {"name": track, "route": "cuda", "source": src, "replaces": rep,
                 "variant_of": name, "launches": tr_launches[track],
                 "default_launches": sum(c.get(track, 0) for c in tr_default.values()),
                 "max_abs_err": tr_errs["float32"][track],
                 "max_abs_err_f64": tr_errs["float64"][track],
                 "ms": ms, "device_ms": dev_ms, "device_ms_source": source,
                 "plain_ms": plain_ms,
                 "plain_at": plain_at() if name in WHOLE_SOLVES else f"B={B_MAIN}, float32",
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "registers": a["registers"], "spill_bytes": a["spill_bytes"],
                 "smem_bytes": a["static_smem_bytes"] + a["dynamic_smem_bytes"],
                 "blocks_per_sm": a["blocks_per_sm"]}
        if name == "ipddp_solve":
            b = build.kernel_attributes("cddp_ipddp_solve_unicycle_m5_ball0_track_f32")
            entry["ball"] = {"max_abs_err": tr_errs["float32"]["ipddp_solve_track_ball"],
                             "max_abs_err_f64": tr_errs["float64"]["ipddp_solve_track_ball"],
                             "registers": b["registers"], "spill_bytes": b["spill_bytes"],
                             "smem_bytes": b["static_smem_bytes"] + b["dynamic_smem_bytes"],
                             "blocks_per_sm": b["blocks_per_sm"]}
        record["kernels"].append(entry)
    # Phase 12's terminal variants of kernel 7, each an entry of its own:
    # launches in phase 12's main-path run of its fleet, times and bound on
    # that fleet's cold seeds, work per instance, float32 attributes.
    for variant, name in TERMINAL.items():
        ms, plain_ms, b_ms, b_by, dev_ms, source = te_timing[name]
        a = te_attrs[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": "cddp_tpu_torch/ops/csrc/ipddp_solve_terminal.cu",
            "replaces": sources["ipddp_solve"][1], "variant_of": "ipddp_solve",
            "launches": te_launches[name], "default_launches": te_launches[name],
            "max_abs_err": te_errs["float32"][name], "max_abs_err_f64": te_errs["float64"][name],
            "ms": ms, "device_ms": dev_ms, "device_ms_source": source, "plain_ms": plain_ms,
            "plain_at": plain_at(), "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "attempts": te_work[name][0], "sweeps": te_work[name][1],
            "registers": a["registers"], "spill_bytes": a["spill_bytes"],
            "smem_bytes": a["static_smem_bytes"] + a["dynamic_smem_bytes"],
            "blocks_per_sm": a["blocks_per_sm"]})
    # Phase 13's warm starts: kernels 7, 8 and 9 from warm seeds, each under
    # "warm": launches in the warm MPC runs (kernels 7 and 8's tracking
    # variants) and the warm-gains LogDDP fleet, device ms on their seeds,
    # errors against the plain drivers; kernel 7's also the certified
    # fleet's float64 polish launches and the MPC ms and iterations a tick.
    for name, entry in warm_entries.items():
        by_name[name]["warm"] = entry
    by_name["ipddp_solve"]["warm"]["certified_fleet"] = certified
    # Phase 14's instantiations, each an entry of its own named with its
    # model: launches in the run that drives it (the fleets' main paths for
    # the whole solves and the rendezvous's kernels 4 and 5, a short run for
    # the others), errors from (a), times and bound at B_MAIN on that run's
    # inputs; the whole solves' plain ms are the plain drivers' of (a)
    # ("plain_at").
    for name, logged, kernel, model, launcher in ZOO_ENTRIES:
        ms, plain_ms, b_ms, b_by, dev_ms, source = zoo_timing[name]
        a = build.kernel_attributes(f"{launcher}_f32")
        src, rep = sources[kernel]
        if "_te" in name:
            src = "cddp_tpu_torch/ops/csrc/ipddp_solve_terminal.cu"
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "variant_of": kernel,
            "model": model, "dispatch_name": logged, "launches": zoo_launches[logged],
            "max_abs_err": zoo_errs["float32"][name], "max_abs_err_f64": zoo_errs["float64"][name],
            "ms": ms, "device_ms": dev_ms, "device_ms_source": source, "plain_ms": plain_ms,
            "plain_at": zoo_plain_at.get(name, f"B={B_MAIN}, float32"),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "registers": a["registers"], "spill_bytes": a["spill_bytes"],
            "smem_bytes": a["static_smem_bytes"] + a["dynamic_smem_bytes"],
            "blocks_per_sm": a["blocks_per_sm"]})
    # Phase 15's instantiations, each an entry of its own named with its
    # model (kernels 1 and 6 log their shape, "dispatch_name"): launches in
    # the phase's run that drives it (the car fleets, the LTISystem fleet,
    # the forklift's rollout), errors from (a), times, plain ms and bound on
    # that run's operands at the batch "plain_at" names.
    for name, logged, kernel, model, launcher in DISCRETE_ENTRIES:
        ms, plain_ms, b_ms, b_by, dev_ms, source = dis_timing[name]
        a = build.kernel_attributes(f"{launcher}_f32")
        src, rep = sources[kernel]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "variant_of": kernel,
            "model": model, "dispatch_name": logged, "launches": dis_launches[name],
            "max_abs_err": dis_errs["float32"][name], "max_abs_err_f64": dis_errs["float64"][name],
            "ms": ms, "device_ms": dev_ms, "device_ms_source": source, "plain_ms": plain_ms,
            "plain_at": f"B={dis_at[name]}, float32", "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "registers": a["registers"], "spill_bytes": a["spill_bytes"],
            "smem_bytes": a["static_smem_bytes"] + a["dynamic_smem_bytes"],
            "blocks_per_sm": a["blocks_per_sm"]})
    # Phase 16's instantiations, each an entry of its own named with its
    # model (kernels 1 and 6 log their shape, "dispatch_name"): launches in
    # the phase's run that drives it (the quadrotor and QuadrotorRate
    # fleets, the figure-8 anchor for kernel 5's tracking form), errors
    # from (a), times, plain ms and bound at QUAD_B on that fleet's operands,
    # taken last in the run (the plain ms after every profiler session).
    for name, logged, kernel, model, launcher in QUAD_ENTRIES:
        ms, plain_ms, b_ms, b_by, dev_ms, source = quad_timing[name]
        a = build.kernel_attributes(f"{launcher}_f32")
        src, rep = sources[kernel]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "variant_of": kernel,
            "model": model, "dispatch_name": logged, "launches": quad_launches[name],
            "max_abs_err": quad_errs["float32"][name],
            "max_abs_err_f64": quad_errs["float64"][name],
            "ms": ms, "device_ms": dev_ms, "device_ms_source": source, "plain_ms": plain_ms,
            "plain_at": f"B={QUAD_B}, float32, after phases 4-13", "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "registers": a["registers"], "spill_bytes": a["spill_bytes"],
            "smem_bytes": a["static_smem_bytes"] + a["dynamic_smem_bytes"],
            "blocks_per_sm": a["blocks_per_sm"]})
    # Phase 17's instantiations, each an entry of its own named with its
    # model (kernels 1 and 6 log their shape, "dispatch_name"): launches in
    # the phase's run that drives it (the slew fleets per pass for kernels 1,
    # 2, 4, 5 and 6, the MPC fleets for the whole solves), errors from (a),
    # times and bound on that run's operands (kernels 1-6 at SLEW_B and N =
    # SLEW_N, the whole solves at B_MAIN and N = MPC_N), the whole solves'
    # plain ms their plain drivers' at B_CHECK in (a) ("plain_at").
    for name, logged, kernel, model, launcher in att_entries():
        ms, plain_ms, b_ms, b_by, dev_ms, source = att_timing[name]
        a = build.kernel_attributes(f"{launcher}_f32")
        src, rep = sources[kernel]
        if kernel == "ipddp_solve":
            src = "cddp_tpu_torch/ops/csrc/ipddp_solve_attitude.cu"
        whole = kernel in WHOLE_SOLVES
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "variant_of": kernel,
            "model": model, "dispatch_name": logged, "launches": att_launches[name],
            "max_abs_err": att_errs["float32"][name], "max_abs_err_f64": att_errs["float64"][name],
            "ms": ms, "device_ms": dev_ms, "device_ms_source": source, "plain_ms": plain_ms,
            "plain_at": (f"B={B_CHECK}, float32, {ATT_WHOLE_ITERS} iterations, N={MPC_N}, "
                         "beside the kernels' build" if whole
                         else f"(a)'s operands: B={ATT_KERNEL_B} (kernels 1, 2, 4) or {B_CHECK} "
                         f"(5, 6), float32, N={SLEW_N}, beside the check processes"),
            "batch": B_MAIN if whole else SLEW_B, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "registers": a["registers"], "spill_bytes": a["spill_bytes"],
            "smem_bytes": a["static_smem_bytes"] + a["dynamic_smem_bytes"],
            "blocks_per_sm": a["blocks_per_sm"]})
    # Phase 18's instantiations, each an entry of its own named with its
    # model (kernels 1 and 6 log their shape, "dispatch_name"): launches in
    # the phase's run that drives it (the long-horizon fleets per pass for
    # kernels 1, 2, 4, 5 and 6, the MPC fleets for the whole solves, the
    # nonlinear model's kernels 3 and 7 at the JAX gates' horizons), errors
    # from (a), times and bound on that run's operands (kernels 1-6 at
    # SC_LONG_B and N = SC_LONG_N, the whole solves at B_MAIN), the whole
    # solves' plain ms their plain drivers' at B_CHECK in (a) ("plain_at").
    sc_sources = {"clddp_solve": "clddp_solve_spacecraft.cu",
                  "ipddp_solve": "ipddp_solve_spacecraft.cu",
                  "logddp_solve": "logddp_solve_spacecraft.cu"}
    for name, logged, kernel, model, launcher in sc_entries():
        ms, plain_ms, b_ms, b_by, dev_ms, source = sc_timing[name]
        a = build.kernel_attributes(f"{launcher}_f32")
        src, rep = sources[kernel]
        if kernel in sc_sources:
            src = "cddp_tpu_torch/ops/csrc/" + sc_sources[kernel]
        elif kernel == "ipddp_backward":
            src = "cddp_tpu_torch/ops/csrc/ipddp_backward_" + (
                "attitude.cu" if SC_SHAPES[model][:2] == (6, 3) else "spacecraft.cu")
        whole = kernel in WHOLE_SOLVES
        horizon = fleet_horizon(sc_family(), kernel, model) if whole else SC_LONG_N
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "variant_of": kernel,
            "model": model, "dispatch_name": logged, "launches": sc_launches[name],
            "max_abs_err": sc_errs["float32"][name], "max_abs_err_f64": sc_errs["float64"][name],
            "ms": ms, "device_ms": dev_ms, "device_ms_source": source, "plain_ms": plain_ms,
            "plain_at": (f"B={B_CHECK}, float32, {SC_WHOLE_ITERS} iterations, N={horizon}, "
                         "beside the kernels' build" if whole
                         else f"(a)'s operands: B={SC_KERNEL_B} (kernels 1, 2, 4) or {B_CHECK} "
                         f"(5, 6), float32, N={SC_LONG_N}, beside the check processes (kernel "
                         f"1 on the lander: the first {SC_KERNEL_B} operands, after phases "
                         f"4-17)"),
            "batch": B_MAIN if whole else SC_LONG_B, "horizon": horizon,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "registers": a["registers"], "spill_bytes": a["spill_bytes"],
            "smem_bytes": a["static_smem_bytes"] + a["dynamic_smem_bytes"],
            "blocks_per_sm": a["blocks_per_sm"]})
    # Phase 19's instantiations, each an entry of its own named with its
    # model (kernels 1 and 6 log their shape, "dispatch_name"): launches in
    # the phase's runs that drive it (the long-horizon fleets, per pass where
    # the gates route them so or through the per-pass engine, for kernels 1,
    # 2, 4, 5 and 6; the MPC fleets and the long-horizon fleets the gates
    # keep whole for the whole solves), errors from (a), times and bound on
    # those runs' operands (kernels 1-6 at SMALL_LONG_B and N = SMALL_LONG_N,
    # the whole solves at B_MAIN and N = MPC_N), the whole solves' plain ms
    # their plain drivers' at B_CHECK in (a) ("plain_at").
    built = launchers()
    for name, logged, kernel, model, launcher in small_entries():
        ms, plain_ms, b_ms, b_by, dev_ms, source = small_timing[name]
        a = build.kernel_attributes(f"{launcher}_f32")
        src, rep = sources[kernel]
        if launcher in built.get(f"{kernel}_small", ()):
            src = f"cddp_tpu_torch/ops/csrc/{kernel}_small.cu"
        whole = kernel in WHOLE_SOLVES
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "variant_of": kernel,
            "model": model, "dispatch_name": logged, "launches": small_launches[name],
            "max_abs_err": small_errs["float32"][name],
            "max_abs_err_f64": small_errs["float64"][name],
            "ms": ms, "device_ms": dev_ms, "device_ms_source": source, "plain_ms": plain_ms,
            "plain_at": (f"B={B_CHECK}, float32, {SMALL_WHOLE_ITERS} iterations, N={MPC_N}, "
                         "beside the kernels' build" if whole
                         else f"B={SMALL_KERNEL_B} (the first of the operands), float32, "
                         f"N={SMALL_LONG_N}, after phases 4-18"),
            "batch": B_MAIN if whole else SMALL_LONG_B, "horizon": MPC_N if whole else SMALL_LONG_N,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "registers": a["registers"], "spill_bytes": a["spill_bytes"],
            "smem_bytes": a["static_smem_bytes"] + a["dynamic_smem_bytes"],
            "blocks_per_sm": a["blocks_per_sm"]})
    # Phase 20's instantiations (``MPCC_ENTRIES``): launches in the fleets'
    # runs (the cold ticks on the whole-solve and per-pass engines, the warm
    # ticks), errors from (a), times and bound at MPCC_BIG_B.
    record["kernels"] += mpcc_record(tt, dev, mpcc_lib(), mpcc_launches, mpcc_errs, mpcc_timing)
    print(f"[card] {smi}; CLDDP solves/s: " + ", ".join(
        f"{n} {r:.1f}" for n, r in rates.items()) + "; IPDDP solves/s: " + ", ".join(
        f"{n} {r:.1f}" for n, r in ip_rates.items()) + "".join(
        f"; {solver} solves/s: " + ", ".join(f"{n} {r:.1f}" for n, r in rs.items())
        for solver, rs in bar_rates.items()) + "; IPDDP obstacle solves/s: " + ", ".join(
        f"{n} {r:.1f}" for n, r in ob_rates.items()))
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"] and len(sys.argv) == 4:
        side_main(sys.argv[2], sys.argv[3])
    else:
        main()
