"""Kernel 1 (the Riccati backward) on the spacecraft models' staged operands
at N = 20 and N = 100, in float32 and float64, against its plain version by
``chip_smoke.check``'s rules (float32: the BoxQP tie rule against the plain
version run in float64; float64: 1e-9 + ZOO_RTOL |v| plus twice the plain
version's one-ulp move), each verdict printed, none raised. It builds only
the Riccati and open-loop rollout objects, so it runs in about a minute:

    python3 torch_riccati_probe.py [--batch 1024]

It needs one CUDA card. ``riccati.LEFT_OUT_MODELS`` and
``chip_smoke.SC_RICCATI_F32_N`` record what it found (ROADMAP C.13).
"""

import argparse
import subprocess

import torch

import chip_smoke as cs
import cddp_tpu_torch as tt
from cddp_tpu_torch.ops.kernels import build, riccati


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=cs.SC_KERNEL_B)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_riccati_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    build.KERNEL_SOURCES = ("riccati_backward.cu", "open_loop_rollout.cu")
    build.library()
    dev = torch.device("cuda", 0)

    def as64(ts):
        return tuple(t.double() if isinstance(t, torch.Tensor) and t.is_floating_point() else t
                     for t in ts)

    for model in cs.SC_MODELS:
        for N in (20, 100):
            for dtype in (torch.float32, torch.float64):
                gen = torch.Generator(device=dev).manual_seed(cs.SEED + 84)
                back = cs.sc_stage(cs.sc_maker(model, N)(tt, dtype, dev), args.batch, gen)[2]
                exact = dtype == torch.float64
                label = f"riccati_backward@{model} N={N} {str(dtype)[6:]}"
                try:
                    cs.check(label, riccati._launch(*back), riccati.riccati_backward_plain(*back),
                             None if exact else riccati.riccati_backward_plain(*as64(back)),
                             rtol=cs.ZOO_RTOL, quantiles=not exact, ties=not exact,
                             moved=riccati.riccati_backward_plain(*cs.ulp_up(back)) if exact
                             else None)
                    print(f"PASS {label}", flush=True)
                except AssertionError as e:
                    print(f"FAIL {label}: {e}", flush=True)


if __name__ == "__main__":
    main()
