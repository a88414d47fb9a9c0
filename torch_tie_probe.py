"""How often the plain MSIPDDP driver forks from itself on the acrobot, on
the card: phase 19's float64 whole-solve case (``chip_smoke.whole_x0`` of
the small models' family, B_CHECK instances, MS_EXACT_ITERS iterations from
the family's seed controls) at N = 20 and at N = 27, the longest horizon the
JAX package's kernel-8 gate takes the acrobot at, run by the plain driver
from x0 and from x0 one ulp up. It prints the share of instances on which
the two runs agree in status and iterations, and also in every field within
1e-8 (``chip_smoke.whole_fields``, ``chip_smoke.fields_close``: what
``check_whole`` holds kernel 8 to). No kernel is built or launched:

    python3 torch_tie_probe.py

It needs one CUDA card. A kernel that rounds as the plain driver does
agrees with it about as often as the driver agrees with itself; kernel 8
is held to 1 - MS_TIE_SHARE (ROADMAP C.1, C.14).
"""

import math
import subprocess

import torch

import chip_smoke as cs
import cddp_tpu_torch as tt

MODEL = "acrobot"
HORIZONS = (cs.MPC_N, 27)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_tie_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    fam = cs.small_family()
    for horizon in HORIZONS:
        prob, x0 = cs.whole_x0(tt, dev, fam, MODEL, torch.float64, horizon)
        (a, fa), (b, fb) = (
            cs.whole_fields(cs.whole_run(tt, fam, prob, x, "MSIPDDP", True, fam.whole_iters))
            for x in (x0, torch.nextafter(x0, torch.full_like(x0, math.inf))))
        same = (a.status_code == b.status_code) & (a.iterations_completed == b.iterations_completed)
        close = same & cs.fields_close(fa, fb)
        print(f"MSIPDDP on {MODEL}, N={horizon}, {fam.whole_iters} iterations, "
              f"B={x0.shape[0]}, float64 on {torch.cuda.get_device_name(0)}: the plain driver "
              f"agrees with its run from x0 one ulp up in status and iterations on "
              f"{float(same.double().mean()):.4%}, and in every field within 1e-8 too on "
              f"{float(close.double().mean()):.4%}", flush=True)


if __name__ == "__main__":
    main()
