"""Build the CUDA kernels in ``cddp_tpu_torch/ops/csrc`` with ``nvcc`` and load
them with ``ctypes``.

The kernels export a plain C interface (pointers, ints and a stream), so no
source includes PyTorch's headers and a full build takes seconds, not
minutes. Each ``.cu`` file is compiled twice: once for float32 with nvcc's
defaults, and once for float64 with ``--fmad=false``, so the float64 build
rounds like the plain PyTorch operations it is checked against. Never
``--use_fast_math``: it changes sin, cos, division and denormals.

The shared library goes to ``.torch_ext_build/`` at the checkout root, named
by a hash of the sources and flags: the first call after a source change
builds, later calls load. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".torch_ext_build"

KERNEL_SOURCES = ("riccati_backward.cu", "forward_rollout.cu", "clddp_solve.cu",
                  "clddp_solve_spacecraft.cu", "clddp_solve_small.cu", "open_loop_rollout.cu",
                  "ip_forward.cu", "ipddp_backward.cu", "ipddp_backward_attitude.cu",
                  "ipddp_backward_spacecraft.cu", "ipddp_backward_small.cu", "ipddp_solve.cu",
                  "ipddp_solve_terminal.cu", "ipddp_solve_attitude.cu",
                  "ipddp_solve_spacecraft.cu", "ipddp_solve_small.cu", "logddp_solve.cu",
                  "logddp_solve_spacecraft.cu", "logddp_solve_small.cu", "msipddp_solve.cu",
                  "msipddp_solve_small.cu")
HEADERS = ("small_linalg.cuh", "clddp_step.cuh", "models.cuh", "ipddp_step.cuh",
           "ip_filter.cuh", "sweep_stage.cuh", "ipddp_solve.cuh", "ipddp_backward.cuh",
           "clddp_solve.cuh", "logddp_solve.cuh", "msipddp_solve.cuh")

COMMON_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "--expt-relaxed-constexpr", "-Xptxas=-v", "-Xcompiler", "-fPIC",
)
DTYPE_FLAGS = {"f32": (), "f64": ("--fmad=false", "-DCDDP_F64")}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in KERNEL_SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(repr((COMMON_FLAGS, DTYPE_FLAGS)).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcddp_kernels_{_digest()}.so"


def _compile(cmd):
    """(return code, nvcc's output, seconds) of one object's compile."""
    t0 = time.perf_counter()
    run = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return run.returncode, run.stdout, time.perf_counter() - t0


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds = [], []
        for src in KERNEL_SOURCES:
            for tag, flags in DTYPE_FLAGS.items():
                objs.append(Path(tmp) / f"{Path(src).stem}_{tag}.o")
                cmds.append([nvcc, *COMMON_FLAGS, *flags, "-c", str(CSRC / src),
                             "-o", str(objs[-1])])
        # Every object at once; each one's own seconds go to the log.
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            results = list(pool.map(_compile, cmds))
        logs, failed = [], []
        for obj, (rc, out, secs) in zip(objs, results):
            logs.append(f"== {obj.name} ({secs:.1f} s)\n{out}")
            if rc != 0:
                failed.append(obj.name)
        log = "\n".join(logs)
        (BUILD_DIR / f"{target.stem}.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log[-8000:]}")
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so), *(str(o) for o in objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout[-8000:]}")
        os.replace(tmp_so, target)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if the sources changed."""
    target = library_path()
    if not target.exists():
        _build(target)
    lib = ctypes.CDLL(str(target))
    lib.cddp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cddp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """A kernel launcher of the library; raises if it was not instantiated."""
    try:
        fn = getattr(library(), name)
    except AttributeError as e:
        raise ValueError(f"no CUDA kernel {name!r} in the kernel library") from e
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


ATTRIBUTES = ("registers", "spill_bytes", "static_smem_bytes", "dynamic_smem_bytes",
              "blocks_per_sm", "threads")


def kernel_attributes(name: str) -> dict:
    """What ``cudaFuncGetAttributes`` and the occupancy calculator report for
    the kernel of launcher ``name`` (with its ``_f32``/``_f64`` suffix) at the
    block size and dynamic shared memory it launches with: registers per
    thread, local (spill) bytes per thread, static and dynamic shared bytes
    per block, resident blocks per SM, threads per block."""
    lib = library()
    lib.cddp_kernel_attributes.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.cddp_kernel_attributes.restype = ctypes.c_int
    out = (ctypes.c_int * len(ATTRIBUTES))()
    check(lib.cddp_kernel_attributes(name.encode(), out), name)
    return dict(zip(ATTRIBUTES, out))


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().cddp_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


def dtype_tag(kernel: str, tensors, shapes) -> str:
    """Validate a kernel's inputs: CUDA float32/float64 tensors of one
    device and dtype, each of its (batch,) + shape. Returns "f32" or "f64"."""
    first = tensors[0]
    tag = {torch.float32: "f32", torch.float64: "f64"}.get(first.dtype)
    if first.device.type != "cuda" or tag is None:
        raise ValueError(f"{kernel} kernel takes CUDA float32/float64 tensors, "
                         f"got {first.device} {first.dtype}")
    batch = (first.shape[0],)
    for t, shape in zip(tensors, shapes):
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{kernel}: all inputs must share device and dtype")
        if tuple(t.shape) != batch + tuple(shape):
            raise ValueError(f"{kernel}: expected shape {batch + tuple(shape)}, "
                             f"got {tuple(t.shape)}")
    return tag


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def doubles(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_double * max(len(values), 1))(*values)
