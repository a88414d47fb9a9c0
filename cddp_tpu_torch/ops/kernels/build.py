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

**Lane libraries.** The kernels of user lanes (``ip_rollout.
register_model_lane``, ``register_cost_lane``, ``mega_ipddp.
register_gn_cost_lane``) are built per header: ``lane_library(header)``
instantiates, from the kernel templates of ``ops/csrc`` and the lanes'
structs in ``header``, kernel 4 on each model lane registered with it and
kernels 5 and 7 on each model lane with each cost and GN lane of the same
header, on the model's control box (m = 2 nu), float32 and float64. Its
name carries a digest of the header, the templates and the generated
instantiations. ``build_all`` compiles the main library and lane libraries
in one parallel compile. A failed build raises.
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
           "clddp_solve.cuh", "logddp_solve.cuh", "msipddp_solve.cuh", "lanes.cuh",
           "open_loop_rollout.cuh", "ip_forward.cuh", "library_exports.cuh")

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


def _build(target: Path, sources=None, pool=None) -> None:
    """Compile ``sources`` ({unit stem: path}; the main library's by
    default) for both types into ``target``, every object at once (in
    ``pool`` when given, which may be compiling another library too)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sources or {Path(src).stem: CSRC / src for src in KERNEL_SOURCES}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds = [], []
        for stem, src in sources.items():
            for tag, flags in DTYPE_FLAGS.items():
                objs.append(Path(tmp) / f"{stem}_{tag}.o")
                cmds.append([nvcc, *COMMON_FLAGS, *flags, f"-I{CSRC}", "-c", str(src),
                             "-o", str(objs[-1])])
        # Every object at once; each one's own seconds go to the log.
        if pool is None:
            with ThreadPoolExecutor(max_workers=len(cmds)) as own:
                results = list(own.map(_compile, cmds))
        else:
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


def _load(target: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(target))
    lib.cddp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cddp_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if the sources changed."""
    target = library_path()
    if not target.exists():
        _build(target)
    return _load(target)


# --- lane libraries ------------------------------------------------------------------


def lane_units(header) -> dict:
    """The generated translation units of ``header``'s lane library, {stem:
    text}: kernels 4 and 5 in one (with the library's exports), kernel 7
    in the other, so that the two compile side by side."""
    from cddp_tpu_torch.ops.kernels import ip_rollout, mega_ipddp

    header = Path(header).resolve()
    models, costs = ip_rollout.registered_lanes(header)
    gns = mega_ipddp.registered_gn_lanes(header)
    if not models:
        raise ValueError(f"no model lane is registered with {header}")
    first = ["// Generated by cddp_tpu_torch/ops/kernels/build.py::lane_units."]
    k45 = first + ['#include "library_exports.cuh"', '#include "open_loop_rollout.cuh"',
                   '#include "ip_forward.cuh"', f'#include "{header}"', ""]
    k7 = first + ['#include "ipddp_solve.cuh"', f'#include "{header}"', ""]
    for name, struct, nu in models:
        k45.append(f"CDDP_OPEN_LOOP_ROLLOUT({name}, {struct})")
        k45 += [f"CDDP_IP_FORWARD_LANE({name}, {struct}, {c}, {cs}, {2 * nu})"
                for c, cs in costs]
        k7 += [f"CDDP_IPDDP_SOLVE_GN({name}, {struct}, {g}, {gs}, {2 * nu})" for g, gs in gns]
    units = {"lanes_k45": "\n".join(k45) + "\n"}
    if gns:
        units["lanes_k7"] = "\n".join(k7) + "\n"
    return units


def lane_library_path(header) -> Path:
    header = Path(header).resolve()
    h = hashlib.sha256()
    for name in HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(header.read_bytes())
    h.update(repr((lane_units(header), COMMON_FLAGS, DTYPE_FLAGS)).encode())
    return BUILD_DIR / f"liblanes_{header.stem}_{h.hexdigest()[:16]}.so"


def _build_lanes(target: Path, header, pool=None) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src_dir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        sources = {}
        for stem, text in lane_units(header).items():
            sources[stem] = src_dir / f"{stem}.cu"
            sources[stem].write_text(text)
        _build(target, sources, pool)
    finally:
        shutil.rmtree(src_dir, ignore_errors=True)


@functools.cache
def lane_library(header) -> ctypes.CDLL:
    """The loaded lane library of ``header``, built first if it or the
    kernel templates changed."""
    target = lane_library_path(header)
    if not target.exists():
        _build_lanes(target, header)
    return _load(target)


def build_all(headers=()) -> float:
    """Build the main library and the lane libraries of ``headers`` that are
    missing, all their objects in one parallel compile, and load them;
    returns the seconds it took."""
    t0 = time.perf_counter()
    headers = [Path(h).resolve() for h in headers]
    jobs = []
    if not library_path().exists():
        jobs.append(lambda pool: _build(library_path(), pool=pool))
    for header in headers:
        if not lane_library_path(header).exists():
            jobs.append(lambda pool, h=header: _build_lanes(lane_library_path(h), h, pool))
    if jobs:
        with ThreadPoolExecutor(max_workers=256) as pool, \
                ThreadPoolExecutor(max_workers=len(jobs)) as drivers:
            for f in [drivers.submit(job, pool) for job in jobs]:
                f.result()
    library()
    for header in headers:
        lane_library(header)
    return time.perf_counter() - t0


def function(name: str, argtypes, header=None) -> ctypes._CFuncPtr:
    """A kernel launcher of the library (of ``header``'s lane library when
    given); raises if it was not instantiated."""
    lib = library() if header is None else lane_library(Path(header).resolve())
    try:
        fn = getattr(lib, name)
    except AttributeError as e:
        raise ValueError(f"no CUDA kernel {name!r} in the kernel library") from e
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


ATTRIBUTES = ("registers", "spill_bytes", "static_smem_bytes", "dynamic_smem_bytes",
              "blocks_per_sm", "threads")


def kernel_attributes(name: str, header=None) -> dict:
    """What ``cudaFuncGetAttributes`` and the occupancy calculator report for
    the kernel of launcher ``name`` (with its ``_f32``/``_f64`` suffix) at the
    block size and dynamic shared memory it launches with: registers per
    thread, local (spill) bytes per thread, static and dynamic shared bytes
    per block, resident blocks per SM, threads per block; of ``header``'s lane
    library when given."""
    lib = library() if header is None else lane_library(Path(header).resolve())
    lib.cddp_kernel_attributes.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.cddp_kernel_attributes.restype = ctypes.c_int
    out = (ctypes.c_int * len(ATTRIBUTES))()
    check(lib.cddp_kernel_attributes(name.encode(), out), name, lib)
    return dict(zip(ATTRIBUTES, out))


def check(err: int, name: str, lib=None) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it); ``lib`` the library that
    launched it (the main one when None)."""
    if err != 0:
        msg = (lib or library()).cddp_cuda_error_string(err).decode()
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
