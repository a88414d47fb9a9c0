"""The kernel library's build inputs (CPU): every header a CUDA source
includes enters the build digest, every source is compiled, every
launcher the wrappers and ``chip_smoke.py`` name is exported and registered
for its attributes by a source, and every kernel is launched and registered
with the block size its ``__launch_bounds__`` names (a mismatch would fail
only at launch, on the card)."""

import re

import pytest

import chip_smoke
from cddp_tpu_torch.ops.kernels import build

SOURCES = sorted(p.name for p in build.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def expanded(text):
    """``text`` with each launcher macro invocation (``CDDP_X(a, b)`` at the
    start of a line) replaced by the macro's body, arguments substituted and
    ``##`` pasted, as the preprocessor would."""
    macros = {}
    for m in re.finditer(r"#define (CDDP_\w+)\(([^)]*)\)((?:[^\n]*\\\n)*[^\n]*)", text):
        macros[m.group(1)] = ([p.strip() for p in m.group(2).split(",")],
                              m.group(3).replace("\\\n", "\n"))
    out = [text]
    for m in re.finditer(r"^(CDDP_\w+)\(([^)]*)\)\s*$", text, re.M):
        if m.group(1) not in macros:
            continue
        params, body = macros[m.group(1)]
        args = [a.strip() for a in m.group(2).split(",")]
        for p, a in zip(params, args):
            body = re.sub(rf"\b{p}\b", a, body)
        out.append(re.sub(r"\s*##\s*", "", body))
    return "\n".join(out)


def source_text(source):
    """A source's text after the text of each header it includes that
    declares a kernel: a kernel template and its launcher macro live in a
    header, and each source that includes it instantiates some of them."""
    text = (build.CSRC / source).read_text()
    heads = [(build.CSRC / h).read_text()
             for h in re.findall(r'^#include "([^"]+)"', text, re.M)]
    return "\n".join([h for h in heads if "__global__" in h] + [text])


def launchers_of(source):
    """(exported, registered): the launcher names, without their type
    suffix, that ``source`` exports and registers for its attributes."""
    text = expanded(source_text(source))
    return (set(re.findall(r"CDDP_EXPORT\((\w+)\)", text)),
            set(re.findall(r"CDDP_REGISTER\((\w+),", text)))


@pytest.mark.parametrize("source", SOURCES)
def test_includes_are_in_the_digest(source):
    """A header missing from build.HEADERS would leave a stale library in
    place after an edit to it."""
    text = (build.CSRC / source).read_text()
    for header in re.findall(r'^#include "([^"]+)"', text, re.M):
        assert header in build.HEADERS, f"{source} includes {header}, not in build.HEADERS"
    if source.endswith(".cuh"):
        assert source in build.HEADERS


def test_every_source_is_compiled():
    assert sorted(build.KERNEL_SOURCES) == [s for s in SOURCES if s.endswith(".cu")]


@pytest.mark.parametrize("kernel", sorted(chip_smoke.launchers()))
def test_launchers_are_exported_and_registered(kernel):
    """Every launcher of the kernel (the wrappers build the same names) is
    instantiated by its source, and every launcher the source exports is
    registered, so that ``build.kernel_attributes`` finds it."""
    exported, registered = launchers_of(f"{kernel}.cu")
    assert exported == registered
    assert set(chip_smoke.launchers()[kernel]) == exported


# The launchers each source with more than one instantiates, without the
# type suffix: kernel 7 for the box stacks (m = 4, 6, 10) and for a control
# box with a keep-out ball, the ball's row first or last (m5_ball0,
# m5_ball4); kernel 6 for m = 4, 5 (the ball stack), 6 and 10; kernels 2, 3,
# 5, 8 and 9 in the goal form and the tracking form (suffix _track), kernel
# 7's tracking form for the box stacks and m5_ball0; kernel 7's terminal
# variants on the control box in their own translation unit: one or two
# terminal inequality rows (ti1, ti2), the terminal equality (te3), both.
# Beside the unicycle: the pendulum (kernels 1-3 at (2, 1), kernels 4, 5, 7,
# 8 and 9 on its control box m = 2, kernel 6 at (2, 1, 2)), the cart-pole
# (kernels 1-4 at (4, 1)), HCW (kernel 4, kernel 5 on its control box m
# = 6 in both forms, kernel 7's rendezvous m6_te6), the car (kernels 1 and 6
# at (4, 2), 2, 4 and 5), the forklift (kernel 4), the quadrotor (kernels 1
# and 6 at (13, 4), 2, 4 and 5 on its rotor box m = 8 in both forms),
# QuadrotorRate (kernels 1 and 6 at (10, 4), 2, 4 and 5 goal form m = 8) and
# the attitude trio (kernels 1 and 6 at (6, 3) and (7, 3), 2, 4, 5 and 9 on
# the torque box m = 6, goal form, kernel 3 but on the MRP model and kernel
# 7 but on the Euler model; kernels 6 and 7 in translation units of their
# own) and the other spacecraft models (kernels 1 and 6 at (8, 3), (10, 3)
# and (6, 2), SpacecraftTwobody at the trio's (6, 3); kernels 2 and 4;
# kernel 5 on the thrust box m = 6, the lander's m = 4; kernel 3 on the
# nonlinear model, 7 on the nonlinear and two-body models (m6), 9 on the
# fuel model (m6); goal form; kernels 3, 6, 7 and 9 in translation units of
# their own) and the small models (kernel 1 at (3, 1), DubinsCar's, beside
# the shapes the others share; kernel 6 at (3, 1, 2) and (4, 1, 2); kernels
# 2 and 4; kernels 5, 7, 8 and 9 on the control box, the bicycle's m = 4,
# the others' m = 2, kernel 8 not on the acrobot; kernel 3; goal form;
# kernels 3, 6, 7, 8 and 9 in translation units of their own).
ATTITUDE = ("euler_attitude", "quaternion_attitude", "mrp_attitude")
SPACECRAFT = ("sc_linear_fuel", "sc_nonlinear", "sc_landing2d", "sc_twobody")
SC_BOX = ("sc_linear_fuel_m6", "sc_nonlinear_m6", "sc_landing2d_m4", "sc_twobody_m6")
SMALL = ("bicycle", "dubins_car", "dreyfus_rocket", "acrobot")
SMALL_BOX = ("bicycle_m4", "dubins_car_m2", "dreyfus_rocket_m2", "acrobot_m2")
INSTANTIATIONS = {
    "ipddp_solve.cu": {f"cddp_ipddp_solve_unicycle_{v}"
                       for v in ("m4", "m6", "m10", "m5_ball0", "m5_ball4", "m4_track",
                                 "m6_track", "m10_track", "m5_ball0_track")}
    | {"cddp_ipddp_solve_pendulum_m2", "cddp_ipddp_solve_pendulum_m2_track"},
    "ipddp_solve_terminal.cu": {f"cddp_ipddp_solve_unicycle_{v}"
                                for v in ("m4_ti1", "m4_ti2", "m4_te3", "m4_te3_ti1")}
    | {"cddp_ipddp_solve_hcw_m6_te6"},
    "ipddp_solve_attitude.cu": {f"cddp_ipddp_solve_{m}_m6" for m in ATTITUDE[1:]},
    "ipddp_solve_spacecraft.cu": {"cddp_ipddp_solve_sc_nonlinear_m6"},
    "ipddp_solve_small.cu": {f"cddp_ipddp_solve_{v}" for v in SMALL_BOX},
    "ipddp_backward.cu": {f"cddp_ipddp_backward_3x2x{m}" for m in (4, 5, 6, 10)}
    | {"cddp_ipddp_backward_2x1x2", "cddp_ipddp_backward_4x2x4",
       "cddp_ipddp_backward_13x4x8", "cddp_ipddp_backward_10x4x8"},
    "ipddp_backward_attitude.cu": {"cddp_ipddp_backward_6x3x6", "cddp_ipddp_backward_7x3x6"},
    "ipddp_backward_spacecraft.cu": {"cddp_ipddp_backward_8x3x6", "cddp_ipddp_backward_10x3x6",
                                     "cddp_ipddp_backward_6x2x4"},
    "ipddp_backward_small.cu": {"cddp_ipddp_backward_3x1x2", "cddp_ipddp_backward_4x1x2"},
    "ip_forward.cu": {f"cddp_ip_forward_{v}{t}"
                      for v in ("unicycle_m4", "unicycle_m6", "unicycle_m10", "pendulum_m2",
                                "hcw_m6", "quadrotor_m8")
                      for t in ("", "_track")}
    | {"cddp_ip_forward_car_m4", "cddp_ip_forward_quadrotor_rate_m8"}
    | {f"cddp_ip_forward_{m}_m6" for m in ATTITUDE}
    | {f"cddp_ip_forward_{v}" for v in SC_BOX + SMALL_BOX},
    "forward_rollout.cu": {f"cddp_forward_rollout_{m}{t}" for m in ("unicycle", "pendulum",
                                                                     "cartpole")
                           for t in ("", "_track")}
    | {f"cddp_forward_rollout_{m}" for m in ("car", "quadrotor", "quadrotor_rate") + ATTITUDE
       + SPACECRAFT + SMALL},
    "clddp_solve.cu": {f"cddp_clddp_solve_{m}{t}" for m in ("unicycle", "pendulum", "cartpole")
                       for t in ("", "_track")} | {f"cddp_clddp_solve_{m}" for m in ATTITUDE[:2]},
    "clddp_solve_spacecraft.cu": {"cddp_clddp_solve_sc_nonlinear"},
    "clddp_solve_small.cu": {f"cddp_clddp_solve_{m}" for m in SMALL},
    "logddp_solve.cu": {f"cddp_logddp_solve_{v}{t}"
                        for v in ("unicycle_m4", "unicycle_m6", "unicycle_m10", "pendulum_m2")
                        for t in ("", "_track")} | {f"cddp_logddp_solve_{m}_m6" for m in ATTITUDE},
    "logddp_solve_spacecraft.cu": {"cddp_logddp_solve_sc_linear_fuel_m6"},
    "logddp_solve_small.cu": {f"cddp_logddp_solve_{v}" for v in SMALL_BOX},
    "msipddp_solve.cu": {f"cddp_msipddp_solve_{v}{t}"
                         for v in ("unicycle_m4", "unicycle_m6", "unicycle_m10", "pendulum_m2")
                         for t in ("", "_track")},
    "msipddp_solve_small.cu": {f"cddp_msipddp_solve_{v}" for v in SMALL_BOX[:3]},
    "riccati_backward.cu": {f"cddp_riccati_backward_{s}"
                            for s in ("3x2", "2x1", "4x1", "4x2", "13x4", "10x4", "6x3", "7x3",
                                      "8x3", "10x3", "6x2", "3x1")},
    "open_loop_rollout.cu": {f"cddp_open_loop_rollout_{m}"
                             for m in ("unicycle", "pendulum", "cartpole", "hcw", "car",
                                       "forklift", "quadrotor", "quadrotor_rate") + ATTITUDE
                             + SPACECRAFT + SMALL},
}


@pytest.mark.parametrize("source", sorted(INSTANTIATIONS))
def test_instantiations(source):
    exported, registered = launchers_of(source)
    assert exported == registered == INSTANTIATIONS[source]


def test_ball_variants_are_the_layouts_the_wrapper_names():
    """Kernel 7's ball launchers are the ``BALL_LAYOUTS`` the wrapper picks
    (``mega_ipddp.solve_variant``), its tracking launchers the
    ``TRACK_LAYOUTS``, and kernel 6's shapes its ``KERNEL_SHAPES``."""
    from cddp_tpu_torch.ops.kernels import ipddp_riccati, mega_ipddp

    balls = {f"cddp_ipddp_solve_unicycle_m{m}_ball{row}"
             for m, row in mega_ipddp.BALL_LAYOUTS["unicycle"]}
    assert balls <= launchers_of("ipddp_solve.cu")[0]
    assert {f"cddp_ipddp_solve_{model}_{v}_track"
            for model, layouts in mega_ipddp.TRACK_LAYOUTS.items()
            for v in layouts} <= launchers_of("ipddp_solve.cu")[0]
    assert {f"cddp_ipddp_solve_{model}_{layout}" + (f"_te{p}" if p else "")
            + (f"_ti{mT}" if mT else "")
            for model, layouts in mega_ipddp.TERMINAL_LAYOUTS.items()
            for layout, shapes in layouts.items()
            for mT, p in shapes} == launchers_of("ipddp_solve_terminal.cu")[0]
    assert (launchers_of("ipddp_backward.cu")[0] | launchers_of("ipddp_backward_attitude.cu")[0]
            | launchers_of("ipddp_backward_spacecraft.cu")[0]
            | launchers_of("ipddp_backward_small.cu")[0]) \
        == {f"cddp_ipddp_backward_{nx}x{nu}x{m}" for nx, nu, m in ipddp_riccati.KERNEL_SHAPES}


def call_args(text, start):
    """The top-level comma-separated arguments of the call whose opening
    parenthesis is at ``text[start]``."""
    depth, args, cur = 0, [], []
    for ch in text[start:]:
        if ch in "(<":
            depth += 1
            if depth == 1 and ch == "(":
                continue
        elif ch in ")>":
            depth -= 1
            if depth == 0:
                args.append("".join(cur).strip())
                return args
        if ch == "," and depth == 1:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    raise ValueError("unbalanced call")


def launch_shapes(text):
    """{kernel: (block size of its __launch_bounds__, whether it declares
    extern __shared__, [(threads, dynamic smem) of each <<<...>>> launch],
    [(threads, smem) of each CDDP_REGISTER])} of a source's text, the
    constants without their ``cddp::`` qualifier."""
    text = expanded(text)
    plain = lambda a: re.sub(r"\bcddp::", "", a)  # noqa: E731
    out = {}
    for m in re.finditer(r"__global__ void __launch_bounds__\((.*?)\)\s*(\w+)\(", text):
        body = text[m.end():text.index("\n}\n", m.end())]
        out[m.group(2)] = (plain(m.group(1).split(",")[0].strip()),
                           "extern __shared__" in body, [], [])
    for m in re.finditer(r"(\w+)<[^<>;]*><<<([^>]*)>>>", text):
        _, threads, smem = [a.strip() for a in m.group(2).split(",")][:3]
        out[m.group(1)][2].append((plain(threads), smem))
    for m in re.finditer(r"CDDP_REGISTER\(", text):
        args = call_args(text, m.end() - 1)
        if len(args) != 4 or "##" in args[0]:
            continue  # a macro's definition, not an invocation
        kernel = re.search(r"(\w+)<", plain(args[1])).group(1)
        out[kernel][3].append((plain(args[2]), plain(args[3])))
    return out


def launch_shape_faults(shapes):
    """What is wrong with a source's launch shapes: a kernel never launched
    or registered, a block size other than its __launch_bounds__, no
    dynamic shared memory for a kernel that declares extern __shared__."""
    faults = []
    for kernel, (bound, shared, launches, registered) in shapes.items():
        if not launches or not registered:
            faults.append(f"{kernel} is never launched or never registered")
        for threads, smem in launches + registered:
            if threads != bound:
                faults.append(f"{kernel}: {threads} threads against __launch_bounds__({bound})")
            if shared and smem == "0":
                faults.append(f"{kernel} declares extern __shared__ but passes no bytes")
    return faults


@pytest.mark.parametrize("source", [s for s in SOURCES if s.endswith(".cu")])
def test_launch_shape_matches_launch_bounds(source):
    """Each kernel is launched and registered with the block-size constant
    its ``__launch_bounds__`` names (more threads than the bound is a launch
    the card refuses), and a kernel that declares ``extern __shared__``
    launches and registers a nonzero dynamic shared-memory size."""
    shapes = launch_shapes(source_text(source))
    assert shapes, f"{source} declares no kernel"
    assert launch_shape_faults(shapes) == []


def test_launch_shapes_see_a_mismatch():
    text = source_text("logddp_solve.cu")
    shapes = launch_shapes(text)["logddp_solve_kernel"]
    assert shapes[0] == "kThreads" and shapes[1]
    # One launch; m = 4, 6, 10 on the unicycle and 2 on the pendulum, in the
    # goal and the tracking form, and 6 on the attitude trio, goal form.
    assert len(shapes[2]) == 1 and len(shapes[3]) == 11
    for old, new in (("kThreads, smem, stream>>>", "kSolveThreads, smem, stream>>>"),
                     ("kThreads, smem, stream>>>", "kThreads, 0, stream>>>"),
                     ("cddp::kThreads,      \\", "cddp::kSolveThreads, \\")):
        assert old in text
        assert launch_shape_faults(launch_shapes(text.replace(old, new))), new


def test_macro_expansion_pastes_tokens():
    text = ("#define CDDP_K(MODEL, M) \\\n  int CDDP_EXPORT(cddp_k_##MODEL##_m##M)(); \\\n"
            "  CDDP_REGISTER(cddp_k_##MODEL##_m##M, (f<M>), 1, 0)\n\nCDDP_K(unicycle, 4)\n")
    body = expanded(text)
    assert "CDDP_EXPORT(cddp_k_unicycle_m4)" in body
    assert "CDDP_REGISTER(cddp_k_unicycle_m4, (f<4>), 1, 0)" in body
