"""The kernel library's build inputs (CPU): every header a CUDA source
includes enters the build digest, every source is compiled, and every
launcher the wrappers and ``chip_smoke.py`` name is exported and registered
for its attributes by a source."""

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


def launchers_of(source):
    """(exported, registered): the launcher names, without their type
    suffix, that ``source`` exports and registers for its attributes."""
    text = expanded((build.CSRC / source).read_text())
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


def test_macro_expansion_pastes_tokens():
    text = ("#define CDDP_K(MODEL, M) \\\n  int CDDP_EXPORT(cddp_k_##MODEL##_m##M)(); \\\n"
            "  CDDP_REGISTER(cddp_k_##MODEL##_m##M, (f<M>), 1, 0)\n\nCDDP_K(unicycle, 4)\n")
    body = expanded(text)
    assert "CDDP_EXPORT(cddp_k_unicycle_m4)" in body
    assert "CDDP_REGISTER(cddp_k_unicycle_m4, (f<4>), 1, 0)" in body
