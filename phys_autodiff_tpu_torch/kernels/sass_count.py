"""Registers, spills and the instructions of each loop of chosen kernels,
from the built library, on the machine with the card.

    python -m phys_autodiff_tpu_torch.kernels.sass_count [--kernel PATTERN ...]

Builds the library (kernels/_build), prints the ptxas report (nvcc -Xptxas
-v: registers, spill stores / loads) of every entry function whose mangled
name holds one of the patterns (default: K2's bf16 kernels and K4's fields
pass, k_mlp_fields_bf16 and k_bwd_fields), then reads `cuobjdump -sass` of
the library and, for each such function, counts the opcodes of every loop:
the instructions between a backward branch and its target. A loop of the
forward's k-steps (`#pragma unroll 1` over the 16-hidden-unit k-steps, the
rows, slices and cells unrolled inside) is one k-step of a group; its HMMA
count names the group (rows x slices x products a k-step). Per loop it
prints the total and the counts of F2FP (float32 -> bf16x2), FADD, FMNMX,
HMNMX2, PRMT, LDG, LDGSTS (cp.async), LDS, HMMA, STG, LDL and STL
(spills). The SASS is the
card compiler's own, so this runs only where nvcc and cuobjdump are.
Nothing here runs at import time.
"""

from __future__ import annotations

import argparse
import re
import subprocess
from collections import Counter

FAMILIES = ("F2FP", "FADD", "FMNMX", "HMNMX2", "PRMT", "LDG", "LDGSTS", "LDS", "HMMA", "STG", "LDL", "STL")
_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]*)?\s*([^;]*);")


def _label(name: str, pattern: str) -> str:
    """'k_name<template arguments>' of a mangled entry name, read from where
    `pattern` begins; the mangled name where it is not of that form."""
    tail = name[name.index(pattern):]
    short = re.search(r"k_\w+?(?=I|Ev|E)", tail)
    if not short:
        return name
    m_args = re.match(r"I((?:L[ib]\d+E)+)E", tail[short.end():])
    targs = re.findall(r"L[ib](\d+)E", m_args.group(1)) if m_args else []
    return short.group(0) + (f"<{', '.join(targs)}>" if targs else "")


def ptxas_lines(log_text: str, patterns) -> list[str]:
    """'k_name<template arguments>: N registers, S / L bytes spill stores /
    loads' for each entry function of an nvcc -Xptxas -v log whose
    (mangled) name holds one of the patterns ("" matches every one)."""
    out, name, spill = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            hit = next((p for p in patterns if p in name), None)
            if hit is not None:
                out.append(f"{_label(name, hit)}: {m.group(1)} registers, "
                           f"{spill[0]} / {spill[1]} bytes spill stores / loads")
            name = None
    return out


def build_log_lines(patterns) -> list[str]:
    """ptxas_lines of the report that kernels/_build keeps beside the built
    library (none before the library is built)."""
    from phys_autodiff_tpu_torch.kernels import _build

    log = _build.BUILD_DIR / f"build_{_build._source_hash()}.log"
    return ptxas_lines(log.read_text() if log.exists() else "", patterns)


def functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """{mangled name: [(address, opcode, operands), ...]} of a cuobjdump
    -sass listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), (m.group(3) or "") + " " + m.group(4)))
    return out


def loops(insns) -> list[tuple[int, int, Counter]]:
    """(start, end, opcode counts) of each loop: a BRA whose target lies
    before it, the body from the target to the branch."""
    out = []
    for addr, op, rest in insns:
        if op != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target < addr:
            out.append((target, addr, Counter(o for a, o, _ in insns if target <= a <= addr)))
    return out


def report(sass: str, patterns) -> list[str]:
    """The counts of each matched function and of each of its loops."""
    lines = []
    for name, insns in functions(sass).items():
        if not any(p in name for p in patterns):
            continue
        total = Counter(o for _, o, _ in insns)
        lines.append(f"{name}: {len(insns)} instructions; " +
                     ", ".join(f"{f} {total.get(f, 0)}" for f in FAMILIES))
        for start, end, c in sorted(loops(insns)):
            lines.append(f"  loop {start:#x}-{end:#x}: {sum(c.values())} instructions, " +
                         ", ".join(f"{f} {c.get(f, 0)}" for f in FAMILIES))
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", nargs="+", default=["k_mlp_fields_bf16", "k_bwd_fields"],
                    help="substrings of the mangled kernel names")
    args = ap.parse_args(argv)
    from phys_autodiff_tpu_torch.kernels import _build

    path = _build.build()
    for line in build_log_lines(args.kernel):
        print(f"sass_count ptxas {line}")
    cuobjdump = str(_build.find_nvcc()).replace("nvcc", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    for line in report(sass, args.kernel):
        print(f"sass_count {line}")


if __name__ == "__main__":
    main()
