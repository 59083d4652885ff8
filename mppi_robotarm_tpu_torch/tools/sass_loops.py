"""Count the instructions of the fused kernels' rollout loops in the built
library's SASS.

The rollout loop of ``sim_kernel`` and ``fleet_kernel`` is the loop over
the horizon step t; its body draws the Philox noise, so it is found as the
innermost loop (a backward branch and its target) that holds at least half
of the kernel's Philox multiplies (``0xd2511f53``; the compiler hoists the
rounds that do not depend on t out of it). For that loop the script prints
its static instruction count, the loops nested in it (the window scans,
whose body covers ``rows`` window rows and runs W / rows times a horizon
step, and the Payne-Hanek reductions of sinf/cosf, which only arguments
beyond 105615 take), a count by opcode class, and the instructions one
horizon step issues at a window of W rows: the body less its nested loops,
plus each scan's body W / rows times. The Payne-Hanek set-up outside its
loops is left in, so that figure is an upper bound of the fast path.

Run on a machine with the CUDA toolkit, after the library is built (any
kernel call builds it):

    python -m mppi_robotarm_tpu_torch.tools.sass_loops [sass.txt]

Without an argument it runs ``cuobjdump -sass`` on
``build/torch_kernels/libmppi_kernels.so``.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from collections import Counter

KERNELS = ("sim_kernel", "fleet_kernel")
PHILOX_MUL = ("0xd2511f53", "-0x2daee0ad")   # the same 32 bits, as printed
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")
CLASSES = (("MUFU", "special function"), ("LDS", "shared load"),
           ("STS", "shared store"), ("LDG", "global load"),
           ("STG", "global store"), ("LDL", "local load"),
           ("STL", "local store"), ("BRA", "branch"),
           ("SHFL", "shuffle"), ("BAR", "barrier"))


def functions(sass: str):
    """{mangled name: [(address, text), ...]} of a cuobjdump -sass dump."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name:
            m = _INSN.search(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def loops(insns):
    """(start, end) address ranges of the backward branches: a branch at
    ``end`` to ``start`` <= end."""
    out = []
    for addr, text in insns:
        m = _BRA.search(text)
        if m and m.group(1) and int(m.group(1), 16) <= addr:
            out.append((int(m.group(1), 16), addr))
    return out


def _philox(text: str) -> bool:
    return any(c in text for c in PHILOX_MUL)


def rollout_loop(insns):
    """The innermost loop that holds at least half of the Philox
    multiplies, or None."""
    total = sum(_philox(t) for _, t in insns)
    cands = [lp for lp in loops(insns)
             if 2 * sum(lp[0] <= a <= lp[1] and _philox(t)
                        for a, t in insns) >= max(total, 1)]
    return min(cands, key=lambda se: se[1] - se[0]) if cands else None


def _rows(sub) -> int:
    """Window rows a scan-loop body covers: one float compare (FSETP) of a
    row's distance against the best so far per row."""
    return max(1, sum(_opcode(t).startswith("FSETP") for t in sub))


def _opcode(text: str) -> str:
    return text.split()[1] if text.startswith("@") else text.split()[0]


def describe(name, insns, W=30):
    lp = rollout_loop(insns)
    if lp is None:
        return [f"{name}: no loop holds the Philox rounds"]
    s, e = lp
    body = [(a, t) for a, t in insns if s <= a <= e]
    inner = sorted({(a, b) for a, b in loops(body) if (a, b) != lp})
    lines = [f"{name}: rollout loop {s:#x}-{e:#x}, {len(body)} instructions "
             f"(static), {sum(_philox(t) for _, t in body)} Philox "
             f"multiplies"]
    per_step = len(body)
    for a, b in inner:
        sub = [t for x, t in body if a <= x <= b]
        per_step -= len(sub)
        if any("LDS" in t for t in sub):
            rows = _rows(sub)
            per_step += -(-W // rows) * len(sub)
            kind = f"window scan, {rows} rows a pass"
        elif any("LDG" in t or "STL" in t for t in sub):
            kind = "Payne-Hanek reduction"
        else:
            kind = "other"
        lines.append(f"  nested loop {a:#x}-{b:#x}: {len(sub)} instructions "
                     f"({kind})")
    ops = Counter(_opcode(t) for _, t in body)
    by_class = Counter()
    for op, n in ops.items():
        cls = next((c for p, c in CLASSES if op.startswith(p)), "other")
        by_class[cls] += n
    lines.append("  by class: " + ", ".join(f"{c} {n}" for c, n in
                                            by_class.most_common()))
    lines.append(f"  one horizon step at W={W} issues at most {per_step} "
                 f"instructions on the fast path")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        with open(argv[0]) as f:
            sass = f.read()
    else:
        from ..ops._build import BUILD_DIR, LIB_NAME

        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([tool, "-sass", str(BUILD_DIR / LIB_NAME)],
                              capture_output=True, text=True,
                              check=True).stdout
    found = 0
    for mangled, insns in functions(sass).items():
        kernel = next((k for k in KERNELS if k in mangled), None)
        if kernel:
            found += 1
            print("\n".join(describe(kernel, insns)))
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
