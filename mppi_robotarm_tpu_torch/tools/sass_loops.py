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
plus each scan's body W / rows times. A scan with no loop of its own (a
compiled width unrolled whole) sits in the body and counts once a step.
The Payne-Hanek set-up outside its loops is left in, so that figure is an
upper bound of the fast path.

With ``--groups`` it reads a listing with line information instead
(``nvdisasm -gi`` of a cubin built with ``-lineinfo``) and attributes each
instruction of the loop to a source group (:data:`GROUPS`): the window
scan, ``sincosf``, Philox and Box-Muller, the divide of the arm step, the
shared loads and the local memory (each local access also by the group
of its source line: on ``sincosf``'s line it is the Payne-Hanek array,
elsewhere a register spill), static and per horizon step.

With ``--digest`` it prints the SHA-256 of each kernel's instructions
instead, so that two builds (two trees, each with its own library) show
whether a kernel compiled to the same code.

Run on a machine with the CUDA toolkit, after the library is built (any
kernel call builds it):

    python -m mppi_robotarm_tpu_torch.tools.sass_loops [sass.txt]
    python -m mppi_robotarm_tpu_torch.tools.sass_loops --groups [listing ...]
    python -m mppi_robotarm_tpu_torch.tools.sass_loops --digest [sass.txt]

Without a file it runs ``cuobjdump -sass`` on
``build/torch_kernels/libmppi_kernels.so``; ``--groups`` without a file
compiles each kernel source again with ``-lineinfo`` (the library's flags
otherwise) into ``build/torch_kernels/lineinfo/`` and disassembles it.
"""

from __future__ import annotations

import hashlib
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

KERNELS = ("sim_kernel", "fleet_kernel", "solve_tile_kernel")
PHILOX_MUL = ("0xd2511f53", "-0x2daee0ad")   # the same 32 bits, as printed
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+0x([0-9a-f]+)")
CLASSES = (("MUFU", "special function"), ("LDS", "shared load"),
           ("STS", "shared store"), ("LDG", "global load"),
           ("STG", "global store"), ("LDL", "local load"),
           ("STL", "local store"), ("BRA", "branch"),
           ("SHFL", "shuffle"), ("BAR", "barrier"))


_TEXT = re.compile(r"^\.text\.(\S+):$")
_LABEL = re.compile(r"^(\.L_x_\d+):")
_LOC = re.compile(r'//## File "([^"]+)", line (\d+)')
_LABEL_REF = re.compile(r"`\((\.L_x_\d+)\)")
# (group, regex of the names of the functions whose lines it takes, regex
# of the lines it takes); an instruction takes the group of the innermost
# source location that has one.  The window scan takes every function
# named for the window or a scan, so a schedule of its own (a loop over W,
# a compiled width) counts there whatever its name.
GROUPS = (
    ("window scan", re.compile(r"window|scan|^row_cost$|^tracking_cost$"),
     None),
    ("sincosf", None, re.compile(r"\bsincosf\s*\(")),
    ("Philox and Box-Muller", re.compile(
        r"^(philox4x32_10|uniform_from_bits|box_muller|philox_eps)$"), None),
    ("divide", None, re.compile(r"/\s*det\b")),
)
OPCODE_GROUPS = (("LDS", "shared load"), ("LDL", "local memory"),
                 ("STL", "local memory"))
GROUP_ORDER = (*(g for g, _, _ in GROUPS), "shared load", "local memory",
               "other")


def parse(sass: str):
    """({name: [(address, text), ...]}, {name: {address: [(file, line),
    ...]}}) of a ``cuobjdump -sass`` or ``nvdisasm`` listing.  The second
    holds each instruction's source locations, innermost first, where the
    listing has line information (``nvdisasm -gi``); branch targets given
    as labels are rewritten to addresses."""
    out, locs, name = {}, {}, None
    labels, pending, chain, fresh = {}, [], [], True
    for line in sass.splitlines():
        m = _TEXT.match(line)
        if "Function :" in line or m:
            name = m.group(1) if m else line.split("Function :")[1].strip()
            out[name], locs[name] = [], {}
            continue
        if not name:
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        loc = _LOC.search(line)
        if loc:
            if fresh:
                chain, fresh = [], False
            chain.append((loc.group(1), int(loc.group(2))))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            out[name].append((addr, m.group(2)))
            locs[name][addr] = list(chain)
            labels.update((p, addr) for p in pending)
            pending, fresh = [], True
    for insns in out.values():
        insns[:] = [(a, _LABEL_REF.sub(lambda r: f"{labels[r.group(1)]:#x}",
                                       t) if "`(" in t else t)
                    for a, t in insns]
    return out, locs


def functions(sass: str):
    """{mangled name: [(address, text), ...]} of a cuobjdump -sass dump."""
    return parse(sass)[0]


def digests(sass: str):
    """{mangled name: SHA-256 of its instructions} of a cuobjdump -sass
    dump; the addresses in it are the function's own, so one code gives
    one digest wherever the linker put it."""
    return {name: hashlib.sha256("\n".join(
        f"{a:x} {t}" for a, t in insns).encode()).hexdigest()
        for name, insns in functions(sass).items()}


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


def _nested(insns, lp, W):
    """[(start, end, kind, rows)] of the loops nested in loop ``lp``."""
    body = [(a, t) for a, t in insns if lp[0] <= a <= lp[1]]
    out = []
    for a, b in sorted({se for se in loops(body) if se != lp}):
        sub = [t for x, t in body if a <= x <= b]
        if any("LDS" in t for t in sub):
            out.append((a, b, "window scan", _rows(sub)))
        elif any("LDG" in t or "STL" in t for t in sub):
            out.append((a, b, "Payne-Hanek reduction", 0))
        else:
            out.append((a, b, "other", 1))
    return out


def _weight(addr, nested, W) -> int:
    """Times one horizon step at a window of W rows issues the instruction
    at ``addr``: W / rows in a scan, 0 in a Payne-Hanek loop, else 1."""
    for a, b, kind, rows in nested:
        if a <= addr <= b and kind != "other":
            return -(-W // rows) if rows else 0
    return 1


def describe(name, insns, W=30):
    lp = rollout_loop(insns)
    if lp is None:
        return [f"{name}: no loop holds the Philox rounds"]
    s, e = lp
    body = [(a, t) for a, t in insns if s <= a <= e]
    lines = [f"{name}: rollout loop {s:#x}-{e:#x}, {len(body)} instructions "
             f"(static), {sum(_philox(t) for _, t in body)} Philox "
             f"multiplies"]
    nested = _nested(insns, lp, W)
    for a, b, kind, rows in nested:
        n = sum(a <= x <= b for x, _ in body)
        what = (f"window scan, {rows} rows a pass" if kind == "window scan"
                else kind)
        lines.append(f"  nested loop {a:#x}-{b:#x}: {n} instructions "
                     f"({what})")
    lines.append("  by class: " + ", ".join(
        f"{c} {n}" for c, n in loop_classes(insns).most_common()))
    per_step = sum(_weight(a, nested, W) for a, _ in body)
    lines.append(f"  one horizon step at W={W} issues at most {per_step} "
                 f"instructions on the fast path")
    return lines


def loop_classes(insns) -> Counter:
    """Instructions of the rollout loop by opcode class (:data:`CLASSES`,
    else "other"); empty without a rollout loop."""
    lp = rollout_loop(insns)
    out = Counter()
    for a, t in insns:
        if lp and lp[0] <= a <= lp[1]:
            op = _opcode(t)
            out[next((c for p, c in CLASSES if op.startswith(p)),
                     "other")] += 1
    return out


def library_sass() -> str:
    """``cuobjdump -sass`` of the built library."""
    from ..ops._build import BUILD_DIR, LIB_NAME

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(BUILD_DIR / LIB_NAME)],
                          capture_output=True, text=True, check=True).stdout


def source_functions(path) -> list:
    """[(name, first line, last line)] of the functions defined in a C++
    source: a definition starts at a line in column 0 that names a function
    before its first parenthesis and ends at the next line that starts
    with ``}``."""
    lines = Path(path).read_text().splitlines()
    skip = ("//", "#", "template", "struct", "namespace", "extern", "using",
            "constexpr", "static", "}", "{")
    out = []
    for i, text in enumerate(lines):
        if not text or text[0].isspace() or text.startswith(skip):
            continue
        m = re.match(r"[^(]*?\b(\w+)\s*\(", text)
        if not m:
            continue
        end = next((j for j in range(i, len(lines))
                    if lines[j].startswith("}")), len(lines) - 1)
        out.append((m.group(1), i + 1, end + 1))
    return out


class SourceGroups:
    """The group (:data:`GROUPS`) of a source location, read from the
    sources the listing names (or, where that path does not exist here,
    the file of the same name in ``src``)."""

    def __init__(self, src=None):
        self.src = Path(src) if src else Path(__file__).resolve().parent.parent / "csrc"
        self._files = {}

    def _file(self, path):
        if path not in self._files:
            p = Path(path)
            if not p.exists():
                p = self.src / p.name
            self._files[path] = ((p.read_text().splitlines(),
                                  source_functions(p)) if p.exists()
                                 else ([], []))
        return self._files[path]

    def group(self, path, line):
        text, funcs = self._file(path)
        where = {n for n, a, b in funcs if a <= line <= b}
        code = text[line - 1] if 0 < line <= len(text) else ""
        for group, names, regex in GROUPS:
            if (names and any(names.search(n) for n in where)) or (
                    regex and regex.search(code)):
                return group
        return None

    def of(self, chain):
        """The group of an instruction from its locations, innermost
        first; None when no location has one."""
        for path, line in chain:
            g = self.group(path, line)
            if g:
                return g
        return None


def groups(insns, locs, W=30, sources=None):
    """{group: [static count, count per horizon step]} of the rollout
    loop's instructions, plus "local memory by source": {group: count} of
    its local loads and stores.  Shared loads and local memory go by
    opcode, the rest by source location.  None without a rollout loop."""
    lp = rollout_loop(insns)
    if lp is None:
        return None
    sources = sources or SourceGroups()
    nested = _nested(insns, lp, W)
    out = {g: [0, 0] for g in GROUP_ORDER}
    local = Counter()
    for a, t in insns:
        if not lp[0] <= a <= lp[1]:
            continue
        op = _opcode(t)
        src = sources.of(locs.get(a, [])) or "other"
        g = next((c for p, c in OPCODE_GROUPS if op.startswith(p)), src)
        if g == "local memory":
            local[src] += 1
        out[g][0] += 1
        out[g][1] += _weight(a, nested, W)
    out["local memory by source"] = dict(local)
    return out


def describe_groups(name, insns, locs, W=30, sources=None):
    got = groups(insns, locs, W, sources)
    if got is None:
        return [f"{name}: no loop holds the Philox rounds"]
    local = got.pop("local memory by source")
    head = ", ".join(f"{g} {n} / {k}" for g, (n, k) in got.items())
    line = (f"{name}: rollout loop by source group (static / one horizon "
            f"step at W={W}): {head}")
    if local:
        line += "; local memory on the lines of " + ", ".join(
            f"{g} {n}" for g, n in sorted(local.items()))
    return [line]


def template_args(mangled: str) -> str:
    """The integer template arguments of a kernel's mangled name, as
    ``<2,2>``; "" for a plain function."""
    m = re.search(r"kernelI((?:L[ib]\d+E)+)E", mangled)
    return ("<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(1))) + ">"
            if m else "")


def lineinfo_listings(sources, out_dir: Path) -> list:
    """``nvdisasm -gi`` of each kernel source compiled with the library's
    flags and ``-lineinfo`` (one ``nvcc`` a source, all at once)."""
    from ..ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    cubins = [out_dir / (src.stem + ".cubin") for src in sources]
    _build._run_all([[_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                      "--fmad=false", "-lineinfo", "-cubin", "-I",
                      str(src.parent), "-o", str(cubin), str(src)]
                     for src, cubin in zip(sources, cubins)])
    tool = (shutil.which("nvdisasm") or "/usr/local/cuda/bin/nvdisasm")
    return [subprocess.run([tool, "-gi", "-c", str(cubin)],
                           capture_output=True, text=True, check=True).stdout
            for cubin in cubins]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    by_group = "--groups" in argv
    by_digest = "--digest" in argv
    files = [a for a in argv if a not in ("--groups", "--digest")]
    listings = []
    for path in files:
        with open(path) as f:
            listings.append(f.read())
    if not files and by_group:
        from ..ops._build import BUILD_DIR, _CSRC

        listings = lineinfo_listings(
            [_CSRC / f"{k}.cu" for k in ("sim_kernel", "fleet_kernel",
                                          "solve_kernel")],
            BUILD_DIR / "lineinfo")
    elif not files:
        listings = [library_sass()]
    if by_digest:
        got = {k: v for sass in listings for k, v in digests(sass).items()}
        for mangled, h in sorted(got.items()):
            print(f"{mangled} sha256 {h}")
        return 0 if got else 1
    found = 0
    for sass in listings:
        funcs, locs = parse(sass)
        for mangled, insns in funcs.items():
            kernel = next((k for k in KERNELS if k in mangled), None)
            if kernel:
                found += 1
                kernel += template_args(mangled)
                print("\n".join(describe_groups(kernel, insns, locs[mangled])
                                if by_group else describe(kernel, insns)))
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
