"""Instructions per slab test in K1's inner loops, by kind, from the SASS
of the built kernel library (cuobjdump -sass, CUDA toolkit).

Each loop is a backward branch and the instructions from its target up to
it. A slab test of one (ray, box) pair has exactly six float multiplies,
(lo - o) * (1/d) and (hi - o) * (1/d) per axis, and nothing else in the
loop multiplies, so a loop's FMUL count / 6 is the pairs it tests an
iteration. Kinds: FP32 (FADD, FMUL, FFMA: the FMA pipes, 128 lanes a clock
on an SM), FMNMX (min / max), compare / select (FSETP, FSEL, ISETP, SEL,
PLOP3), LDS (shared-memory loads), branch (BRA) and other. Beside each
loop: the clocks a pair costs an SM at the issue rate (one instruction a
clock on each of 4 schedulers: total / 128), on the FMA pipes (FP32 / 128)
and on the ALU pipe if min / max, compare and select issue there at 64
lanes a clock (NVIDIA's throughput table gives 64 for comparisons and
min / max of 32-bit integers; taken here for floats too, not measured).

    python -m cge_tpu_torch.tools.sass_count              # the built library
    python -m cge_tpu_torch.tools.sass_count --lib PATH --kernel NAME
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
from collections import Counter

KINDS = {"FADD": "FP32", "FMUL": "FP32", "FFMA": "FP32", "FMNMX": "FMNMX",
         "FSETP": "compare/select", "FSEL": "compare/select",
         "ISETP": "compare/select", "SEL": "compare/select",
         "PLOP3": "compare/select", "LDS": "LDS", "BRA": "branch"}
ORDER = ("FP32", "FMNMX", "compare/select", "LDS", "branch", "other")
ALU_KINDS = ("FMNMX", "compare/select")

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("cuobjdump not found")


def functions(sass: str) -> dict:
    """function name -> [(address, opcode, operands)] in address order."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def loops(insns) -> list:
    """(start, end, Counter of kinds, FMUL count) for each backward branch:
    the instructions from its target to the branch."""
    out = []
    for addr, op, args in insns:
        if op.split(".")[0] != "BRA":
            continue
        m = _TARGET.search(args)
        if not m or int(m.group(1), 16) > addr:
            continue
        start = int(m.group(1), 16)
        body = [o.split(".")[0] for a, o, _ in insns if start <= a <= addr]
        kinds = Counter(KINDS.get(o, "other") for o in body)
        out.append((start, addr, kinds, body.count("FMUL")))
    return out


def loop_line(name: str, start: int, end: int, kinds: Counter,
              fmul: int) -> str:
    total = sum(kinds.values())
    pairs = fmul / 6
    if not pairs:
        return (f"{name} loop {start:#06x}-{end:#06x}: {total} "
                f"instructions, no slab test")
    per = {k: kinds[k] / pairs for k in ORDER}
    alu = sum(per[k] for k in ALU_KINDS)
    body = ", ".join(f"{k} {per[k]:.2f}" for k in ORDER)
    return (f"{name} loop {start:#06x}-{end:#06x}: {total} instructions, "
            f"{pairs:g} pairs an iteration; per pair {body}, total "
            f"{total / pairs:.2f}; SM clocks a pair: issue "
            f"{total / pairs / 128:.4f}, FMA pipes {per['FP32'] / 128:.4f}, "
            f"ALU pipe {alu / 64:.4f}")


def report(sass: str, kernel: str = "block_entry_keys") -> list:
    """loop_line for every loop of every function whose name holds
    `kernel`, in the SASS text `sass`; [] if no function matches."""
    return [loop_line(name, *loop)
            for name, insns in functions(sass).items() if kernel in name
            for loop in loops(insns)]


def library_sass(lib: str) -> str:
    return subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", help="the kernel library (default: build it)")
    ap.add_argument("--kernel", default="block_entry_keys",
                    help="a substring of the kernels' mangled names")
    args = ap.parse_args(argv)
    lib = args.lib
    if lib is None:
        from cge_tpu_torch import _kernels
        lib = _kernels.library().path
    lines = report(library_sass(lib), args.kernel)
    if not lines:
        print(f"no loop of a function matching {args.kernel!r} in {lib}")
        return 1
    for ln in lines:
        print(ln, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
