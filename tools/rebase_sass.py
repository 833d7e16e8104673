#!/usr/bin/env python3
"""The rebase kernel's step, counted in SASS instructions.

    python3 tools/rebase_sass.py [--out build/rebase_sass.txt]

Needs the CUDA toolkit (nvcc and cuobjdump beside it), not a card.
Compiles fluidframework_tpu_torch/csrc/rebase_batch.cu for sm_90a with
``-DREBASE_STEP_PROBES`` to a cubin: each probe kernel
``rebase_step_probe<PK, CODE>`` holds one step of one instantiation of
the kernel's `rebase_step` over one staged base-op code, alone (its
state and the base op's terms loaded from memory, its state stored).
For each probe it counts the SASS instructions, less loads, stores,
parameter moves, the thread-id read and the exit, and less those of the
same instantiation's C_NOOP probe (which steps over nothing): what the
step issues over that code. Prints them
beside `chip_smoke.REBASE_OPS`, by base code and pending kind ("other"
is a kind outside 0..2 fixed at compile time; "generic" is the step
that reads the kind at run time, which the kernel runs in a warp of
mixed kinds, beside the sum of the three kinds' table entries), then
the per-step means at config 4's base mix. Then the same counts split
by the pipe that issues them on Hopper (`PIPES`): the ALU alone (the
comparisons, selects, min / max and logic), the ALU's adds and shifts
(which an IMAD on the FMA pipe can do too), the FMA pipe (IMAD and its
forms), and the rest; the ALU-alone counts sit beside
`chip_smoke.REBASE_ALU_OPS`. Writes the library kernel's resource usage
and SASS and the probes' SASS to --out.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODES = ("insert", "remove", "move", "other", "noop")  # C_* in the .cu
KINDS = {"0": 0, "1": 1, "2": 2, "3": -1, "n1": "generic"}  # PK tags
# Not step work: memory, parameters, the thread index, control.
SKIP = {"LDG", "STG", "LDC", "ULDC", "S2R", "S2UR", "EXIT", "BRA", "NOP",
        "UMOV"}
# The pipe each step opcode issues to on Hopper, where the integer ALU
# takes every integer instruction but IMAD and IMUL, which go to the FMA
# pipe: "alu" only the ALU can run; "add" the ALU runs, and an IMAD could
# in its place; "fma" the FMA pipe. Any other opcode is "rest".
PIPES = {
    **dict.fromkeys(("ISETP", "SEL", "FSEL", "IMNMX", "VIMNMX",
                     "VIADDMNMX", "LOP3", "PLOP3", "P2R", "R2P", "PRMT",
                     "FLO", "POPC", "BMSK", "SGXT", "IABS"), "alu"),
    **dict.fromkeys(("IADD3", "IADD", "LEA", "SHF"), "add"),
    **dict.fromkeys(("IMAD", "IMUL", "FFMA", "FMUL", "FADD"), "fma"),
}
PIPE_NAMES = ("alu", "add", "fma", "rest")
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
PROBE = re.compile(r"rebase_step_probeILi(n?\d+)ELi(\d+)EE")


def parse(sass: str):
    """{function name: [instruction text]} of cuobjdump -sass output."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            funcs[cur] = []
        elif cur is not None:
            m = INSN.search(line)
            if m:
                funcs[cur].append(m.group(1))
    return funcs


def opcode(insn: str) -> str:
    tok = insn.split()
    if tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0].split(".")[0]


def step_insns(insns):
    """The instructions that are step work, as (opcode, text)."""
    out = []
    for t in insns:
        op = opcode(t)
        if op in SKIP or (op in ("MOV", "IMAD") and "c[0x0]" in t):
            continue
        out.append((op, t))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "rebase_sass.txt"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from chip_smoke import REBASE_OPS
    from fluidframework_tpu_torch.ops import _build
    from fluidframework_tpu_torch.testing.tree_streams import config4_inputs

    nvcc = _build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    src = os.path.join(_build.CSRC_DIR, "rebase_batch.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cubin = os.path.join(_build.BUILD_DIR, "rebase_batch-probes.cubin")
    subprocess.run([nvcc, "-cubin", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-DREBASE_STEP_PROBES", "-o", cubin, src], check=True)
    probes_sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                                 capture_output=True, text=True).stdout
    lib, _ = _build.build("rebase_batch")
    lib_sass, lib_res = (
        (lambda r: r.stdout + r.stderr)(subprocess.run(
            [cuobjdump, flag, lib], capture_output=True, text=True))
        for flag in ("-sass", "-res-usage"))

    counts, mixes, pipes = {}, {}, {}
    for name, insns in parse(probes_sass).items():
        m = PROBE.search(name)
        if m:
            key = (KINDS[m.group(1)], CODES[int(m.group(2))])
            work = step_insns(insns)
            counts[key] = len(work)
            mixes[key] = collections.Counter(op for op, _ in work)
            pipes[key] = collections.Counter(PIPES.get(op, "rest")
                                             for op, _ in work)
    kinds = (0, 1, 2, -1, "generic")
    names = {0: "insert", 1: "remove", 2: "move", -1: "other",
             "generic": "generic"}

    def table(kind, code):
        if kind == "generic":
            return sum(REBASE_OPS[code][k] for k in (0, 1, 2))
        return REBASE_OPS[code][kind]

    lines = ["rebase step, SASS instructions (probe less its noop probe) "
             "/ REBASE_OPS, by base code (rows) and pending kind "
             "(columns; generic: the table's three kinds summed)",
             "code     " + "".join(f"{names[k]:>16}" for k in kinds)]
    for code in CODES[:4]:
        lines.append(f"{code:<9}" + "".join(
            f"{counts[(k, code)] - counts[(k, 'noop')]:>9} / {table(k, code):>3}"
            for k in kinds))
    _, base = config4_inputs()
    bk = base[:, 0]
    mix = {"insert": int((bk == 0).sum()), "remove": int((bk == 1).sum()),
           "move": int((bk == 2).sum())}
    m = sum(mix.values())
    lines.append(f"config 4's base mix {mix} (no identity move): a step's "
                 "mean, SASS / table")
    for k in kinds:
        sass = sum((counts[(k, c)] - counts[(k, "noop")]) * n
                   for c, n in mix.items()) / m
        tab = sum(table(k, c) * n for c, n in mix.items()) / m
        lines.append(f"  {names[k]:<8} {sass:.2f} / {tab:.2f}")
    from chip_smoke import REBASE_ALU_OPS

    def by_pipe(kind, code):
        return [pipes[(kind, code)][p] - pipes[(kind, "noop")][p]
                for p in PIPE_NAMES]

    lines.append("the same, by pipe: alu + add + fma + rest (alu: the ALU "
                 "alone; add: ALU adds and shifts, an IMAD could do them; "
                 "fma: IMAD and its forms) / REBASE_ALU_OPS")
    lines.append("code     " + "".join(f"{names[k]:>20}" for k in kinds))
    for code in CODES[:4]:
        lines.append(f"{code:<9}" + "".join(
            f"{'+'.join(map(str, by_pipe(k, code))):>13} / "
            f"{REBASE_ALU_OPS[code][k] if k != 'generic' else '':>4}"
            for k in kinds))
    lines.append("config 4's base mix: a step's mean by pipe, "
                 + " / ".join(PIPE_NAMES))
    for k in kinds:
        mean = [sum(by_pipe(k, c)[i] * n for c, n in mix.items()) / m
                for i in range(len(PIPE_NAMES))]
        lines.append(f"  {names[k]:<8} "
                     + " / ".join(f"{v:.2f}" for v in mean))
    report = "\n".join(lines)
    print(report)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(report + "\n\n")
        for key in sorted(mixes, key=str):
            f.write(f"probe {key}: {counts[key]} step instructions: "
                    f"{dict(mixes[key])}; by pipe {dict(pipes[key])}\n")
        f.write("\n# library resource usage\n" + lib_res)
        f.write("\n# library SASS\n" + lib_sass)
        f.write("\n# probe SASS\n" + probes_sass)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
