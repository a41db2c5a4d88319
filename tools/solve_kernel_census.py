#!/usr/bin/env python3
"""Floating-point instruction census of the solve kernel's placements.

    python3 tools/solve_kernel_census.py [--parent DIR] [--out FILE]

Compiles `lap_time_optimization_tpu_torch/csrc/ilqr.cu` (and, with
`--parent`, the same file under another checkout, e.g. a `git archive` of
the parent commit) with the flags of `ops/_build.py` to PTX and to SASS
(`cuobjdump -sass` of the object), and counts, for every instantiation of
`ilqr_solve_kernel` (float or double; the table in shared or global
memory; the slices in shared memory or in the workspace), each
floating-point opcode: PTX instructions typed .f32/.f64, SASS F*/D*/MUFU
instructions.  The placements differ only in where their pointers point,
so the counts of the opcodes that round (add, multiply, fused
multiply-add, divide, square root, conversions, the special-function
unit) must be equal, and the shared placement's must equal the parent's;
opcodes that are exact (selects, compares, min/max, abs, neg) are counted
and printed too, but a difference there changes no value.  The script
prints the table as JSON and exits 1 where the rounding counts differ.
Needs the CUDA toolkit (nvcc, cuobjdump); run it on the machine with the
card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("lap_time_optimization_tpu_torch", "csrc", "ilqr.cu")
KERNEL = "ilqr_solve_kernel"
SASS_FP = re.compile(r"^(FFMA|FMUL|FADD|FMNMX|FSETP|FSEL|FCHK|DFMA|DMUL|DADD|DSETP|DMNMX|MUFU)\b")
# Opcodes whose result is rounded (PTX by its first component, SASS by its
# name): the ones whose counts must agree between placements.
PTX_ROUNDING = {"add", "sub", "mul", "fma", "mad", "div", "rcp", "sqrt", "rsqrt", "cvt", "ex2", "lg2",
                "sin", "cos", "tanh"}
SASS_ROUNDING = ("FFMA", "FMUL", "FADD", "DFMA", "DMUL", "DADD", "MUFU")


def rounding(kind: str, counts: collections.Counter) -> dict:
    """The counts of the opcodes that round."""
    keep = ((lambda op: op.split(".")[0] in PTX_ROUNDING) if kind == "ptx"
            else (lambda op: op.split(".")[0] in SASS_ROUNDING))
    return {op: n for op, n in counts.items() if keep(op)}


def _tool(name: str) -> str:
    sys.path.insert(0, ROOT)
    from lap_time_optimization_tpu_torch.ops import _build

    return os.path.join(os.path.dirname(_build._nvcc()), name)


def _flags():
    from lap_time_optimization_tpu_torch.ops import _build

    return [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v", "-Xcompiler", "-fPIC")]


def _sections(text: str, start: re.Pattern) -> dict:
    """{kernel instantiation: its lines} of a PTX or SASS listing."""
    out, name = {}, None
    for line in text.splitlines():
        m = start.search(line)
        if m:
            name = m.group(1) if KERNEL in m.group(1) else None
            if name:
                out[name] = []
            continue
        if name:
            out[name].append(line.strip())
    return out


def _label(mangled: str) -> str:
    """float/double and the placement flags of an instantiation."""
    m = re.search(KERNEL + r"I([fd])((?:Lb[01]E)+)", mangled)
    flags = re.findall(r"Lb([01])E", m.group(2))
    names = ("global table", "workspace")
    where = [n for n, f in zip(names, flags) if f == "1"] or ["shared"]
    return f"{'f32' if m.group(1) == 'f' else 'f64'} {' + '.join(where)}"


def census(source: str, tmp: str, tag: str) -> dict:
    """{instantiation label: {"ptx": Counter, "sass": Counter}}."""
    ptx, obj = os.path.join(tmp, f"{tag}.ptx"), os.path.join(tmp, f"{tag}.o")
    nvcc = _tool("nvcc")
    subprocess.run([nvcc, *_flags(), "-ptx", "-o", ptx, source], check=True)
    subprocess.run([nvcc, *_flags(), "-c", "-o", obj, source], check=True)
    sass = subprocess.run([_tool("cuobjdump"), "-sass", obj], check=True, capture_output=True, text=True).stdout
    with open(ptx) as fh:
        ptx_text = fh.read()
    out = collections.defaultdict(dict)
    for name, lines in _sections(ptx_text, re.compile(r"\.entry\s+(\S+?)\(")).items():
        ops = [ln.split()[0] for ln in lines if ln and not ln.startswith(("//", ".", "{", "}", "$", "@"))]
        ops += [ln.split()[1] for ln in lines if ln.startswith("@") and len(ln.split()) > 1]
        out[_label(name)]["ptx"] = collections.Counter(
            op for op in ops if re.search(r"\.f(32|64)\b", op) and not op.startswith(("ld.", "st.", "mov.")))
    for name, lines in _sections(sass, re.compile(r"Function : (\S+)")).items():
        ops = []
        for ln in lines:
            m = re.match(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
            if m and SASS_FP.match(m.group(1)):
                ops.append(m.group(1))
        out[_label(name)]["sass"] = collections.Counter(ops)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose csrc/ilqr.cu the shared placement is held to")
    ap.add_argument("--out", help="write the table as JSON to this file too")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        table = {"change": census(os.path.join(ROOT, SOURCE), tmp, "change")}
        if args.parent:
            table["parent"] = census(os.path.join(args.parent, SOURCE), tmp, "parent")
    ok, report = True, {}
    for tree, kernels in table.items():
        for label, counts in sorted(kernels.items()):
            report[f"{tree} {label}"] = {kind: {"total": sum(c.values()),
                                                "rounding": sum(rounding(kind, c).values()),
                                                **dict(sorted(c.items()))}
                                         for kind, c in counts.items()}
    key = lambda counts: {kind: rounding(kind, c) for kind, c in counts.items()}
    for dtype in ("f32", "f64"):
        base = table["change"][f"{dtype} shared"]
        others = [(label, counts) for label, counts in table["change"].items() if label.startswith(dtype)]
        if "parent" in table:
            others.append((f"parent {dtype} shared", table["parent"][f"{dtype} shared"]))
        for label, counts in others:
            if key(counts) != key(base):
                ok = False
                print(f"{label}: the rounding opcodes' counts differ from {dtype} shared")
            elif counts != base:
                print(f"{label}: equal rounding opcodes; exact opcodes differ from {dtype} shared")
    text = json.dumps({"equal": ok, "census": report}, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
