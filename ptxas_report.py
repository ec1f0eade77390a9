#!/usr/bin/env python3
"""Registers and spills of every kernel of alpro_tpu_torch, from ptxas.

    python3 ptxas_report.py [checkout]

Compiles each ``alpro_tpu_torch/csrc/*.cu`` of ``checkout`` (default: this
repository) with the build's flags plus ``-Xptxas -v``, one ``nvcc`` per
source, all at once, and prints one line per kernel: the source, the kernel
demangled (``cu++filt``), its registers and its spill stores and loads in
bytes. A ``C7510``-``C7512`` line ("wgmma.mma_async instructions are
serialized") is printed as it is. Needs ``nvcc`` (the machine with the
card); exits non-zero if a source does not compile.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

from alpro_tpu_torch.ops import _build


def _demangle(names: list) -> list:
    filt = Path(_build.find_nvcc()).with_name("cu++filt")
    if not filt.is_file():
        return names
    out = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return [re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", n) for n in out]


def _short(name: str) -> str:
    """The kernel's name and template arguments, without its parameters."""
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i].removeprefix("void ")
    return name


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parent)
    csrc = root / "alpro_tpu_torch" / "csrc"
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for src in sorted(csrc.glob("*.cu")):
            cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc), "-c", "-o",
                   str(Path(tmp) / f"{src.stem}.o"), str(src)]
            procs[src.name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)
        outputs = {name: p.communicate()[0] for name, p in procs.items()}
    failed = [name for name, p in procs.items() if p.returncode]
    for name, text in outputs.items():
        if name in failed:
            print(f"[ptxas] {name}: nvcc failed\n{text}", flush=True)
            continue
        rows, entry, spill = [], None, ("?", "?")
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spill = m.groups()
            elif (m := re.search(r"Used (\d+) registers", line)) and entry:
                rows.append((entry, m.group(1), spill))
                entry = None
            elif re.search(r"C751[0-2]", line):
                print(f"[ptxas] {name}: {line.strip()}", flush=True)
        for (_, regs, (st, ld)), demangled in zip(rows, _demangle([r[0] for r in rows])):
            print(f"[ptxas] {name}: {_short(demangled)}: {regs} registers, spill {st}/{ld} "
                  f"bytes", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
