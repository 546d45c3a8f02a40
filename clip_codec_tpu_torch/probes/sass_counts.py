"""What the attention probe's kernels compiled to: SASS opcode counts and ptxas' spills.

    python -m clip_codec_tpu_torch.probes.sass_counts

Builds ``csrc/flash_attention_probe.cu`` as the wrappers do (``ops._build``;
needs ``nvcc`` and ``cuobjdump``, not a card), disassembles the library with
``cuobjdump -sass`` and prints one line per kernel: its template arguments
(the form, key tile, consumer warpgroups, P.V width, exp2 degree, row sum),
its instruction count, and the count of each opcode in ``OPS`` (the
conversion and exp-unit instructions: ``MUFU``, ``F2I``, ``FRND``, ``F2F``,
``I2F``; ``F2FP`` packs two fp32 to bf16). For P2's kernels each count is
also given per S element: every S element a thread holds is packed into
P's bf16 A fragment once, two to an ``F2FP``, and P2's epilogue packs
nothing, so S elements = 2 x F2FP over the kernel's code (the peeled
first tile and the loop body). Then each kernel's registers and spill
bytes from the build's ``-Xptxas -v`` log.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

MODES = ("full", "exp2", "noscale", "nomax", "noexp", "dotonly", "single_pass", "fast")
FAST = MODES.index("fast")
OPS = ("MUFU", "F2I", "FRND", "F2F", "I2F", "F2FP")
# probe_kernel<MODE, BKT, NWG, STAGES, PVN, DEG, MXU>, as the Itanium ABI mangles it.
_ARGS = re.compile(r"probe_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E")
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def opcode_counts(sass: str) -> Dict[str, collections.Counter]:
    """``cuobjdump -sass`` text -> {mangled kernel name: Counter of base opcodes}
    (the opcode before its first '.', predicates dropped)."""
    out: Dict[str, collections.Counter] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = out.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            current[m.group(1)] += 1
    return out


def kernel_args(name: str) -> Optional[Tuple[int, ...]]:
    """(mode, bkt, nwg, stages, pvn, deg, mxu) of a probe kernel's mangled name, else None."""
    m = _ARGS.search(name)
    return tuple(int(g) for g in m.groups()) if m else None


def label(args: Tuple[int, ...]) -> str:
    mode, bkt, nwg, _, pvn, deg, mxu = args
    form = MODES[mode]
    if mode == FAST:
        form = f"P2 {'hw' if deg == 0 else f'poly{deg}'}-exp2 + {'mxu' if mxu else 'vpu'}-sum, P.V {pvn}"
    return f"{form} ({64 * nwg},{bkt})"


def ptxas_report(log: str) -> Dict[str, str]:
    """The build log's ``-Xptxas -v`` report -> {mangled name: its spill and
    register lines, joined}."""
    out: Dict[str, List[str]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, [])
        elif name and ("spill stores" in line or "Used" in line):
            out[name].append(line.split(":")[-1].strip())
    return {n: "; ".join(v) for n, v in out.items()}


def report(sass: str, log: str, ops: Sequence[str]) -> List[str]:
    lines = []
    ptxas = ptxas_report(log)
    for name, counts in sorted(opcode_counts(sass).items(), key=lambda kv: kernel_args(kv[0]) or ()):
        args = kernel_args(name)
        if args is None:
            continue
        total = sum(counts.values())
        line = f"[sass] {label(args):<48} {total:6d} instructions; " + " ".join(f"{op} {counts[op]}" for op in ops)
        if args[0] == FAST and counts["F2FP"]:
            per = 2 * counts["F2FP"]
            line += f"; per S element ({per} a thread): " + " ".join(f"{op} {counts[op] / per:.4f}" for op in ops)
        lines.append(line)
        lines.append(f"[ptxas] {label(args):<47} {ptxas.get(name) or 'not in the log'}")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="SASS opcode counts and spills of the attention probe's kernels.")
    p.parse_args(argv)
    from ..ops import _build

    lib = _build.build("flash_attention_probe")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    for line in report(sass, lib.with_suffix(".log").read_text(), OPS):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
