"""Static SASS statistics of the port's built kernels (no JAX counterpart:
XLA and Mosaic compile the JAX package's kernels themselves).

    python -m kimera_semantics_tpu_torch.tools.sass_stats LIB.so [LIB.so ...]

For every kernel function in each shared library, `cuobjdump -sass` (from
the CUDA toolkit beside nvcc) gives its machine code; this prints one JSON
object per library: for each function its instruction count (NOPs left
out), its MUFU instructions by kind (MUFU.RCP per division, MUFU.RSQ per
sqrt, slow paths included) and its backward branches (loops). A static
count: what runs per voxel also depends on the branches taken.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def cuobjdump() -> str:
    from ..ops import _build
    return os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")


def stats(so_path: str) -> dict:
    """{function: {"instructions", "mufu": {kind: n}, "backward_branches"}}
    of every kernel in the library at `so_path`."""
    out = subprocess.run([cuobjdump(), "-sass", so_path], capture_output=True,
                         text=True, check=True).stdout
    res, cur = {}, None
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = res.setdefault(m.group(1), dict(instructions=0, mufu={},
                                                  backward_branches=0))
            continue
        m = _INSN.match(line)
        if cur is None or not m:
            continue
        addr, insn = int(m.group(1), 16), m.group(2)
        op = insn.split()[1] if insn.startswith("@") else insn.split()[0]
        if op == "NOP":
            continue
        cur["instructions"] += 1
        if op.startswith("MUFU."):
            cur["mufu"][op] = cur["mufu"].get(op, 0) + 1
        b = _BRA.search(insn)
        if b and int(b.group(1), 16) < addr:
            cur["backward_branches"] += 1
    return res


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    for p in paths:
        print(json.dumps({"library": p, "functions": stats(p)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
