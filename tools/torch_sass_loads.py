#!/usr/bin/env python3
"""The global loads of the decode kernels' machine code (SASS), kernel by
kernel: which go through L1 and which past it.

    python3 tools/torch_sass_loads.py [--tree DIR] [--out loads.json]

Builds the kernels of ``DIR/ai00_server_tpu_torch`` (this checkout by
default) with ``ops/_build.build_all`` and disassembles each library with
``cuobjdump -sass``.  For every kernel of the stacks' programmatic
dependents (``ln_mix_kernel``, ``skinny_tc_kernel``, ``skinny_fma_kernel``,
``wkv_gn_kernel``, ``v6_wkv_gn_kernel``, ``qmm_kernel``,
``v4_wkv_kernel``, ``wkv7_t1_kernel``) it counts the ``LDG`` instructions by their modifiers:
``LDG.E.CONSTANT`` is a non-coherent load through L1 (``ld.global.nc``:
``__ldg``, or a load nvcc derives from a ``const __restrict__`` pointer),
``.STRONG.GPU`` / ``.EF`` a load past L1 (``ld.global.cg``), a plain
``LDG.E`` one that may hit L1.  What an earlier kernel writes must not be
read through L1 by a programmatic dependent
(``csrc/decode_common.cuh:ld4_l2``): the printed table says which kernels
still have loads that could.  Prints one line a kernel and one JSON object.
Needs ``nvcc`` and ``cuobjdump``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("ln_mix_kernel", "skinny_tc_kernel", "skinny_fma_kernel",
           "wkv_gn_kernel", "v6_wkv_gn_kernel", "qmm_kernel",
           "v4_wkv_kernel", "wkv7_t1_kernel")
LIBS = ("v7_decode", "v6_decode", "quant", "wkv4", "wkv7")


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    sys.exit("cuobjdump not found (PATH or /usr/local/cuda/bin)")


def kernel_of(mangled: str) -> str | None:
    """The kernel a mangled function name belongs to, longest name first
    (``v6_wkv_gn_kernel`` holds ``wkv_gn_kernel``)."""
    for name in sorted(KERNELS, key=len, reverse=True):
        if re.search(rf"\d{name}I|\d{name}E|\d{name}v", mangled):
            return name
    return None


def loads(lib: Path) -> dict:
    """{kernel: {instantiation count, LDG variant: count}} of one library."""
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out: dict = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernel_of(m.group(1))
            if current is not None:
                row = out.setdefault(current, collections.Counter())
                row["instantiations"] += 1
            continue
        if current is None:
            continue
        m = re.search(r"\b(LDG(?:\.[A-Z0-9_]+)*)\b", line)
        if m:
            out[current][m.group(1)] += 1
    return {k: dict(v) for k, v in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    from ai00_server_tpu_torch.ops import _build

    libs = _build.build_all()
    result = {}
    for name in LIBS:
        result.update({f"{name}:{k}": v
                       for k, v in loads(Path(libs[name]._name)).items()})
    for name, row in sorted(result.items()):
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in
                                      sorted(row.items())), flush=True)
    out = {"tree": str(tree), "loads": result}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
