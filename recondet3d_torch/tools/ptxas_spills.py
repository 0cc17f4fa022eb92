"""Registers and spills of every kernel in a CUDA source, and of variants of it.

    python -m recondet3d_torch.tools.ptxas_spills SOURCE [--variant NAME OLD NEW]...

Compiles ``recondet3d_torch/csrc/SOURCE`` as ``ops/build.py`` does (sm_90a,
``-O3``, ``-Xptxas -v``) into a cubin, once as it is and once for each
``--variant``, a copy of the source with the text OLD replaced by NEW (for
example ``--variant n64 "DC <= 2 ? 128 : 64" "DC <= 1 ? 128 : 64"``; a NAME
given again adds its replacement to the same copy), all compiles started
together in a temporary directory. Prints one JSON line a
build: per kernel (its base name, with ``<DC,EDGE>`` for an instance of the
attention templates) the registers, spill stores and spill loads ptxas
reports. A quick way to try a tile or thread choice on the machine with the
CUDA toolkit without a full ``chip_smoke.py`` run; it changes no file of the
repo.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from recondet3d_torch.ops.build import CSRC, _nvcc

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v"]


def kernel_label(mangled: str) -> str:
    """The base name ending in ``_kernel``, with ``<DC,EDGE>`` for an
    instance of a template on (int, bool); the symbol as it is otherwise."""
    m = re.search(r"([a-z][a-z_]*_kernel)(?:ILi(\d+)ELb([01])E)?", mangled)
    if not m:
        return mangled
    return m.group(1) + (f"<{m.group(2)},{m.group(3)}>" if m.group(2) else "")


def report(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from ptxas's output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("source", help="a file of recondet3d_torch/csrc, e.g. flash_attn_fwd.cu")
    ap.add_argument("--variant", nargs=3, action="append", default=[], metavar=("NAME", "OLD", "NEW"))
    args = ap.parse_args(argv)
    text = (CSRC / args.source).read_text()
    builds = {"as_is": text}
    for name, old, new in args.variant:
        src = builds.get(name, text)
        if old not in src:
            print(f"ptxas_spills: {old!r} is not in {args.source} (variant {name})", file=sys.stderr)
            return 2
        builds[name] = src.replace(old, new)
    with tempfile.TemporaryDirectory() as tmp:
        running = {}
        for name, src in builds.items():
            path = Path(tmp) / name / args.source
            path.parent.mkdir()
            path.write_text(src)
            running[name] = subprocess.Popen(
                [_nvcc(), *_FLAGS, "-I", str(CSRC), "-o", str(path.with_suffix(".cubin")), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        failed = 0
        for name, proc in running.items():
            log = proc.communicate()[0]
            failed |= proc.returncode != 0
            print(json.dumps({"build": name, "rc": proc.returncode, "kernels": report(log)}
                             | ({} if proc.returncode == 0 else {"log": log[-4000:]})), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
