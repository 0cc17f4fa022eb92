"""Build the hand-written CUDA kernels at first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded through ``ctypes``. Libraries go to
``build/torch_kernels/<hash>/`` beside the package (listed in
``.gitignore``); the hash covers every source and the flags, so an edited
source builds anew and an unchanged one is reused. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["load_kernels", "BUILD_LOG"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
# per source: {"seconds": wall seconds of its nvcc (0.0 if cached), "ptxas": compiler report}
BUILD_LOG: Dict[str, dict] = {}


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns
    {source stem: CDLL}. Raises with the compiler's output on failure."""
    if _libs:
        return _libs
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    for src in sorted(CSRC.glob("*.cu")):
        so = out / f"lib{src.stem}.so"
        if so.exists():
            BUILD_LOG[src.stem] = {"seconds": 0.0, "ptxas": "cached"}
        else:
            # written under a temporary name, so a killed build leaves no library to reuse
            tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            BUILD_LOG[src.stem] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stdout}
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src.name} (rc {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, so)
        _libs[src.stem] = ctypes.CDLL(str(so))
    return _libs
