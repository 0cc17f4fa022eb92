"""Build the hand-written CUDA kernels at first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded through ``ctypes``. Libraries go to
``build/torch_kernels/<hash>/`` beside the package (listed in
``.gitignore``); the hash covers every source and the flags, so an edited
source builds anew and an unchanged one is reused. The compiler's report
(``-Xptxas -v``: registers, spills, shared memory, warnings) is kept beside
each library. Nothing here runs at import time. The first call builds and
loads under a lock, so threads that launch their first kernels at once
(a server's worker and its handlers) wait for one build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
_lock = threading.Lock()
# per source: {"seconds": seconds from its nvcc's start to its end, read in turn (0.0 if cached), "ptxas": compiler
# report (of the build that made the library, if cached)}
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
    with _lock:
        if not _libs:
            _build_and_load()
    return _libs


def _build_and_load() -> None:
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    # one nvcc per source, all started together; a library is written under a
    # temporary name, so a killed build leaves nothing to reuse
    sources = sorted(CSRC.glob("*.cu"))
    running = {}
    for src in sources:
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            log = lib.with_suffix(".ptxas.txt")
            BUILD_LOG[src.stem] = {"seconds": 0.0, "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
        proc = subprocess.Popen([_nvcc(), *_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[src.stem] = (proc, tmp, time.perf_counter())
    failed = []
    for stem, (proc, tmp, t0) in running.items():
        log = proc.communicate()[0]
        BUILD_LOG[stem] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {stem}.cu (rc {proc.returncode}):\n{log}")
        else:
            (out / f"lib{stem}.ptxas.txt").write_text(log)
            os.replace(tmp, out / f"lib{stem}.so")
    if failed:
        raise RuntimeError("\n".join(failed))
    libs = {src.stem: ctypes.CDLL(str(out / f"lib{src.stem}.so")) for src in sources}
    _libs.update(libs)  # all at once: a thread that finds _libs non-empty finds every library
