"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``paddle_tpu_torch/csrc/`` with a
plain C entry point.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``<repo>/build/`` at first use, named by a hash of
its source, the shared headers (``csrc/*.cuh``) and the flags (a changed
source or header never loads a stale library), and loaded with
``ctypes``.  ``build()`` starts one ``nvcc`` per source, all
at once, so a script that needs every kernel pays for the slowest build
only.  Nothing here runs at import: the CPU test suite imports every
module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "library"]

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build"

# kernel name -> source, relative to the package
SOURCES = {
    "ragged_paged_attention": "csrc/ragged_paged_attention.cu",
    "quant_matmul": "csrc/quant_matmul.cu",
    "flash_attention": "csrc/flash_attention.cu",
    "flash_attention_varlen": "csrc/flash_attention_varlen.cu",
    "fused_norms": "csrc/fused_norms.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin)"
                           ": the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    src = (_PKG / SOURCES[name]).read_bytes()
    headers = b"".join(h.read_bytes()
                       for h in sorted((_PKG / "csrc").glob("*.cuh")))
    key = hashlib.sha256(src + headers +
                         " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names=None) -> dict:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together.  Returns ``{name: (seconds,
    ptxas report)}`` for the kernels built now; raises on a failed build."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_PKG / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)              # atomic: concurrent builders agree
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib
