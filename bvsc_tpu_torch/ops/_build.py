"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and includes no
PyTorch header, so one nvcc call builds it in seconds.  The shared library
goes to ``bvsc_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags, so a changed source is rebuilt and an
unchanged one is built once per checkout.  Nothing is built at import: the
first launch builds, or :func:`load_all` builds every source at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# No --use_fast_math: parity mode needs the full-precision sinf / expf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def sources() -> list[str]:
    """Names of the CUDA sources under ``csrc/`` (without ``.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def _compile(names) -> None:
    """Start one nvcc for each of ``names`` whose library is missing, all
    together, and wait for every one of them; raise if any failed."""
    missing = [name for name in names if not os.path.exists(library_path(name))]
    if not missing:
        return
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = []
    for name in missing:
        out = library_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, and load it."""
    _compile([name])
    return ctypes.CDLL(library_path(name))


def load_all() -> dict[str, ctypes.CDLL]:
    """Build every source under ``csrc/`` (one nvcc each, run in parallel)
    and load them all."""
    _compile(sources())
    return {name: load(name) for name in sources()}
