"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and includes no
PyTorch header, so one nvcc call builds it in seconds.  The shared library
goes to ``bvsc_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source (with the files it includes by ``#include "..."``) and
the flags, so a changed source is rebuilt and an unchanged one is built
once per checkout.  Nothing is built at import: the
first launch builds, or :func:`load_all` builds every source at once.
:func:`compile_files` builds any source file the same way, such as a
benchmark's copy of a kernel with one change.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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
    """The library built from ``csrc/<name>.cu``."""
    return library_for(os.path.join(CSRC, f"{name}.cu"))


def _text(source: str) -> bytes:
    """``source``'s bytes followed by those of the files it includes with
    ``#include "..."`` (beside it), recursively."""
    with open(source, "rb") as f:
        data = f.read()
    for name in re.findall(rb'#include "([^"]+)"', data):
        data += _text(os.path.join(os.path.dirname(source), name.decode()))
    return data


def library_for(source: str) -> str:
    """The library built from the CUDA source file ``source``, named by a
    hash of its text (and its includes') and the flags."""
    digest = hashlib.sha256(_text(source) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")


def compile_files(sources) -> list[str]:
    """Start one nvcc for each source file whose library is missing, all
    together, and wait for every one of them; raise if any failed.
    Returns the libraries' paths."""
    outs = [library_for(src) for src in sources]
    missing = [(src, out) for src, out in zip(sources, outs) if not os.path.exists(out)]
    if not missing:
        return outs
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = []
    for src, out in dict(missing).items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, and load it."""
    return ctypes.CDLL(compile_files([os.path.join(CSRC, f"{name}.cu")])[0])


def load_all() -> dict[str, ctypes.CDLL]:
    """Build every source under ``csrc/`` (one nvcc each, run in parallel)
    and load them all."""
    compile_files([os.path.join(CSRC, f"{name}.cu") for name in sources()])
    return {name: load(name) for name in sources()}
