"""Build the port's plain C sources with ``cc`` and load them with ctypes.

The sources are ``bvsc_tpu_torch/native/<name>.c``, each a plain C
interface with no Python header.  A library goes to the gitignored
``bvsc_tpu_torch/_build/``, named by a hash of its source and flags, so a
changed source is rebuilt and an unchanged one is built once per checkout;
never a checked-in binary.  Nothing is built at import: each module builds
its library on first use, and falls back to numpy when there is no C
compiler (:func:`load` returns None).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
CC_FLAGS = ("-O3", "-shared", "-fPIC")


def source(name: str) -> str:
    """The C source ``native/<name>.c``."""
    return os.path.join(NATIVE_DIR, f"{name}.c")


def build(name: str, extra_flags: tuple[str, ...] = ()) -> str:
    """Compile ``native/<name>.c`` unless its library exists; return the
    library's path.  Raises OSError (no ``cc``) or CalledProcessError."""
    src = source(name)
    flags = (*CC_FLAGS, *extra_flags)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        try:
            subprocess.run(["cc", *flags, "-o", tmp, src], check=True, capture_output=True)
            os.replace(tmp, so_path)  # atomic: a concurrent build never sees half a file
        finally:
            if os.path.exists(tmp):  # cc failed: no stray half-built library
                os.unlink(tmp)
    return so_path


def load(name: str, extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL | None:
    """:func:`build` and load ``native/<name>.c``; None when there is no C
    compiler (the caller's numpy path)."""
    try:
        return ctypes.CDLL(build(name, extra_flags))
    except (OSError, subprocess.CalledProcessError):
        return None
