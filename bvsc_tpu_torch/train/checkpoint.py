"""Trainer checkpoints: the reference's names and scan, the port's format.

Names are ``<prefix><step:08d>`` (``g_00050000``, ``do_00050000``,
``bvrnn_00001000``), and resuming takes the latest by name, as
``bvsc_tpu/train/checkpoint.py`` does.  Each checkpoint is one file that
``torch.save`` writes: a dict of tensors by flat name (``a/0/b``), ints,
floats and strings, read back with ``torch.load(weights_only=True)`` onto
the CPU.  ``bvsc_tpu``'s Orbax directories are not read (Orbax needs JAX).
"""

from __future__ import annotations

import glob
import os
import re

import torch

FORMAT = "bvsc-train-torch-1"  # the trainers' state dicts carry it, with their "kind"


def checkpoint_name(prefix: str, step: int) -> str:
    return f"{prefix}{step:08d}"


def scan_checkpoint(cp_dir: str, prefix: str) -> str | None:
    """The latest ``<prefix>NNNNNNNN`` path in ``cp_dir`` by name, or None."""
    pattern = os.path.join(cp_dir, prefix + "????????")
    cp_list = [p for p in glob.glob(pattern) if re.search(r"\d{8}$", p)]
    return sorted(cp_list)[-1] if cp_list else None


def step_of(path: str) -> int:
    m = re.search(r"(\d{8})$", path)
    return int(m.group(1)) if m else 0


def save(path: str, state: dict) -> None:
    """Write ``state`` (tensors moved to the CPU) atomically."""
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)


def load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def check_kind(state: dict, *kinds: str) -> None:
    """Raise unless ``state`` is a port trainer checkpoint of one of ``kinds``."""
    if state.get("format") != FORMAT or state.get("kind") not in kinds:
        raise ValueError(f"not a {' or '.join(kinds)} trainer checkpoint of the port")


def save_step(cp_dir: str, prefix: str, step: int, state: dict) -> str:
    os.makedirs(cp_dir, exist_ok=True)
    path = os.path.join(cp_dir, checkpoint_name(prefix, step))
    save(path, state)
    return path


def restore_latest(cp_dir: str, prefix: str) -> tuple[dict | None, int]:
    """(state, step) of the newest checkpoint, or (None, 0)."""
    path = scan_checkpoint(cp_dir, prefix)
    if path is None:
        return None, 0
    return load(path), step_of(path)


def _to_cpu(node):
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_cpu(v) for v in node]
    return node
