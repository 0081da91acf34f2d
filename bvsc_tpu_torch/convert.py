"""Carry weights into the port.

* :func:`bvrnn_params_from_jax` and :func:`vocoder_params_from_jax` take the
  JAX package's parameter trees (nested dicts and lists of arrays, already
  converted to numpy by the caller) and return the port's trees of float32
  tensors, or of bf16 ones with ``dtype=torch.bfloat16`` (each value rounded
  once, as the reference's ``astype`` rounds it).  The layouts are the same on both sides, so this is a walk over
  the tree; weight-normed vocoder convs (``g``, ``v``) are folded to ``w``.
* Training state: :func:`bvrnn_params_from_jax` keeps ``log_sigma`` and the
  mel statistics, :func:`generator_train_params_from_jax` keeps the
  generator's ``{g, v, b}`` unfolded, and
  :func:`discriminator_params_from_jax` carries an MPD or MRD tree with
  its spectral-norm buffers, so both trainers can start from the JAX
  trainers' weights.
* :func:`flatten_tree` / :func:`unflatten_tree`: the flat ``a/0/b`` names
  of the ``.npz`` files and the trainers' checkpoints.
* :func:`load_bvrnn_npz` reads the flat ``a/0/b``-keyed ``.npz`` BVRNN
  checkpoints of ``chkpts/`` with numpy alone (the counterpart of
  ``bvsc_tpu/codec.py:_unflatten_npz``); float16 values widen to float32,
  or with ``dtype=torch.bfloat16`` round once to bf16, as
  ``_unflatten_npz(z, jnp.bfloat16)`` rounds them.
* :func:`load_vocoder_npz` reads a vocoder written in the same layout by
  ``tools/export_vocoder_npz.py`` (weight norm already folded).
"""

from __future__ import annotations

import numpy as np
import torch

from bvsc_tpu_torch.ops.conv import fold_weight_norm


def to_torch(tree, device: str | torch.device = "cpu", copy: bool = False,
             dtype: torch.dtype = torch.float32):
    """Map every leaf (array or tensor) of a nested dict/list tree to a
    ``dtype`` (float32 or bf16) tensor on ``device``; with ``copy`` each
    leaf is a new tensor, detached (a trainer's own weights, which it
    updates in place).  Arrays go through float32 first: exact for the
    float16 and float32 values of the checkpoints, so a bf16 leaf is
    rounded once."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, copy, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, copy, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        if copy:
            return tree.detach().to(device=device, dtype=dtype, copy=True)
        return tree.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(tree, np.float32), device=device).to(dtype)


def _fold_weight_norm(tree):
    if isinstance(tree, dict):
        if "g" in tree and "v" in tree:
            rest = {k: v for k, v in tree.items() if k not in ("g", "v")}
            return {"w": fold_weight_norm(tree["g"], tree["v"]), **rest}
        return {k: _fold_weight_norm(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fold_weight_norm(v) for v in tree]
    return tree


def bvrnn_params_from_jax(tree, dtype: torch.dtype = torch.float32) -> dict:
    """JAX BVRNN params -> port params (same keys, (in, out) linear
    weights) in ``dtype``."""
    return to_torch(tree, dtype=dtype)


def vocoder_params_from_jax(tree, dtype: torch.dtype = torch.float32) -> dict:
    """JAX generator params -> port inference params (weight norm folded,
    in float32, then the tree in ``dtype``)."""
    folded = _fold_weight_norm(to_torch(tree))
    return folded if dtype == torch.float32 else to_torch(folded, dtype=dtype)


def generator_train_params_from_jax(tree) -> dict:
    """JAX trainer generator params (weight-normed ``{g, v, b}``) -> the
    port's trainer tree, unfolded (``VocoderGANTrainer(gen_params=)``)."""
    return to_torch(tree)


def discriminator_params_from_jax(tree) -> list:
    """A JAX MPD or MRD tree (weight-normed, or spectral-normed with its
    ``sn_u`` / ``sn_v`` buffers) -> the port's (same keys and layouts)."""
    return to_torch(tree)


def flatten_tree(tree, prefix: str = "") -> dict:
    """A nested dict/list tree -> ``{'a/0/b': leaf}`` in the tree's order
    (the flat layout of the ``.npz`` checkpoints)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def unflatten_tree(flat: dict):
    """Inverse of :func:`flatten_tree`; key levels that are all integers
    become lists."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def _load_flat_npz(path: str, dtype: torch.dtype = torch.float32) -> dict:
    """Flat ``a/0/b``-keyed npz -> nested tree of ``dtype`` tensors."""
    with np.load(path) as z:
        return to_torch(unflatten_tree({k: np.asarray(z[k], np.float32) for k in z.files}),
                        dtype=dtype)


def load_bvrnn_npz(path: str, dtype: torch.dtype = torch.float32) -> dict:
    """A flat BVRNN ``.npz`` -> the port's BVRNN tree in ``dtype``."""
    return _load_flat_npz(path, dtype)


def load_vocoder_npz(path: str, dtype: torch.dtype = torch.float32) -> dict:
    """A flat vocoder ``.npz`` (``tools/export_vocoder_npz.py``) -> the
    port's generator tree in ``dtype``, the one :func:`vocoder_params_from_jax`
    returns."""
    return vocoder_params_from_jax(_load_flat_npz(path), dtype)
