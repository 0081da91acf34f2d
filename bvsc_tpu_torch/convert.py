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
* The reference's PyTorch checkpoints (the counterparts of
  ``bvsc_tpu/convert.py``): :func:`bvrnn_params_from_torch` reads the
  upstream BVRNN ``state_dict`` (the ``'vrnn'`` entry of its ``.pt`` file)
  and :func:`bvrnn_params_to_torch_sd` writes one;
  :func:`vocoder_params_from_torch` reads an upstream BigVGAN generator
  ``state_dict`` (the ``'generator'`` entry of a ``g_`` file) in every
  weight-norm layout, folding ``w = g * v / ||v||`` on the host in float64
  (:func:`fold_weight_norm`), and :func:`vocoder_params_to_torch_sd` writes
  one; :func:`mpd_params_from_torch` and :func:`mrd_params_from_torch` keep
  the discriminators' weight norm or spectral norm as the trainers hold
  it.  Linear and GRU weights are transposed to (in, out); conv weights
  keep torch's layouts.  :func:`load_torch_checkpoint` reads such a file.
  The trees are the ones :func:`load_bvrnn_npz` / :func:`load_vocoder_npz`
  return: float32 tensors on the CPU (the BVRNN's in ``dtype``).
"""

from __future__ import annotations

import numpy as np
import torch

from bvsc_tpu_torch.ops import conv as conv_ops


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
            return {"w": conv_ops.fold_weight_norm(tree["g"], tree["v"]), **rest}
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


def tree_size(tree) -> int:
    """The elements of every leaf (array or tensor) of a nested tree."""
    return sum(v.numel() if isinstance(v, torch.Tensor) else np.size(v)
               for v in flatten_tree(tree).values())


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


# ---------------------------------------------------------------------------
# The reference's PyTorch checkpoints
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    """A tensor or array-like as a numpy array on the host (a bf16 tensor
    widened exactly to float32: numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _dense(sd, prefix: str) -> dict:
    return {"w": _np(sd[f"{prefix}.weight"]).T.copy(), "b": _np(sd[f"{prefix}.bias"])}


def bvrnn_params_from_torch(sd, dtype: torch.dtype = torch.float32) -> dict:
    """An upstream BVRNN ``state_dict`` (``nn.Sequential`` MLPs of Linear and
    ELU, a one-layer GRU with its [r|z|n] gate packing) -> the port's BVRNN
    tree in ``dtype``, each value rounded once from float32.  The
    transposed weights are copied row-major, as the ``.npz`` trees are: a
    product's sums follow its operands' layout."""
    def mlp(name, n):
        return [_dense(sd, f"{name}.{2 * j}") for j in range(n)]

    tree = {
        "mean_mel": _np(sd["mean_mel"]),
        "std_mel": _np(sd["std_mel"]),
        "log_sigma": _np(sd["log_sigma"]),
        "phi_x": mlp("phi_x", 3),
        "phi_z": mlp("phi_z", 3),
        "enc": mlp("enc", 3),
        "prior": mlp("prior", 3),
        "dec": mlp("dec", 4),
        "gru": {
            "w_ih": _np(sd["rnn.weight_ih_l0"]).T.copy(),
            "w_hh": _np(sd["rnn.weight_hh_l0"]).T.copy(),
            "b_ih": _np(sd["rnn.bias_ih_l0"]),
            "b_hh": _np(sd["rnn.bias_hh_l0"]),
        },
    }
    return to_torch(tree, dtype=dtype)


def bvrnn_params_to_torch_sd(params) -> dict:
    """Inverse of :func:`bvrnn_params_from_torch`: the upstream
    ``state_dict``, numpy-valued."""
    gru = params["gru"]
    sd = {
        "mean_mel": _np(params["mean_mel"]),
        "std_mel": _np(params["std_mel"]),
        "log_sigma": _np(params["log_sigma"]),
        "rnn.weight_ih_l0": _np(gru["w_ih"]).T.copy(),
        "rnn.weight_hh_l0": _np(gru["w_hh"]).T.copy(),
        "rnn.bias_ih_l0": _np(gru["b_ih"]),
        "rnn.bias_hh_l0": _np(gru["b_hh"]),
    }
    for name in ("phi_x", "phi_z", "enc", "prior", "dec"):
        for j, layer in enumerate(params[name]):
            sd[f"{name}.{2 * j}.weight"] = _np(layer["w"]).T.copy()
            sd[f"{name}.{2 * j}.bias"] = _np(layer["b"])
    return sd


def fold_weight_norm(g, v) -> np.ndarray:
    """``w = g * v / ||v||``, the norm over every axis but 0 (torch's
    ``weight_norm`` with dim 0), computed in float64 on the host and
    rounded once to ``v``'s type."""
    g, v = _np(g), _np(v)
    v64 = v.astype(np.float64)
    norm = np.sqrt((v64 ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return (g.astype(np.float64) * v64 / norm).astype(v.dtype)


_WN = (("weight_g", "weight_v"),
       ("parametrizations.weight.original0", "parametrizations.weight.original1"))


def _weight_norm_keys(sd, prefix: str) -> tuple[str, str] | None:
    """The (g, v) keys of a weight-normed conv in either torch layout:
    ``weight_g`` / ``weight_v``, or torch >= 2.1's parametrization."""
    for g, v in _WN:
        if f"{prefix}.{g}" in sd:
            return f"{prefix}.{g}", f"{prefix}.{v}"
    return None


def _folded_conv(sd, prefix: str) -> dict:
    """A generator conv -> ``{'w', 'b'}``: weight norm folded, or the plain
    ``weight`` left by ``remove_weight_norm``."""
    keys = _weight_norm_keys(sd, prefix)
    w = fold_weight_norm(sd[keys[0]], sd[keys[1]]) if keys else _np(sd[f"{prefix}.weight"])
    return {"w": w, "b": _np(sd[f"{prefix}.bias"])}


def _snake(sd, prefix: str) -> dict:
    p = {"alpha": _np(sd[f"{prefix}.alpha"])}
    if f"{prefix}.beta" in sd:
        p["beta"] = _np(sd[f"{prefix}.beta"])
    return p


def _act_prefix(sd, prefix: str) -> str:
    """An activation's prefix: the alias-free wrapper adds ``.act``."""
    return prefix if f"{prefix}.alpha" in sd else f"{prefix}.act"


_N_RES_CONVS = 3  # (conv1, conv2) pairs of an AMP block


def vocoder_params_from_torch(sd, cfg, dtype: torch.dtype = torch.float32) -> dict:
    """An upstream BigVGAN generator ``state_dict`` -> the port's generator
    tree (weight norm folded, :func:`fold_weight_norm`), float32 unless
    ``dtype`` says otherwise.  Reads every layout the reference writes:
    ``weight_g`` / ``weight_v``, the parametrization, or a plain ``weight``;
    activations with or without the alias-free ``.act`` level, SnakeBeta or
    Snake (no ``beta``).  cfg: :class:`bvsc_tpu_torch.config.VocoderConfig`."""
    num_ups = len(cfg.upsample_rates)
    tree = {
        "conv_pre": _folded_conv(sd, "conv_pre"),
        "conv_post": _folded_conv(sd, "conv_post"),
        "ups": [_folded_conv(sd, f"ups.{i}.1") for i in range(num_ups)],
        "resblocks": [],
    }
    for r in range(num_ups * len(cfg.resblock_kernel_sizes)):
        pre = f"resblocks.{r}"
        tree["resblocks"].append({
            "convs1": [_folded_conv(sd, f"{pre}.convs1.{j}") for j in range(_N_RES_CONVS)],
            "convs2": [_folded_conv(sd, f"{pre}.convs2.{j}") for j in range(_N_RES_CONVS)],
            "acts": [_snake(sd, _act_prefix(sd, f"{pre}.activations.{j}"))
                     for j in range(2 * _N_RES_CONVS)],
        })
    tree["act_post"] = _snake(sd, _act_prefix(sd, "activation_post"))
    return to_torch(tree, dtype=dtype)


def vocoder_params_to_torch_sd(params) -> dict:
    """A generator tree -> the upstream BigVGAN ``state_dict``, numpy-valued:
    folded convs as ``weight``, weight-normed ones (``{g, v, b}``) as
    ``weight_g`` / ``weight_v``.  :func:`vocoder_params_from_torch` reads it
    back."""
    sd = {}

    def conv(prefix, p):
        if "g" in p:
            sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"] = _np(p["g"]), _np(p["v"])
        else:
            sd[f"{prefix}.weight"] = _np(p["w"])
        sd[f"{prefix}.bias"] = _np(p["b"])

    def snake(prefix, p):
        for k, t in p.items():
            sd[f"{prefix}.{k}"] = _np(t)

    conv("conv_pre", params["conv_pre"])
    for i, p in enumerate(params["ups"]):
        conv(f"ups.{i}.1", p)
    for r, block in enumerate(params["resblocks"]):
        for name in ("convs1", "convs2"):
            for j, p in enumerate(block[name]):
                conv(f"resblocks.{r}.{name}.{j}", p)
        for j, p in enumerate(block["acts"]):
            snake(f"resblocks.{r}.activations.{j}", p)
    snake("activation_post", params["act_post"])
    conv("conv_post", params["conv_post"])
    return sd


def _normed_conv(sd, prefix: str) -> dict:
    """A discriminator conv as the trainers hold it: weight-normed
    ``{g, v, b}``, or spectral-normed ``{w_orig, b, sn_u, sn_v}`` (torch's
    ``spectral_norm`` buffers ``weight_u`` / ``weight_v``)."""
    keys = _weight_norm_keys(sd, prefix)
    if keys:
        return {"g": _np(sd[keys[0]]), "v": _np(sd[keys[1]]), "b": _np(sd[f"{prefix}.bias"])}
    if f"{prefix}.weight_orig" in sd:
        return {"w_orig": _np(sd[f"{prefix}.weight_orig"]), "b": _np(sd[f"{prefix}.bias"]),
                "sn_u": _np(sd[f"{prefix}.weight_u"]), "sn_v": _np(sd[f"{prefix}.weight_v"])}
    raise KeyError(f"no weight-norm or spectral-norm parameters under {prefix}")


def _discriminators_from_torch(sd, n: int, dtype: torch.dtype) -> list:
    return to_torch([{"convs": [_normed_conv(sd, f"discriminators.{i}.convs.{j}")
                                for j in range(5)],
                      "conv_post": _normed_conv(sd, f"discriminators.{i}.conv_post")}
                     for i in range(n)], dtype=dtype)


def mpd_params_from_torch(sd, cfg, dtype: torch.dtype = torch.float32) -> list:
    """An upstream MultiPeriodDiscriminator ``state_dict`` -> the port's MPD
    tree (``models.discriminators``), weight norm kept."""
    return _discriminators_from_torch(sd, len(cfg.mpd_reshapes), dtype)


def mrd_params_from_torch(sd, cfg, dtype: torch.dtype = torch.float32) -> list:
    """An upstream MultiResolutionDiscriminator ``state_dict`` -> the port's
    MRD tree, weight norm or spectral norm kept."""
    return _discriminators_from_torch(sd, len(cfg.resolutions), dtype)


def load_torch_checkpoint(path: str) -> dict:
    """A ``torch.save`` file, read onto the CPU with ``weights_only=True``
    (the reference's ``torch.load``)."""
    return torch.load(path, map_location="cpu", weights_only=True)
