"""1-D and 2-D convolutions with the torch weight layouts the JAX package keeps.

Port of ``bvsc_tpu/ops/conv.py``: Conv1d and Conv2d weights are (out, in,
k...) and ConvTranspose1d weights are (in, out, k), so parameters cross
between the two packages unchanged.  1-D padding is explicit (left-only for
causality); the 1-D convolutions themselves take no padding.

A conv's parameters come in three forms, resolved by :func:`conv_weight`
on every call, so that a gradient reaches the leaves the form holds:

* inference ``{'w', 'b'}`` (``convert`` folds weight norm on loading);
* weight-normed ``{'g', 'v', 'b'}`` (torch ``weight_norm``, dim 0), the
  trainers' generator and discriminators;
* spectral-normed ``{'w_orig', 'b', 'sn_u', 'sn_v'}`` (torch
  ``spectral_norm``): ``w_orig`` over sigma = u . (W v) from the two
  power-iteration buffers, which are constants of the forward; the trainer
  moves them with :func:`spectral_norm_power_iteration` once per
  discriminator step, and no optimizer touches them
  (:func:`spectral_norm_trainable_mask`).

``precision='default'`` rounds both operands to bf16 and keeps a float32
output (``ops.precision``); the bias is added in float32.  Float32 convs
on a card run with cuDNN's TF32 off for the call
(``ops.precision.cudnn_fp32``), so their sums do not depend on the
process's flag.  A bf16 input
(the direct vocoder's bf16 segment, the bf16 storage dtype) convolves bf16
operands into a bf16 output, then adds the bias in bf16 (a second
rounding), as the JAX package's bf16 convs do.  The inits draw
from a numpy ``Generator`` (the JAX package's draw from ``jax.random``, so
the two inits agree in distribution, not in value).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from bvsc_tpu_torch.ops.precision import cudnn_fp32, round_bf16

SN_EPS = 1e-12  # torch.nn.functional.normalize's eps
SN_BUFFERS = ("sn_u", "sn_v")


def _operands(x: torch.Tensor, w: torch.Tensor, precision: str):
    if x.dtype == torch.bfloat16:  # a bf16 segment: bf16 operands at either precision
        return x, w.to(torch.bfloat16)
    if precision == "highest":
        return x, w
    return round_bf16(x), round_bf16(w)


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g * v / ||v||, norm over all dims except dim 0 (torch dim=0)."""
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))
    return g * v / norm


def conv_weight(p: dict) -> torch.Tensor:
    """The conv weight of a folded, weight-normed or spectral-normed
    parameter dict."""
    if "w" in p:
        return p["w"]
    if "w_orig" in p:
        return spectral_norm_weight(p)
    return fold_weight_norm(p["g"], p["v"])


# ---------------------------------------------------------------------------
# Spectral normalisation (torch.nn.utils.spectral_norm semantics)
# ---------------------------------------------------------------------------


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=SN_EPS)


def spectral_norm_weight(p: dict) -> torch.Tensor:
    """``w_orig / sigma``, sigma = u . (W_mat v) from the stored buffers,
    which take no gradient (torch's eval-mode ``compute_weight``)."""
    w = p["w_orig"]
    w_mat = w.reshape(w.shape[0], -1)
    sigma = p["sn_u"].detach() @ (w_mat @ p["sn_v"].detach())
    return w / sigma


def _power_iterate_one(p: dict, n_iterations: int) -> dict:
    w_mat = p["w_orig"].detach().reshape(p["w_orig"].shape[0], -1)
    u, v = p["sn_u"], p["sn_v"]
    with torch.no_grad():
        for _ in range(n_iterations):
            v = _l2_normalize(w_mat.T @ u)
            u = _l2_normalize(w_mat @ v)
    return {**p, "sn_u": u, "sn_v": v}


def spectral_norm_power_iteration(tree, n_iterations: int = 1):
    """``tree`` with one torch-style power-iteration update of the (u, v)
    buffers of every spectral-normed conv (dicts holding ``'w_orig'``);
    other leaves are the same tensors."""
    if isinstance(tree, dict):
        if "w_orig" in tree:
            return _power_iterate_one(tree, n_iterations)
        return {k: spectral_norm_power_iteration(v, n_iterations) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(spectral_norm_power_iteration(v, n_iterations) for v in tree)
    return tree


def tree_has_spectral_norm(tree) -> bool:
    """Whether any conv of ``tree`` is spectral-normed (holds ``'w_orig'``)."""
    if isinstance(tree, dict):
        return "w_orig" in tree or any(tree_has_spectral_norm(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(tree_has_spectral_norm(v) for v in tree)
    return False


def spectral_norm_trainable_mask(tree):
    """A tree of bools shaped like ``tree``: False on the ``sn_u`` / ``sn_v``
    buffers (torch buffers, not parameters), True on every other leaf."""
    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        return key not in SN_BUFFERS

    return walk(tree, None)


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


def pad1d(x: torch.Tensor, left: int, right: int = 0) -> torch.Tensor:
    """Zero (left, right) padding on the time axis of (B, C, T)."""
    if left == 0 and right == 0:
        return x
    return F.pad(x, (left, right))


def _fp32(x: torch.Tensor):
    """:func:`ops.precision.cudnn_fp32` for a float32 CUDA input: its sums
    do not depend on the process's TF32 flag."""
    if x.dtype == torch.float32 and x.device.type == "cuda":
        return cudnn_fp32()
    return contextlib.nullcontext()


def _bias_after(y: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return y if b is None else y + b.to(y.dtype)[:, None]


def conv1d(x: torch.Tensor, p: dict, *, stride: int = 1, dilation: int = 1,
           precision: str = "highest") -> torch.Tensor:
    """``F.conv1d`` with padding 0: (B, C_in, T) -> (B, C_out, T')."""
    x, w = _operands(x, conv_weight(p), precision)
    if x.dtype == torch.bfloat16:
        return _bias_after(F.conv1d(x, w, stride=stride, dilation=dilation), p.get("b"))
    with _fp32(x):
        return F.conv1d(x, w, p.get("b"), stride=stride, dilation=dilation)


def conv_transpose1d(x: torch.Tensor, p: dict, *, stride: int,
                     precision: str = "highest") -> torch.Tensor:
    """``F.conv_transpose1d`` with padding 0 on the (in, out, k) weight;
    output length (T - 1) * stride + k."""
    x, w = _operands(x, conv_weight(p), precision)
    if x.dtype == torch.bfloat16:
        return _bias_after(F.conv_transpose1d(x, w, stride=stride), p.get("b"))
    with _fp32(x):
        return F.conv_transpose1d(x, w, p.get("b"), stride=stride)


def conv2d(x: torch.Tensor, p: dict, *, stride: tuple[int, int] = (1, 1),
           padding: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``F.conv2d`` with symmetric (ph, pw) zero padding, float32:
    (B, C_in, H, W) -> (B, C_out, H', W')."""
    return F.conv2d(x, conv_weight(p), p.get("b"), stride=stride, padding=padding)


# ---------------------------------------------------------------------------
# Inits (numpy Generator, float32 arrays)
# ---------------------------------------------------------------------------


def _weight_norm_form(w: np.ndarray, b: np.ndarray) -> dict:
    """torch ``weight_norm``'s init from existing weights: g = ||w|| per
    output channel, v = w, so folding gives w back."""
    g = np.sqrt(np.sum(w.astype(np.float64) ** 2, axis=tuple(range(1, w.ndim)), keepdims=True))
    return {"g": g.astype(np.float32), "v": w, "b": b}


def init_conv_params(rng: np.random.Generator, out_ch: int, in_ch: int, kernel: int, *,
                     transpose: bool = False, weight_norm: bool = False,
                     init_std: float = 0.01) -> dict:
    """N(0, init_std) conv weights (the reference's ``init_weights``) and
    torch's U(-1/sqrt(fan_in), .) bias, fan_in = weight.shape[1] * k;
    weight-normed ``{'g', 'v', 'b'}`` with ``weight_norm``."""
    shape = (in_ch, out_ch, kernel) if transpose else (out_ch, in_ch, kernel)
    w = (init_std * rng.standard_normal(shape)).astype(np.float32)
    bound = 1.0 / np.sqrt((out_ch if transpose else in_ch) * kernel)
    b = rng.uniform(-bound, bound, (out_ch,)).astype(np.float32)
    return _weight_norm_form(w, b) if weight_norm else {"w": w, "b": b}


def init_conv2d_params(rng: np.random.Generator, out_ch: int, in_ch: int,
                       kernel: tuple[int, int], *, weight_norm: bool = False,
                       spectral_norm: bool = False) -> dict:
    """torch Conv2d's default init, U(-1/sqrt(fan_in), .) for weight and
    bias; weight-normed ``{'g', 'v', 'b'}``, or spectral-normed with
    normalised N(0, 1) ``sn_u`` (out,) and ``sn_v`` (in * kh * kw,), as
    torch's ``spectral_norm`` starts them."""
    fan_in = in_ch * kernel[0] * kernel[1]
    bound = 1.0 / np.sqrt(fan_in)
    w = rng.uniform(-bound, bound, (out_ch, in_ch, *kernel)).astype(np.float32)
    b = rng.uniform(-bound, bound, (out_ch,)).astype(np.float32)
    if spectral_norm:
        u = rng.standard_normal(out_ch)
        v = rng.standard_normal(fan_in)
        return {"w_orig": w, "b": b,
                "sn_u": (u / max(np.linalg.norm(u), SN_EPS)).astype(np.float32),
                "sn_v": (v / max(np.linalg.norm(v), SN_EPS)).astype(np.float32)}
    return _weight_norm_form(w, b) if weight_norm else {"w": w, "b": b}
