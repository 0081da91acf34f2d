"""1-D convolutions with the torch weight layouts the JAX package keeps.

Port of ``bvsc_tpu/ops/conv.py``: Conv1d weights are (out, in, k) and
ConvTranspose1d weights are (in, out, k), so parameters cross between the
two packages unchanged.  Padding is explicit (left-only for causality);
the convolutions themselves take no padding.  Parameters are inference
params ``{'w', 'b'}``: ``convert`` folds weight-normed ``{'g', 'v'}`` on
loading.  ``precision='default'`` rounds both operands to bf16 and keeps a
float32 output (``ops.precision``); the bias is added in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bvsc_tpu_torch.ops.precision import round_bf16


def _operands(x: torch.Tensor, w: torch.Tensor, precision: str):
    if precision == "highest":
        return x, w
    return round_bf16(x), round_bf16(w)


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g * v / ||v||, norm over all dims except dim 0 (torch dim=0)."""
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))
    return g * v / norm


def pad1d(x: torch.Tensor, left: int, right: int = 0) -> torch.Tensor:
    """Zero (left, right) padding on the time axis of (B, C, T)."""
    if left == 0 and right == 0:
        return x
    return F.pad(x, (left, right))


def conv1d(x: torch.Tensor, p: dict, *, stride: int = 1, dilation: int = 1,
           precision: str = "highest") -> torch.Tensor:
    """``F.conv1d`` with padding 0: (B, C_in, T) -> (B, C_out, T')."""
    x, w = _operands(x, p["w"], precision)
    return F.conv1d(x, w, p.get("b"), stride=stride, dilation=dilation)


def conv_transpose1d(x: torch.Tensor, p: dict, *, stride: int,
                     precision: str = "highest") -> torch.Tensor:
    """``F.conv_transpose1d`` with padding 0 on the (in, out, k) weight;
    output length (T - 1) * stride + k."""
    x, w = _operands(x, p["w"], precision)
    return F.conv_transpose1d(x, w, p.get("b"), stride=stride)
