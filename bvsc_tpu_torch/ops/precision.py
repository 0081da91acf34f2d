"""The two precisions of the port's products (counterpart of the JAX
package's ``jax.lax.Precision`` knob).

* ``'highest'``: float32 operands and sums (reference-parity mode; the
  codec turns TF32 off, ``device.set_parity_mode``).
* ``'default'``: the TPU's single-pass semantics, under which the
  reference's fast-serving contracts were measured: both operands rounded
  to nearest-even bf16, the products summed in float32, a float32 result.

The bf16 products come from explicit casts, never from the process-wide
TF32 flags, so a parity model and a fast model can share a process.  A
bf16-rounded float32 value is exact in TF32, but cuDNN's TF32 algorithms
sum in another order than its float32 ones, so the port's float32
convolutions run under :func:`cudnn_fp32`, which turns cuDNN's TF32 off for
the call whatever the process's flag says (``ops.conv``).
"""

from __future__ import annotations

import contextlib

import torch


def resolve(precision: str) -> str:
    """The reference's rule: ``'highest'`` is parity, anything else is
    ``'default'``."""
    return "highest" if precision == "highest" else "default"


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Float32 tensor rounded to nearest-even bf16, kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` at ``precision``; ``x`` float32 (..., k), ``w`` (k, n) of
    any float or integer type whose values the precision's type holds
    exactly (float32 at ``'highest'``; bf16, or int8, at ``'default'``).

    ``'default'`` on CUDA is one cuBLAS bf16 GEMM with a float32 output;
    on the CPU, which has no such kernel, it is the float32 product of the
    bf16-rounded operands, which is also its oracle."""
    if precision == "highest":
        # no cast of float32 weights: it would be a traced program's node
        return torch.matmul(x, w if w.dtype == torch.float32 else w.to(torch.float32))
    wb = w if w.dtype == torch.bfloat16 else w.to(torch.bfloat16)
    if x.device.type == "cuda":
        y = torch.mm(x.reshape(-1, x.shape[-1]).to(torch.bfloat16), wb, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(round_bf16(x), wb.to(torch.float32))


@contextlib.contextmanager
def cudnn_fp32():
    """cuDNN's float32 convolutions in float32 inside the block, TF32 off,
    the process's flag restored after it.  The flag is process-wide, so a
    thread that convolves at the same time sees it off too."""
    on = torch.backends.cudnn.allow_tf32
    if on:
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        if on:
            torch.backends.cudnn.allow_tf32 = True
