"""The two precisions of the port's products (counterpart of the JAX
package's ``jax.lax.Precision`` knob).

* ``'highest'``: float32 operands and sums (reference-parity mode; the
  codec turns TF32 off, ``device.set_parity_mode``).
* ``'default'``: the TPU's single-pass semantics, under which the
  reference's fast-serving contracts were measured: both operands rounded
  to nearest-even bf16, the products summed in float32, a float32 result.

Under the bf16 storage dtype every operand is already bf16 and every
product is :func:`matmul_bf16`: float32 sums rounded once to a bf16
result, as ``jnp.matmul`` of two bf16 arrays gives, at either precision.

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


def matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of bf16 ``x`` (..., k) and ``w`` (k, n) (int8 widened by the
    caller): float32 sums, rounded once to a bf16 result.  On CUDA it is
    one cuBLAS bf16 GEMM with a float32 output, so cuBLAS's reduced-precision
    reduction (``allow_bf16_reduced_precision_reduction``, a process-wide
    flag that is on by default) never applies; on the CPU the float32
    product of the widened operands, exact products summed in float32.
    Operands that take a gradient (the bf16 training forward) keep
    ``torch.matmul``'s bf16 product."""
    if x.requires_grad or w.requires_grad:
        return torch.matmul(x, w)
    if x.device.type == "cuda":
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.to(torch.bfloat16).reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(torch.bfloat16)


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
