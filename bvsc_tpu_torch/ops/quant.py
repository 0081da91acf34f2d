"""Weight-only int8 BVRNN weights (port of ``bvsc_tpu/ops/quant.py``).

Scheme: per output channel, ``s[o] = max_i |w[i, o]| / 127`` (at least
1e-12) and ``q[i, o] = round(w[i, o] / s[o])`` clipped to [-127, 127], as
int8.  Applied as ``(x @ q) * s + b``.

Mixed mode keeps the code-critical ``enc`` and ``phi_x`` stacks as bf16
instead (the reference measured 99.945 % code agreement against 99.843 %
all-int8 on real speech, on a TPU).

The int8 values are exact in bf16 and in float32, so the product at either
precision is the float product of the widened values times the scale.
Under the bf16 storage dtype the activations are bf16: ``q`` and ``scale``
are cast to bf16 and the product is bf16 (``ops.precision.matmul_bf16``),
as the reference casts both to the activation's type; quantising
bf16-stored weights keeps a float32 ``scale`` (of bf16-rounded values).  The
codec widens ``q`` once, when it builds the scan's parameters
(``models.bvrnn.prepare``), so the card holds the widened copy: this mode
reproduces the reference's numbers, not its int8 memory traffic.
"""

from __future__ import annotations

import torch

from bvsc_tpu_torch.ops.precision import matmul, matmul_bf16


def quantize_dense(w: torch.Tensor) -> dict:
    """(in, out) float32 or bf16 -> {'q': int8 (in, out), 'scale': float32
    (out,)}; bf16 weights are scaled and rounded in bf16, as the reference
    does."""
    s = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "scale": s.to(torch.float32)}


def dequant_matmul(x: torch.Tensor, p: dict, precision: str = "highest") -> torch.Tensor:
    """``(x @ q) * scale``, the product at ``precision``; a bf16 ``x`` takes
    ``q`` and ``scale`` in bf16 and gives a bf16 result."""
    if x.dtype == torch.bfloat16:
        return matmul_bf16(x, p["q"].to(torch.bfloat16)) * p["scale"].to(torch.bfloat16)
    return matmul(x, p["q"], precision) * p["scale"]


def is_quantized(p) -> bool:
    return isinstance(p, dict) and "q" in p and "scale" in p


def quantize_bvrnn_params(params: dict, keep_bf16: tuple = ()) -> dict:
    """Quantize every dense and GRU weight matrix of a BVRNN tree (biases,
    mel statistics and log_sigma stay float32); the stacks named in
    ``keep_bf16`` are stored as bf16 instead."""
    gru = params["gru"]
    out = {
        "mean_mel": params["mean_mel"],
        "std_mel": params["std_mel"],
        "log_sigma": params["log_sigma"],
        "gru": {
            "w_ih": quantize_dense(gru["w_ih"]),
            "w_hh": quantize_dense(gru["w_hh"]),
            "b_ih": gru["b_ih"],
            "b_hh": gru["b_hh"],
        },
    }
    for name in ("phi_x", "phi_z", "enc", "prior", "dec"):
        keep = name in keep_bf16
        out[name] = [
            {"w": layer["w"].to(torch.bfloat16) if keep else quantize_dense(layer["w"]),
             "b": layer["b"]}
            for layer in params[name]
        ]
    return out


def quantize_bvrnn_params_mixed(params: dict) -> dict:
    """int8 everywhere except the ``enc`` and ``phi_x`` stacks (bf16)."""
    return quantize_bvrnn_params(params, keep_bf16=("enc", "phi_x"))
