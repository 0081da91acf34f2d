"""Device selection and the float32 parity settings of the port.

Entry points run on CUDA unless the caller asks for the CPU: with no card
and no ``device="cpu"`` they raise instead of dropping quietly to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the first CUDA card; raises when it is not there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_parity_mode() -> None:
    """Full float32 matmuls and convolutions (reference-parity mode).

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits and shows as ~1e-3 gaps between the CUDA kernels
    and their plain versions.  Both flags are process-wide; the codec sets
    them when it is built with ``precision='highest'``.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def canonical(device) -> torch.device:
    """``device`` with its index: a bare ``'cuda'`` is the current card, so
    that two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
