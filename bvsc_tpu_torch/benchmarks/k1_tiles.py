"""K1 float32 (``csrc/amp_resblock.cu``) at both of its tiles, on one card.

``tile_for`` gives each stage 8192 / C output samples per thread block and
halves that where the grid would leave SMs without a block.  At each stage
of a 65 536-sample call (the main path's shapes) for B = 1 and B = 4, on a
seeded full-width vocoder and seeded inputs, this launches the stage (3
resblocks and their average) at both tiles, holds each against the plain
float32 stack (TF32 off) and times it with CUDA events beside the plain
stack.  Then the registers, stack and local (spill) bytes of every
instantiation of the build, from ``cuobjdump --dump-resource-usage``.

    python -m bvsc_tpu_torch.benchmarks.k1_tiles

Prints one JSON line per (B, stage), then one per instantiation.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess

import torch

from bvsc_tpu_torch.benchmarks import cuda_ms, seeded_vocoder
from bvsc_tpu_torch.codec import DEFAULT_CONFIG
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.convert import to_torch
from bvsc_tpu_torch.device import resolve_device, set_parity_mode
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.ops import amp_resblock as AR

SEED = 0
TOL = 1e-4  # as chip_smoke.KERNEL_TOL: float32 sums in another order
# Samples of each vocoder stage's input in a 65 536-sample (256-frame) call,
# as chip_smoke.py's phase main_path records them.
STAGE_T = (2056, 16456, 32914, 65830)
BATCHES = (1, 4)


def resources(path: str) -> list[dict]:
    """Registers, stack and local bytes per kernel instantiation (C, k)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "--dump-resource-usage", path], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    found = re.findall(r"Function (\S+):\s*\n\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", text)
    rows = []
    for name, reg, stack, local in found:
        shape = re.search(r"ILi(\d+)ELi(\d+)E", name)
        rows.append({"C": int(shape[1]) if shape else None, "k": int(shape[2]) if shape else None,
                     "registers": int(reg), "stack_bytes": int(stack), "local_bytes": int(local)})
    return sorted(rows, key=lambda r: (r["C"] or 0, r["k"] or 0))


def run() -> None:
    dev = resolve_device(None)
    if dev.type != "cuda":
        raise RuntimeError("k1_tiles measures the CUDA kernel and needs a card")
    set_parity_mode()
    vcfg = load_config(DEFAULT_CONFIG).vocoder_config
    stages = voc_mod.prepare_kernel_params(to_torch(seeded_vocoder(vcfg, SEED), dev), vcfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for B in BATCHES:
        for stage, (blocks, T) in enumerate(zip(stages, STAGE_T)):
            C = blocks[0].channels
            x = 0.3 * torch.randn(B, C, T, device=dev, generator=gen)
            ref = AR.amp_stack_plain(x, blocks)
            line = {"B": B, "stage": stage, "shape": [B, C, T], "rule_tile": AR.launch_tile(x),
                    "plain_ms": cuda_ms(lambda: AR.amp_stack_plain(x, blocks))}
            full = AR.tile_for(C)
            for tile in (full, full // 2):
                def stack():
                    return AR.average([AR.amp_resblock(x, rb, tile=tile) for rb in blocks])
                err = (stack() - ref).abs().max().item()
                if not err <= TOL:
                    raise AssertionError(f"B={B} stage {stage} tile {tile}: {err} > {TOL}")
                line[f"tile_{tile}"] = {"blocks": B * -(-T // tile), "ms": cuda_ms(stack),
                                        "max_abs_err": err}
            print(json.dumps(line), flush=True)
    for row in resources(_build.library_path("amp_resblock")):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    run()
