"""K1 (``csrc/amp_resblock.cu``, float32) and K1-bf16
(``csrc/amp_resblock_bf16.cu``) at their candidate tiles, on one card.

``tile_for`` gives each stage 8192 / C output samples per thread block;
float32 halves that once where the grid would leave SMs without a block,
bf16 halves it while the halved grid still fits in one wave.  At each stage
of a 65 536-sample call (the main path's shapes) for B = 1 and B = 4, on a
seeded full-width vocoder and seeded inputs, this launches the stage (3
resblocks and their average) in each mode at the full tile, half of it and
the tile ``tile_for`` takes there, holds each against the mode's plain stack
(float32 with TF32 off, or bf16 operands) and times it with CUDA events
beside the plain stack: ``ms`` per call as the caller sees it, host
launches included, and ``device_ms`` from replays of a CUDA graph of 20
calls, the device's time alone.  Then, per instantiation of both builds, the
registers, stack and local (spill) bytes from ``cuobjdump
--dump-resource-usage``, and the float32 instructions of one snake in the
bf16 build's SASS (:func:`snake_instructions`).

    python -m bvsc_tpu_torch.benchmarks.k1_tiles

Prints one JSON line per (mode, B, stage), then one per instantiation, then
the snake's count.
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess

import torch

from bvsc_tpu_torch.benchmarks import cuda_ms, graph_ms, seeded_vocoder
from bvsc_tpu_torch.codec import DEFAULT_CONFIG
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.convert import to_torch
from bvsc_tpu_torch.device import resolve_device, set_parity_mode
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.ops import amp_resblock as AR

SEED = 0
# As chip_smoke.KERNEL_TOL and BF16_KERNEL_TOL: float32 sums in another
# order; in bf16 also the operand roundings they can flip.
TOLS = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
LIBRARIES = {torch.float32: "amp_resblock", torch.bfloat16: "amp_resblock_bf16"}
# Samples of each vocoder stage's input in a 65 536-sample (256-frame) call,
# as chip_smoke.py's phase main_path records them.
STAGE_T = (2056, 16456, 32914, 65830)
BATCHES = (1, 4)
# SASS opcodes that issue to the float32 pipe (FMA, add, multiply, compare,
# select, min/max, rounding); their IMM forms end in 32I.
FP32_OPS = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FRND", "FCHK", "FSWZADD"}


def _cuobjdump() -> str:
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def resources(path: str) -> list[dict]:
    """Registers, stack and local bytes per kernel instantiation (C, k)."""
    text = subprocess.run([_cuobjdump(), "--dump-resource-usage", path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    found = re.findall(r"Function (\S+):\s*\n\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", text)
    rows = []
    for name, reg, stack, local in found:
        shape = re.search(r"ILi(\d+)ELi(\d+)E", name)
        rows.append({"function": name, "C": int(shape[1]) if shape else None,
                     "k": int(shape[2]) if shape else None, "registers": int(reg),
                     "stack_bytes": int(stack), "local_bytes": int(local)})
    return sorted(rows, key=lambda r: (r["C"] or 0, r["k"] or 0))


def _function_sass(path: str, function: str) -> str:
    return subprocess.run([_cuobjdump(), "-sass", "-fun", function, path], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def fast_path_ops(sass: str) -> tuple[collections.Counter, collections.Counter]:
    """Opcodes (without modifiers) on the fast path of one function's SASS,
    and those left off it.  The fast path runs from the first instruction
    to the first EXIT, minus every region that a conditional forward branch
    jumps over when that region holds a loop (a backward branch): sinf's
    Payne-Hanek reduction for |x| >= 105615, which no argument here
    reaches."""
    code = [(int(m[1], 16), m[2].strip()) for m in
            re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    exit_at = next(a for a, ins in code if re.match(r"(@!?U?P\w+\s+)?EXIT\b", ins))
    code = [(a, ins) for a, ins in code if a <= exit_at]
    branches = [(a, ins.startswith("@"), int(m[1], 16)) for a, ins in code
                if (m := re.search(r"\bBRA\s+(?:`\()?(?:0x)?([0-9a-f]+)", ins))]
    skipped = set()
    for at, conditional, target in branches:
        if conditional and target > at and any(at < a < target and t <= a
                                                for a, _, t in branches):
            skipped |= {a for a, _ in code if at < a < target}
    on, off = collections.Counter(), collections.Counter()
    for a, ins in code:
        op = (ins.split()[1] if ins.startswith("@") else ins.split()[0]).split(".")[0]
        (off if a in skipped else on)[op] += 1
    return on, off


def _fp32(ops: collections.Counter) -> dict:
    return {op: n for op, n in sorted(ops.items()) if re.sub(r"32I$", "", op) in FP32_OPS}


def snake_instructions(path: str | None = None) -> dict:
    """The instructions of one snake evaluation on its fast path, counted
    in the SASS of ``snake_sass_probe`` (one snake per thread, beside the
    kernel in the bf16 build): the float32-pipe ones (``fp32``, the unit of
    the snake floor) and all of them, with the thread's indexing, load and
    store (``issued``)."""
    path = path or _build.library_path(LIBRARIES[torch.bfloat16])
    on, off = fast_path_ops(_function_sass(path, "snake_sass_probe"))
    fp32 = _fp32(on)
    return {"function": "snake_sass_probe", "fp32": sum(fp32.values()), "fp32_by_opcode": fp32,
            "issued": sum(on.values()), "slow_path_fp32": _fp32(off)}


def stage_line(mode: torch.dtype, B: int, stage: int, blocks, x: torch.Tensor) -> dict:
    """One stage in one mode at its candidate tiles, checked and timed."""
    C, T = x.shape[1], x.shape[2]
    ref = AR.amp_stack_plain(x, blocks, mode)
    rule = AR.launch_tile(x, mode)
    full = AR.tile_for(C, mode)
    line = {"mode": str(mode).removeprefix("torch."), "B": B, "stage": stage, "shape": [B, C, T],
            "rule_tile": rule, "plain_ms": cuda_ms(lambda: AR.amp_stack_plain(x, blocks, mode))}
    for tile in sorted({full, full // 2, rule}, reverse=True):
        def stack():
            return AR.average([AR.amp_resblock(x, rb, mode, tile=tile) for rb in blocks])
        err = (stack() - ref).abs().max().item()
        if not err <= TOLS[mode]:
            raise AssertionError(f"{mode} B={B} stage {stage} tile {tile}: {err} > {TOLS[mode]}")
        line[f"tile_{tile}"] = {"blocks": B * -(-T // tile), "ms": cuda_ms(stack),
                                "device_ms": graph_ms(stack), "max_abs_err": err}
    return line


def run() -> None:
    dev = resolve_device(None)
    if dev.type != "cuda":
        raise RuntimeError("k1_tiles measures the CUDA kernels and needs a card")
    set_parity_mode()
    _build.load_all()
    vcfg = load_config(DEFAULT_CONFIG).vocoder_config
    stages = voc_mod.prepare_kernel_params(to_torch(seeded_vocoder(vcfg, SEED), dev), vcfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for mode in (torch.bfloat16, torch.float32):
        for B in BATCHES:
            for stage, (blocks, T) in enumerate(zip(stages, STAGE_T)):
                x = 0.3 * torch.randn(B, blocks[0].channels, T, device=dev, generator=gen)
                print(json.dumps(stage_line(mode, B, stage, blocks, x)), flush=True)
    for mode, name in LIBRARIES.items():
        for row in resources(_build.library_path(name)):
            print(json.dumps({"library": name, **row}), flush=True)
    print(json.dumps({"snake": snake_instructions()}), flush=True)


if __name__ == "__main__":
    run()
