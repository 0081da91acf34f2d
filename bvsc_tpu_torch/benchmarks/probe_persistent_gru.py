"""Single-stream GRU floor on one CUDA card: is one persistent kernel that
keeps the GRU weights on chip faster than a loop of per-step launches?

Port of ``benchmarks/probe_persistent_gru.py`` with the same shapes, seed
and variants.  The GRU is the decode cell's largest part: GRU(2H -> H) at
H = 1024, whose input x_t = [h_t | xconst] feeds h back, so the x product
cannot be hoisted out of the loop.

Variants (A-C at batch 1, D-E at the kernel's 8 rows):
  A. torch scan, float32 weights and products         (the parity path)
  B. torch scan, bf16 products with float32 sums      (the serving default)
  C. torch scan, int8 weights widened to bf16, scaled (the int8 path)
  D. persistent kernel, bf16 weights in shared memory
  E. persistent kernel, int8 weights in shared memory, widened with no
     scale (as the JAX probe's E: its weights are the raw integers)

    python -m bvsc_tpu_torch.benchmarks.probe_persistent_gru
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bvsc_tpu_torch.benchmarks import cuda_ms
from bvsc_tpu_torch.device import resolve_device, set_parity_mode
from bvsc_tpu_torch.ops import persistent_gru as PG

H = 1024  # h_dim (configs/varbitrate.toml)
T = 512  # frames per timed call (~5.9 s of audio at 86 fps)
LANES = PG.LANES
SEED = 0
CALLS = 10  # timed calls per variant, after one warm-up


def make_inputs(seed: int = SEED) -> dict[str, np.ndarray]:
    """The probe's weights and state, drawn in the JAX probe's order."""
    rng = np.random.default_rng(seed)
    return {
        "w_ih": (rng.standard_normal((2 * H, 3 * H)) * 0.02).astype(np.float32),
        "w_hh": (rng.standard_normal((H, 3 * H)) * 0.02).astype(np.float32),
        "b_ih": (rng.standard_normal((1, 3 * H)) * 0.01).astype(np.float32),
        "b_hh": (rng.standard_normal((1, 3 * H)) * 0.01).astype(np.float32),
        "xc": (rng.standard_normal((LANES, H)) * 0.5).astype(np.float32),
        "h0": rng.standard_normal((LANES, H)).astype(np.float32),
    }


def variants(device: torch.device, seed: int = SEED) -> dict:
    """The five variants as zero-argument callables on ``device``."""
    inputs = make_inputs(seed)
    a = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    wi_q, wi_s = (t.to(device) for t in PG.quantize(inputs["w_ih"]))
    wh_q, wh_s = (t.to(device) for t in PG.quantize(inputs["w_hh"]))
    wi_b, wh_b = a["w_ih"].to(torch.bfloat16), a["w_hh"].to(torch.bfloat16)
    one = (a["b_ih"], a["b_hh"], a["xc"][:1], a["h0"][:1])
    full = (a["b_ih"], a["b_hh"], a["xc"], a["h0"])
    return {
        "A_scan_f32": functools.partial(PG.scan, a["w_ih"], a["w_hh"], *one, T, torch.float32),
        "B_scan_bf16dot": functools.partial(PG.scan, a["w_ih"], a["w_hh"], *one, T, torch.bfloat16),
        "C_scan_int8": functools.partial(PG.scan_int8, wi_q, wi_s, wh_q, wh_s, *one, T),
        "D_persistent_bf16": functools.partial(PG.persistent_gru, wi_b, wh_b, *full, T),
        "E_persistent_int8": functools.partial(PG.persistent_gru, wi_q, wh_q, *full, T,
                                               dequant=True),
    }


def run(device=None) -> dict[str, float]:
    """Milliseconds per call of ``T`` steps for each variant, on the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe times the card; it does not run on the CPU")
    set_parity_mode()
    return {name: cuda_ms(fn, reps=CALLS, warmup=1) for name, fn in variants(dev).items()}


def main() -> None:
    print("device:", torch.cuda.get_device_name(0) if torch.cuda.is_available() else "none",
          flush=True)
    results = run()
    for name, ms in results.items():
        print(f"{name}: {ms:8.2f} ms for {T} steps -> {T / ms * 1e3:8.0f} steps/s", flush=True)
    base = results["B_scan_bf16dot"]
    for name, ms in results.items():
        print(f"{name}: {base / ms:5.2f}x vs B", flush=True)


if __name__ == "__main__":
    main()
