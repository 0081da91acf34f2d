"""The comparison that decides ``correct``: the program's outputs against
the plain reference (:mod:`portbench.reference.bvrnn_codec`).

Numbers compared (each held to a limit in ``portbench/limits/<cell>.json``):

* ``code_gap``: the reference, judging the program's codes (its state
  advanced with them), computes each frame's encoder probabilities from the
  same history; a transmitted bit's gap is how far the reference's
  probability lies on the other side of 0.5 from the program's code (0 where
  they agree).  A bit outside the frame's allocation must be exactly 0.5, and
  a transmitted bit exactly 0 or 1; either fault reads 1.  The widest gap.
* ``code_gap_mean``: the gaps' mean over the transmitted bits.  Where two
  sound implementations differ by their arithmetic's noise (bf16 rounding
  turns the last bits of two correct sums into a dense ulp-sized noise a few
  layers deep), the widest gap grows with that noise and the mean with its
  square (both how many bits cross 0.5 and how far grow with it), so the
  mean tells a coarser arithmetic from the sound one by more;
* ``code_flips``: how many transmitted bits have a gap over
  :data:`FLIP_GAP`, above what sound bf16 sums reach: a code turned over
  where the reference decides with a margin counts once, however many bits
  the mean is taken over;
* ``wave_err``: the widest difference of the program's waveform from the
  reference's (decoded from the same codes, or concealed from the same
  losses), over the largest magnitude of the reference's waveforms.

Items are the answers checked (rows of a call, or whole streams), run in
blocks of rows padded to the block's longest, frames past an item's own
marked invalid (causal: they change nothing before them).
"""

from __future__ import annotations

import torch

from portbench.reference import bvrnn_codec as R

BLOCK = 8  # items the reference runs at once
FLIP_GAP = 0.05  # a gap counted by ``code_flips``


def gaps(probs: torch.Tensor, codes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each bit's gap (module docstring) over (..., z) tensors."""
    on = mask > 0
    binary = (codes == 0) | (codes == 1)
    fault = (on & ~binary) | (~on & (codes != 0.5))
    side = torch.where(codes == 1, 0.5 - probs, probs - 0.5)
    gap = torch.where(on & binary, torch.clamp(side, min=0), torch.zeros_like(probs))
    return torch.where(fault, torch.ones_like(gap), gap)


def code_gap(probs: torch.Tensor, codes: torch.Tensor, mask: torch.Tensor) -> float:
    """The widest gap over (..., z) tensors."""
    gap = gaps(probs, codes, mask)
    return float(gap.max()) if gap.numel() else 0.0


class Judge:
    """Runs the reference over checked items and keeps the numbers."""

    def __init__(self, conf: dict, bvrnn: dict, voc: dict, device):
        """The reference runs in the configuration's ``reference_arith`` (the
        operand type of 'mel', 'bvrnn' and 'vocoder')."""
        self.conf, self.p, self.v = conf["codec"], bvrnn, voc
        self.arith = conf["reference_arith"]
        self.device = device
        self.frontend = R.Frontend(self.conf, device)
        self.hop = self.conf["hopsize"]
        self.z = self.conf["z_dim"]
        self.gap = 0.0
        self.gap_sum = 0.0
        self.flips = 0
        self.bits = 0
        self.err = 0.0
        self.ref_peak = 0.0
        self.items = 0

    def numbers(self) -> dict:
        out = {"wave_err": self.err / max(self.ref_peak, 1e-30)}
        if self.gap is not None:
            out["code_gap"] = self.gap
            out["code_gap_mean"] = self.gap_sum / max(self.bits, 1)
            out["code_flips"] = self.flips
        return out

    def _mask(self, bits: list, valid: list, T: int) -> torch.Tensor:
        """(rows, T, z) allocation: the first ``bits`` bits of a row's
        frames before its ``valid`` (every bit where the configuration has
        no variable bitrate)."""
        if not self.conf["var_bit"]:
            bits = [self.z] * len(bits)
        rows = []
        for b, n in zip(bits, valid):
            m = R.bit_mask(torch.full((T,), float(b), device=self.device), self.z)
            m[n:] = 0
            rows.append(m)
        return torch.stack(rows)

    def _wave(self, dec: torch.Tensor, ys: list) -> None:
        wav = R.vocoder(self.v, self.conf["vocoder_config"], dec.transpose(1, 2),
                        dec.shape[1] * self.hop, self.arith["vocoder"])
        for row, y in zip(wav, ys):
            y = torch.as_tensor(y, dtype=torch.float32, device=self.device).reshape(-1)
            ref = row[: y.shape[0]]
            self.err = max(self.err, float((y - ref).abs().max()))
            self.ref_peak = max(self.ref_peak, float(ref.abs().max()))
            self.items += 1

    @torch.no_grad()
    def encode_items(self, items: list) -> None:
        """Items {'x': (L,) input, 'pad_to': samples the call framed (the
        length bucket, or L for a stream), 'bits': bits a frame, 'codes':
        (frames, z), 'y': the waveform to judge}; the codes judged, then the
        waveform."""
        with R.exact_float32():
            for i in range(0, len(items), BLOCK):
                self._encode_block(items[i: i + BLOCK])

    def _encode_block(self, items: list) -> None:
        mels, valid = [], []
        for it in items:
            x = torch.as_tensor(it["x"], dtype=torch.float32, device=self.device).reshape(1, -1)
            x = torch.nn.functional.pad(x, (0, it["pad_to"] - x.shape[1]))
            mels.append(self.frontend(x, self.arith["mel"])[0])
            valid.append(self.frontend.frames(len(it["x"])))
        T = max(m.shape[0] for m in mels)
        mel = torch.stack([torch.nn.functional.pad(m, (0, 0, 0, T - m.shape[0])) for m in mels])
        mask = self._mask([it["bits"] for it in items], valid, T)
        codes = torch.full((len(items), T, self.z), 0.5, device=self.device)
        for r, it in enumerate(items):
            c = torch.as_tensor(it["codes"], dtype=torch.float32, device=self.device)
            codes[r, : c.shape[0]] = c
        probs, _, dec = R.encode_decode(self.p, mel, mask, self.arith["bvrnn"], codes)
        gap = gaps(probs, codes, mask)
        self.gap = max(self.gap, float(gap.max()))
        self.gap_sum += float(gap.sum(dtype=torch.float64))
        self.flips += int((gap > FLIP_GAP).sum())
        self.bits += int((mask > 0).sum())
        self._wave(dec, [it["y"] for it in items])

    @torch.no_grad()
    def decode_items(self, items: list) -> None:
        """Items {'codes': (T, z), 'lost': (T,) 0/1, 'conceal_bits': bits a
        concealed frame, 'y': the waveform to judge}."""
        self.gap = None
        with R.exact_float32():
            for i in range(0, len(items), BLOCK):
                block = items[i: i + BLOCK]
                T = max(len(it["lost"]) for it in block)
                codes = torch.full((len(block), T, self.z), 0.5, device=self.device)
                lost = torch.zeros(len(block), T, device=self.device)
                for r, it in enumerate(block):
                    c = torch.as_tensor(it["codes"], dtype=torch.float32, device=self.device)
                    codes[r, : c.shape[0]] = c
                    lost[r, : c.shape[0]] = torch.as_tensor(it["lost"], dtype=torch.float32,
                                                            device=self.device)
                cmask = self._mask([it["conceal_bits"] for it in block], [T] * len(block), T)
                dec = R.decode_concealed(self.p, codes, lost, cmask, self.arith["bvrnn"])
                self._wave(dec, [it["y"] for it in block])
