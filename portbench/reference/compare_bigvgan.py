"""The comparison that decides ``correct`` for a codec whose vocoder is the
published BigVGAN (:mod:`portbench.reference.bigvgan`), and its control.

:class:`Judge` is :class:`portbench.reference.compare.Judge` (the same
numbers, the same judged BVRNN) with the waveform made by the BigVGAN
reference from the first ceil(L / hop) decoded frames of each item, L the
item's own length: the generator looks ahead, so it is not run over the
length bucket's padding frames.  :func:`encode` is
:func:`portbench.reference.free.encode` with that vocoder: the reference
run free in a control's arithmetic.
"""

from __future__ import annotations

import torch

from portbench.reference import bigvgan as V, bvrnn_codec as R, compare
from portbench.reference.compare import BLOCK


def vocode(v: dict, conf: dict, dec: torch.Tensor, lengths: list, kind: str) -> list:
    """Each row of ``dec`` (B, T, M) vocoded from its first ceil(L / hop)
    frames to its ``lengths`` samples (rows of one frame count at once): a
    list of (L,) waveforms."""
    hop = conf["hopsize"]
    frames = [V.frames_vocoded(n, hop) for n in lengths]
    out = [None] * len(lengths)
    for f in sorted(set(frames)):
        rows = [r for r, g in enumerate(frames) if g == f]
        wav = V.vocoder(v, conf["vocoder_config"], dec[rows, :f].transpose(1, 2), f * hop, kind)
        for r, w in zip(rows, wav):
            out[r] = w[: lengths[r]]
    return out


class Judge(compare.Judge):
    def _wave(self, dec: torch.Tensor, ys: list) -> None:
        ys = [torch.as_tensor(y, dtype=torch.float32, device=self.device).reshape(-1) for y in ys]
        refs = vocode(self.v, self.conf, dec, [y.shape[0] for y in ys], self.arith["vocoder"])
        for y, ref in zip(ys, refs):
            self.err = max(self.err, float((y - ref).abs().max()))
            self.ref_peak = max(self.ref_peak, float(ref.abs().max()))
            self.items += 1


@torch.no_grad()
def encode(arith: dict, p: dict, v: dict, conf: dict, items: list, device) -> None:
    """Fill each encode item's 'codes' and 'y' from the reference run free
    in ``arith``, in blocks of items padded to the longest."""
    fe = R.Frontend(conf, device)
    z = conf["z_dim"]
    pad = torch.nn.functional.pad
    with R.exact_float32():
        for i in range(0, len(items), BLOCK):
            block = items[i: i + BLOCK]
            mels, masks = [], []
            for it in block:
                x = torch.as_tensor(it["x"], dtype=torch.float32, device=device).reshape(1, -1)
                mel = fe(pad(x, (0, it["pad_to"] - x.shape[1])), arith["mel"])
                bits = it["bits"] if conf["var_bit"] else z
                mask = R.bit_mask(torch.full((mel.shape[1],), float(bits), device=device), z)
                mask[fe.frames(len(it["x"])):] = 0
                mels.append(mel[0])
                masks.append(mask)
            T = max(m.shape[0] for m in mels)
            mel = torch.stack([pad(m, (0, 0, 0, T - m.shape[0])) for m in mels])
            mask = torch.stack([pad(m, (0, 0, 0, T - m.shape[0])) for m in masks])
            _, codes, dec = R.encode_decode(p, mel, mask, arith["bvrnn"])
            ys = vocode(v, conf, dec, [len(it["x"]) for it in block], arith["vocoder"])
            for it, c, y, m in zip(block, codes, ys, mels):
                it["codes"], it["y"] = c[: m.shape[0]], y
