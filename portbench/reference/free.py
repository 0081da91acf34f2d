"""The reference run free in a given arithmetic: what a control puts in the
program's place (``portbench/control.py``).  Its outputs are judged as the
program's are, by :mod:`portbench.reference.compare`.
"""

from __future__ import annotations

import torch

from portbench.reference import bvrnn_codec as R
from portbench.reference.compare import BLOCK


@torch.no_grad()
def encode(arith: dict, p: dict, v: dict, conf: dict, items: list, device) -> None:
    """Fill each encode item's 'codes' and 'y' from the reference run free
    in ``arith``, in blocks of items padded to the longest."""
    fe = R.Frontend(conf, device)
    z, hop = conf["z_dim"], conf["hopsize"]
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
            y = R.vocoder(v, conf["vocoder_config"], dec.transpose(1, 2), T * hop, arith["vocoder"])
            for it, c, w, m in zip(block, codes, y, mels):
                it["codes"], it["y"] = c[: m.shape[0]], w[: len(it["x"])]


@torch.no_grad()
def decode(arith: dict, p: dict, v: dict, conf: dict, items: list, device) -> None:
    """Fill each decode item's 'y' from the reference run in ``arith``."""
    z = conf["z_dim"]
    with R.exact_float32():
        for i in range(0, len(items), BLOCK):
            block = items[i: i + BLOCK]
            T = max(len(it["lost"]) for it in block)
            codes = torch.full((len(block), T, z), 0.5, device=device)
            lost = torch.zeros(len(block), T, device=device)
            cmask = torch.zeros(len(block), T, z, device=device)
            for r, it in enumerate(block):
                n = len(it["lost"])
                codes[r, :n] = torch.as_tensor(it["codes"], device=device)
                lost[r, :n] = torch.as_tensor(it["lost"], device=device)
                bits = it["conceal_bits"] if conf["var_bit"] else z
                cmask[r] = R.bit_mask(torch.full((T,), float(bits), device=device), z)
            dec = R.decode_concealed(p, codes, lost, cmask, arith["bvrnn"])
            y = R.vocoder(v, conf["vocoder_config"], dec.transpose(1, 2), T * conf["hopsize"],
                          arith["vocoder"])
            for it, w in zip(block, y):
                it["y"] = w[: len(it["lost"]) * conf["hopsize"]]
