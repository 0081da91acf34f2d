"""Seeded weights of the codec, made on the device in two large draws.

The tree layouts are the program's inference trees (linear weights stored
(in, out), GRU gates packed [r | z | n], folded convs in torch's layouts,
log-scale snake parameters), so the same tensors go to the program and to
the reference.

The scales are those of a trained model, not of the published inits: under
torch's Linear init (U(+-1/sqrt(fan_in))) and BigVGAN's N(0, 0.01) convs a
signal shrinks several times a layer, so at the published depths the
encoder's probabilities all sit near 0.5 and the waveform is the biases'
constant, whatever the input.  Here each layer keeps its input's size
(weights of standard deviation ``GAIN / sqrt(fan_in)``), the encoder's
logits are spread over several units (``ENC_GAIN``), so most bits are
decided with a margin, the decoder's output has a log-mel's level and
spread, and the GRU keeps torch's init; the snakes' log-scale parameters are
drawn N(0, 0.3), as a trained vocoder's are spread.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib.seeds import generator


GAIN = 1.5  # a Linear + ELU layer's weight scale, times 1 / sqrt(fan_in)
ENC_GAIN = 6.0  # the encoder's last layer: logits of a few units
DEC_GAIN = 2.0  # the decoder's last layer: a log-mel's spread
CONV_GAIN = {"pre": 1.0, "up": 1.0, "block": 0.5, "post": 0.15}
BIAS = 0.1  # biases U(+-BIAS / sqrt(fan_in))


def _linear(shapes, fan_in, fan_out, gain=GAIN):
    shapes.append(("u", (fan_in, fan_out), gain * np.sqrt(3 / fan_in)))
    shapes.append(("u", (fan_out,), BIAS / np.sqrt(fan_in)))


def _conv(shapes, out_ch, in_ch, k, part, stride=1):
    fan_in = in_ch * k / stride
    shape = (in_ch, out_ch, k) if part == "up" else (out_ch, in_ch, k)
    shapes.append(("n", shape, CONV_GAIN[part] / np.sqrt(fan_in)))
    shapes.append(("u", (out_ch,), BIAS / np.sqrt(fan_in)))


def _snake(shapes, ch):
    shapes.append(("n", (ch,), 0.3))
    shapes.append(("n", (ch,), 0.3))


def _plan(conf: dict) -> list:
    """(distribution, shape, scale) of every leaf, in tree order."""
    x, h, z = conf["num_mels"], conf["h_dim"], conf["z_dim"]
    s: list = [("u", (x,), 1.0), ("u", (x,), 1.0)]  # mel statistics, mapped below
    for name, dims in (("phi_x", [x, h, h, h]), ("phi_z", [z, h, h, h]), ("enc", [2 * h, h, h, z]),
                       ("prior", [h, h, h, z]), ("dec", [2 * h, h, h, h, x])):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            last = i == len(dims) - 2
            gain = {"enc": ENC_GAIN, "prior": ENC_GAIN, "dec": DEC_GAIN}.get(name, GAIN)
            _linear(s, a, b, gain if last else GAIN)
    for shape in ((2 * h, 3 * h), (h, 3 * h), (3 * h,), (3 * h,)):
        s.append(("u", shape, 1 / np.sqrt(h)))
    v = conf["vocoder_config"]
    c0 = v["upsample_initial_channel"]
    _conv(s, c0, v["num_mels"], 7, "pre")
    ch = c0
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        out = c0 // 2 ** (i + 1)
        _conv(s, out, ch, k, "up", u)
        for ksz, dils in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            for _ in range(2 * len(dils)):
                _conv(s, out, out, ksz, "block")
            for _ in range(2 * len(dils)):
                _snake(s, out)
        ch = out
    _snake(s, ch)
    _conv(s, 1, ch, 7, "post")
    return s


def make_weights(conf: dict, seed: int, device) -> tuple[dict, dict]:
    """(BVRNN tree, vocoder tree) of float32 tensors on ``device`` from
    ``seed``: one uniform and one normal draw, sliced into the leaves."""
    plan = _plan(conf)
    gen = generator(seed, "weights", device)
    sizes = {d: sum(int(np.prod(sh)) for dd, sh, _ in plan if dd == d) for d in ("u", "n")}
    pools = {"u": torch.rand(sizes["u"], generator=gen, device=device) * 2 - 1,
             "n": torch.randn(sizes["n"], generator=gen, device=device)}
    at = {"u": 0, "n": 0}
    leaves = []
    for d, shape, scale in plan:
        n = int(np.prod(shape))
        leaves.append((pools[d][at[d]: at[d] + n] * scale).reshape(shape))
        at[d] += n
    it = iter(leaves)

    def lin():
        return {"w": next(it), "b": next(it)}

    def cv():
        return {"w": next(it), "b": next(it)}

    def act():
        return {"alpha": next(it), "beta": next(it)}

    mean, std = next(it), next(it)
    bvrnn = {"mean_mel": mean - 5.0, "std_mel": 2.0 + 0.5 * std,
             "log_sigma": torch.full((1,), conf.get("log_sigma_init", -1.0), device=device)}
    for name, n in (("phi_x", 3), ("phi_z", 3), ("enc", 3), ("prior", 3), ("dec", 4)):
        bvrnn[name] = [lin() for _ in range(n)]
    bvrnn["gru"] = {k: next(it) for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    v = conf["vocoder_config"]
    voc: dict = {"conv_pre": cv(), "ups": [], "resblocks": []}
    for _ in v["upsample_kernel_sizes"]:
        voc["ups"].append(cv())
        for dils in v["resblock_dilation_sizes"]:
            convs = [cv() for _ in range(2 * len(dils))]
            voc["resblocks"].append({"convs1": convs[0::2], "convs2": convs[1::2],
                                     "acts": [act() for _ in range(2 * len(dils))]})
    voc["act_post"] = act()
    voc["conv_post"] = cv()
    return bvrnn, voc
