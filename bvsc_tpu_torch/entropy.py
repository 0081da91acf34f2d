"""Prior-adaptive entropy coding of BVRNN codes (the ``.bvsc`` version 3 payload).

Port of ``bvsc_tpu/entropy.py``.  The BVRNN trains its Bernoulli-KL against
a learned prior P(z_t | h_t), so the rate it pays is the cross-entropy of
the codes under that prior, yet the codes are sent raw at k bits/frame.
:class:`PriorEntropyCoder` closes that gap: it range-codes the transmitted
first-k bits of every frame against the prior with binary rANS
(``ops/rans.py``, ``native/rans.c``), a smaller payload for bit-identical
codes.  The decoded audio path is unchanged: the card's scan consumes the
exact same codes.

**Determinism contract.** rANS needs both ends' quantised probabilities
equal bit for bit.  The prior depends on the hidden state h_t, which both
ends advance from the decoded bits alone (the closed-loop state sync of
``models/bvrnn.py``), so the contract is that the prior and the advance
give the same bits on every machine, for every thread count, batch and
device that made the codes.  The port's float32 ``prior_apply`` and
``_advance`` cannot promise that: a BLAS product splits its sums by thread
count and shape, and the float32 prior moves by ~2e-7 between 1 and 8
torch threads and between batch 8 and 1, enough to move a probability by
one 2^-16 quantisation step now and then and desync the decoder.  So this
coder runs the same math (``prior_apply``, and the decode step that
``models.bvrnn._advance`` runs) on the host CPU in float64, in one fixed
order:

* each dense layer sums its products in ascending input order, each
  product and each sum rounded once (``native/prior.c``, built with
  ``-ffp-contract=off``; the numpy mirror :func:`_dense_numpy` computes
  the same expression in the same order when there is no C compiler);
* the activations use only +, -, *, / and an exponential built from them
  (:func:`_exp`), so no libm or SIMD transcendental whose last bit depends
  on the CPU enters;
* the probabilities are quantised once, by ``rans.quantize_probs``.

This is the reference's own design, which commits its pass to one jitted
program on the host CPU so that payloads do not depend on the accelerator;
it is not a fallback from the card.  The coder takes no device argument and
refuses CUDA tensors: pass the host weights (``convert.load_bvrnn_npz``).

**Not interchangeable with ``bvsc_tpu``'s payloads.** ``bvsc_tpu``'s prior
is float32 through XLA; the two priors differ by ~5e-7, which moves a few
quantised probabilities by one step (14 of 7 945 on the demo utterance),
and a decoder fed another probability than its encoder desyncs.  So the
port writes its files as version 3 and refuses ``bvsc_tpu``'s version 2
(``bvsc_tpu_torch/cli/codec_cli.py``); ``bvsc_tpu``'s reader refuses
version 3.

Throughput: the per-frame host loop exists because P(z_t) is computable
only after z_{<t}; this is an offline file-format path, not the serving
path, which keeps raw first-k packing or the integer wire coder
(``serve/entropy_wire.py``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from bvsc_tpu_torch.ops import _cc, rans

_lib = None
_tried = False

# Cody-Waite split of ln 2 (fdlibm's): n * _LN2_HI is exact for |n| < 2^11
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_INV_LN2 = 1.44269504088896338700e+00
# Taylor coefficients of exp on |r| <= ln2 / 2, highest first: the
# remainder r^14 / 14! is below 4e-18 there
_EXP_COEF = tuple(1.0 / math.factorial(k) for k in range(13, -1, -1))
_LAYERS = ("phi_x", "phi_z", "prior", "dec")


def _load_native():
    """Compile prior.c (``ops._cc``, no fused multiply-add) and load it;
    None when there is no C compiler (the numpy mirror)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = _cc.load("prior", ("-ffp-contract=off",))
    if lib is not None:
        f64p = ctypes.POINTER(ctypes.c_double)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.bvsc_prior_dense.restype = None
        lib.bvsc_prior_dense.argtypes = [f64p, f32p, f32p, ctypes.c_long, ctypes.c_long, f64p]
    _lib = lib
    return _lib


def _exp(x: np.ndarray) -> np.ndarray:
    """exp in float64 from +, -, *, / alone: the same bits on any IEEE
    machine (relative error ~1e-16)."""
    x = np.clip(x, -745.0, 709.0)
    n = np.floor(x * _INV_LN2 + 0.5)
    r = (x - n * _LN2_HI) - n * _LN2_LO
    p = np.full_like(r, _EXP_COEF[0])
    for c in _EXP_COEF[1:]:
        p = p * r + c
    return np.ldexp(p, n.astype(np.int32))


def _elu(x: np.ndarray) -> np.ndarray:
    return np.where(x > 0, x, _exp(np.minimum(x, 0.0)) - 1.0)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + _exp(-x))


def _tanh(x: np.ndarray) -> np.ndarray:
    return 2.0 / (1.0 + _exp(-2.0 * x)) - 1.0


def _dense_numpy(x: np.ndarray, w64: np.ndarray, b64: np.ndarray) -> np.ndarray:
    """``native/prior.c``'s expression in its order: the products of input
    i are added to every output at step i, then the bias."""
    acc = np.zeros(w64.shape[1])
    tmp = np.empty_like(acc)
    for i in range(w64.shape[0]):
        np.multiply(w64[i], x[i], out=tmp)
        np.add(acc, tmp, out=acc)
    return acc + b64


def _host_weight(a) -> np.ndarray:
    """A host weight as float32 numpy; bf16 (the bf16 storage dtype's)
    widens exactly, so the float64 pass runs on the stored values."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError("the prior coder runs on the host: pass host weights "
                             "(numpy or CPU tensors, e.g. convert.load_bvrnn_npz)")
        a = a.detach().to(torch.float32).numpy()
    return np.ascontiguousarray(a, np.float32)


def _host_codes(codes) -> np.ndarray:
    """Codes as float32 numpy: a tensor on any device and of either storage
    dtype (bf16 has no numpy type; 0, 0.5 and 1 widen exactly)."""
    if isinstance(codes, torch.Tensor):
        codes = codes.detach().to("cpu", torch.float32).numpy()
    return np.asarray(codes, np.float32)


def _is_float_weight(w) -> bool:
    """Quantised layers store w = {'q': int8, 'scale': float32}
    (``ops/quant.py``), whose float scale and bias would pass a check of
    the first leaf's type: inspect the weight itself."""
    if isinstance(w, dict):
        return False
    if isinstance(w, torch.Tensor):
        return w.is_floating_point()
    return np.issubdtype(np.asarray(w).dtype, np.floating)


def _as_bits_per_frame(bits_per_frame, frames: int, z_dim: int) -> np.ndarray:
    # ceil, not truncate: the model's bit-priority mask transmits every bit
    # index strictly below the (possibly fractional) allocation
    # (models.bvrnn.bit_mask_from_bitrate uses ``>``), so 34.8 bits/frame
    # means 35 transmitted bits; an int() cast would drop the top bit and
    # desync the closed-loop hidden states
    k = np.ceil(np.asarray(bits_per_frame, np.float64)).astype(np.int64)
    if k.ndim == 0:
        k = np.full(frames, int(k))
    if k.shape != (frames,):
        raise ValueError(f"bits_per_frame shape {k.shape} != ({frames},)")
    return np.clip(k, 0, z_dim)


class PriorEntropyCoder:
    """Entropy encode/decode BVRNN codes against the model's own prior.

    params: the port's float BVRNN tree (``models.bvrnn``), as numpy arrays
    or CPU tensors; cfg: its ``BVRNNConfig``.  int8-quantised parameters
    are refused: the entropy model must be the float prior both ends can
    reproduce exactly.
    """

    def __init__(self, params, cfg):
        if "prior" not in params:
            raise ValueError("params has no 'prior' MLP: not BVRNN params")
        layers = [lyr for name in _LAYERS for lyr in params[name]]
        weights = [lyr["w"] for lyr in layers] + [params["gru"]["w_ih"], params["gru"]["w_hh"]]
        if not all(_is_float_weight(w) for w in weights):
            raise ValueError("entropy coding needs float BVRNN params (got quantised); "
                             "load the codec with quantize=None")
        self.cfg = cfg
        self._nets = {name: [(_host_weight(lyr["w"]), _host_weight(lyr["b"]))
                             for lyr in params[name]] for name in _LAYERS}
        gru = params["gru"]
        self._gru_ih = (_host_weight(gru["w_ih"]), _host_weight(gru["b_ih"]))
        self._gru_hh = (_host_weight(gru["w_hh"]), _host_weight(gru["b_hh"]))
        self._mean = _host_weight(params["mean_mel"]).astype(np.float64)
        self._std = _host_weight(params["std_mel"]).astype(np.float64)
        self._wide: dict[int, tuple[np.ndarray, np.ndarray]] = {}  # the numpy path's float64 copies

    # -- the host pass, float64 in a fixed order --------------------------------

    def _dense(self, layer, x: np.ndarray) -> np.ndarray:
        w, b = layer
        lib = _load_native()
        if lib is None:
            if id(w) not in self._wide:
                self._wide[id(w)] = (w.astype(np.float64), b.astype(np.float64))
            return _dense_numpy(x, *self._wide[id(w)])
        x = np.ascontiguousarray(x, np.float64)
        out = np.empty(w.shape[1])
        lib.bvsc_prior_dense(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            w.shape[0], w.shape[1], out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out

    def _mlp(self, name: str, x: np.ndarray, final=None) -> np.ndarray:
        """``models.bvrnn._mlp_elu``: Linear+ELU, ``final`` on the last."""
        layers = self._nets[name]
        for lyr in layers[:-1]:
            x = _elu(self._dense(lyr, x))
        x = self._dense(layers[-1], x)
        return x if final is None else final(x)

    def _prior(self, h: np.ndarray) -> np.ndarray:
        """P(bit==1) of the next frame's bits (``models.bvrnn.prior_apply``)."""
        return self._mlp("prior", h, _sigmoid)

    def _advance(self, h: np.ndarray, z_t: np.ndarray) -> np.ndarray:
        """One closed-loop state advance from the midpoint-filled frame codes:
        the decode step of ``models.bvrnn._advance`` (phi_z, dec, phi_x of
        the normalised decoded frame, then the GRU, gates packed [r|z|n])."""
        phi_z = self._mlp("phi_z", z_t, _elu)
        dec = self._mlp("dec", np.concatenate([phi_z, h]))
        phi_x = self._mlp("phi_x", (dec - self._mean) / self._std, _elu)
        gi = self._dense(self._gru_ih, np.concatenate([phi_x, phi_z]))
        gh = self._dense(self._gru_hh, h)
        H = h.shape[0]
        r = _sigmoid(gi[:H] + gh[:H])
        z = _sigmoid(gi[H:2 * H] + gh[H:2 * H])
        n = _tanh(gi[2 * H:] + r * gh[2 * H:])
        return (1.0 - z) * n + z * h

    @staticmethod
    def _fill_midpoint(bits: np.ndarray, k: int, z_dim: int) -> np.ndarray:
        row = np.full(z_dim, 0.5)
        row[:k] = bits[:k]
        return row

    # -- public API ----------------------------------------------------------------

    def encode(self, codes: np.ndarray, bits_per_frame) -> bytes:
        """codes: (frames, z_dim) {0,1} with 0.5 in masked positions (one
        stream's output of ``BVRNNCodecModel.encode``, on the host);
        returns the rANS payload for the first-k bits of every frame."""
        codes = _host_codes(codes)
        frames, z_dim = codes.shape
        ks = _as_bits_per_frame(bits_per_frame, frames, z_dim)
        hard = (codes > 0.5 + 1e-6).astype(np.uint8)
        h = np.zeros(self.cfg.h_dim)
        flat_bits, flat_probs = [], []
        for t in range(frames):
            k = int(ks[t])
            if k:  # zero-bit (DTX) frames need no prior
                flat_bits.append(hard[t, :k])
                flat_probs.append(rans.quantize_probs(self._prior(h)[:k]))
            if t + 1 < frames:  # the last frame's state is never read
                h = self._advance(h, self._fill_midpoint(hard[t], k, z_dim))
        if not flat_bits:
            return b""
        return rans.rans_encode(np.concatenate(flat_bits), np.concatenate(flat_probs))

    def decode(self, payload: bytes, bits_per_frame, frames: int) -> np.ndarray:
        """Inverse of :meth:`encode`: (frames, z_dim) float32 codes with 0.5
        midpoints in untransmitted positions, the exact input
        ``BVRNNCodecModel.decode`` expects.  Raises ``ValueError`` on a
        truncated or corrupt payload (rANS state-unwind check)."""
        z_dim = self.cfg.z_dim
        ks = _as_bits_per_frame(bits_per_frame, frames, z_dim)
        out = np.full((frames, z_dim), 0.5, np.float32)
        if int(ks.sum()) == 0:
            if payload:
                raise ValueError("nonempty payload for zero transmitted bits")
            return out
        dec = rans.RansDecoder(payload)
        h = np.zeros(self.cfg.h_dim)
        for t in range(frames):
            k = int(ks[t])
            if k:  # zero-bit (DTX) frames need no prior
                out[t, :k] = dec.decode_bits(rans.quantize_probs(self._prior(h)[:k]))
            if t + 1 < frames:
                h = self._advance(h, out[t].astype(np.float64))
        dec.finish()
        return out

    def measure(self, codes: np.ndarray, bits_per_frame) -> dict:
        """Payload-size diagnostics: raw first-k bytes against entropy-coded."""
        codes = _host_codes(codes)
        frames, z_dim = codes.shape
        ks = _as_bits_per_frame(bits_per_frame, frames, z_dim)
        payload = self.encode(codes, bits_per_frame)
        raw_bits = int(ks.sum())
        return {
            "frames": frames,
            "raw_bytes": (raw_bits + 7) // 8,
            "coded_bytes": len(payload),
            "saving_pct": 100.0 * (1.0 - 8 * len(payload) / raw_bits) if raw_bits else 0.0,
        }
