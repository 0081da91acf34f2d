"""Bernoulli-valued variational RNN (BVRNN), inference, in PyTorch.

Port of ``bvsc_tpu/models/bvrnn.py``: init, the MLP nets, the GRU step, the
bit mask, the standard and the fused cell, ``encode``,
``encode_with_state``, ``encode_decode``, ``decode`` and ``decode_plc``
(packet-loss concealment from the prior), and the training forward
``forward_train`` (scheduled sampling, straight-through bits, Bernoulli KL;
its random draws are tensors the caller passes, :func:`draw_train_noise`).
Parameters are a nested dict of tensors with the JAX package's keys and
layouts: linear weights are stored (in, out) and applied as ``x @ w``; the
GRU gates are packed [r|z|n].  Weights may also be weight-only int8 dicts
(``ops.quant``).

``cfg.precision`` sets every product: ``'highest'`` is float32,
``'default'`` takes bf16 operands with float32 sums (``ops.precision``).
:func:`prepare` casts the weights to that type once (and builds the fused
cell's weights); the scans take its :class:`ScanParams` or, as the tests
do, a raw tree, which they prepare on each call.

``cfg.dtype`` is the storage type (the reference's ``BVRNNConfig.dtype``):
float32, or bf16, where every parameter (biases and mel statistics too)
is stored in bf16, the scans cast their inputs (mel, state, bit mask,
codes) to bf16 as the reference does, and every product takes bf16
operands to a bf16 result (``ops.precision.matmul_bf16``) at either
precision; elementwise ops round to bf16 after each op.

The frame recurrence is one step function per scan, run by :func:`_frames`:
a Python loop, or, when the scan params are ``traced`` (a serving bundle's
programs, ``serve.export``), ``torch._higher_order_ops.scan`` over the same
step, so a program holds one step whatever its frame count.  Each step is a
handful of products, as the JAX package leaves these GEMMs to XLA.  On the
card, a scan of prepared weights with no gradient runs its whole chunks of
:data:`CHUNK` frames as replays of a CUDA graph of the loop, captured once a
key and kept on the :class:`ScanParams` (:func:`_chunk_graph`): the same
kernels at the same shapes, so the same bits, without the host issuing some
fifty launches a frame.

Closed-loop state sync: encode and decode advance the GRU only with
*generated* features, so both sides' hidden states follow the codes alone.
``decode`` therefore computes phi_z per step, in the same (B, z) shape as
the encoder, never hoisted over the sequence; in the fused cell both sides
share :func:`_fused_h_combo` and :func:`_fused_tail`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from bvsc_tpu_torch.convert import tree_size
from bvsc_tpu_torch.ops import precision as P
from bvsc_tpu_torch.ops.quant import dequant_matmul, is_quantized as _is_quant_dict
from bvsc_tpu_torch.utils import tracing

Params = dict

# 'auto' picks the fused cell below this batch (the reference's threshold,
# where its scan step stops being op-count-bound)
FUSED_AUTO_MAX_B = 32

# frames of a scan's captured chunk (_frames): the codec's length bucket, so
# that a bucketed scan is whole chunks
CHUNK = 64


@dataclasses.dataclass(frozen=True)
class BVRNNConfig:
    x_dim: int = 80
    h_dim: int = 1024
    z_dim: int = 64
    var_bit: bool = True
    precision: str = "highest"
    fused_cell: bool | str = False
    dtype: torch.dtype = torch.float32  # storage: float32 or bfloat16


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def _dense_init(rng: np.random.Generator, fan_in: int, fan_out: int) -> dict:
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / np.sqrt(fan_in)
    return {
        "w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (fan_out,)).astype(np.float32),
    }


def _mlp_init(rng, dims):
    return [_dense_init(rng, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def init_bvrnn_params(
    seed: int,
    cfg: BVRNNConfig,
    mean_std_mel: tuple[np.ndarray, np.ndarray] | None = None,
    log_sigma_init: float = -1.0,
) -> Params:
    """Fresh parameters from a numpy seed, as a tree of numpy arrays (the
    layer shapes of ``bvsc_tpu.models.bvrnn.init_bvrnn_params``)."""
    rng = np.random.default_rng(seed)
    x, h, z = cfg.x_dim, cfg.h_dim, cfg.z_dim
    if mean_std_mel is None:
        mean_std_mel = (np.zeros(x), np.ones(x))
    bound = 1.0 / np.sqrt(h)
    return {
        "mean_mel": np.asarray(mean_std_mel[0], np.float32),
        "std_mel": np.asarray(mean_std_mel[1], np.float32),
        "log_sigma": np.asarray([log_sigma_init], np.float32),
        "phi_x": _mlp_init(rng, [x, h, h, h]),
        "phi_z": _mlp_init(rng, [z, h, h, h]),
        "enc": _mlp_init(rng, [2 * h, h, h, z]),
        "prior": _mlp_init(rng, [h, h, h, z]),
        "dec": _mlp_init(rng, [2 * h, h, h, h, x]),
        "gru": {
            "w_ih": rng.uniform(-bound, bound, (2 * h, 3 * h)).astype(np.float32),
            "w_hh": rng.uniform(-bound, bound, (h, 3 * h)).astype(np.float32),
            "b_ih": rng.uniform(-bound, bound, (3 * h,)).astype(np.float32),
            "b_hh": rng.uniform(-bound, bound, (3 * h,)).astype(np.float32),
        },
    }


def param_count(params: Params) -> int:
    """The parameters' count (every leaf's elements)."""
    return tree_size(params)


# ---------------------------------------------------------------------------
# Functional pieces
# ---------------------------------------------------------------------------


def _matmul(x, w, precision):
    """``x @ w`` at ``precision`` for float weights or int8 dicts; bf16
    operands (bf16 storage, the bf16 training forward) give a bf16
    product."""
    if isinstance(w, dict):
        return dequant_matmul(x, w, precision)
    if x.dtype == torch.bfloat16:
        return P.matmul_bf16(x, w)
    return P.matmul(x, w, precision)


def _sigmoid(x):
    """The logistic function; in bf16 as the reference's XLA expands it,
    ``1 / (1 + exp(-x))`` with each op rounded to bf16 (a single rounding
    of the float32 sigmoid differs from it in the last bit for a third of
    the inputs)."""
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def _dense(p, x, precision="highest"):
    return _matmul(x, p["w"], precision) + p["b"]


def _mlp_elu(layers, x, precision, final_activation=None):
    """Linear+ELU stack; the last layer gets ``final_activation``."""
    for p in layers[:-1]:
        x = F.elu(_dense(p, x, precision))
    x = _dense(layers[-1], x, precision)
    return x if final_activation is None else final_activation(x)


def phi_x_apply(params, y, precision="highest"):
    return _mlp_elu(params["phi_x"], y, precision, F.elu)


def phi_z_apply(params, z, precision="highest"):
    return _mlp_elu(params["phi_z"], z, precision, F.elu)


def enc_apply(params, x, precision="highest"):
    return _mlp_elu(params["enc"], x, precision, _sigmoid)


def prior_apply(params, h, precision="highest"):
    """The prior P(z_t | h_t): the concealment model of :func:`decode_plc`."""
    return _mlp_elu(params["prior"], h, precision, _sigmoid)


def dec_apply(params, x, precision="highest"):
    return _mlp_elu(params["dec"], x, precision)


def gru_step(gru: Params, x: torch.Tensor, h: torch.Tensor,
             precision: str = "highest") -> torch.Tensor:
    """One torch-semantics GRU step, gates packed [r|z|n]:
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))."""
    gi = _matmul(x, gru["w_ih"], precision) + gru["b_ih"]
    gh = _matmul(h, gru["w_hh"], precision) + gru["b_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = _sigmoid(i_r + h_r)
    z = _sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def bit_mask_from_bitrate(var_bitrate: torch.Tensor, z_dim: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """First-k bit-priority mask: (B, T) bits/frame -> (B, T, z_dim) 0/1 in
    ``dtype``."""
    bit_idx = torch.arange(z_dim, device=var_bitrate.device)
    return (var_bitrate[..., None] > bit_idx).to(dtype)


def _apply_bit_mask(z, mask):
    """Masked-out bits take the uninformative midpoint 0.5."""
    return z * mask + 0.5 * (1.0 - mask)


def _normalize(params, y):
    return (y - params["mean_mel"]) / params["std_mel"]


def _bf16_storage(params) -> bool:
    return params["std_mel"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Fused cell (cfg.fused_cell): fewer, larger products per step
# ---------------------------------------------------------------------------
#
# Every Linear that reads concat([a, b]) distributes as a @ W[:k] + b @ W[k:],
# so (as in the JAX package):
#   * w_h_combo (h, 5h) = [enc_l1 h-part | dec_l1 h-part | gru w_hh]: all
#     that reads only the carried h is one product at the step's start;
#   * w_pz_combo (h, 4h) = [dec_l1 phi_z-part | gru w_ih phi_z-part];
#   * w_ih_top (h, 3h): gru w_ih's part for the generated features;
#   * enc_l1's phi_x-part is applied to the whole sequence before the loop;
#   * dec_l4 -> normalize -> phi_x_l1 is affine, folded into one (h, h)
#     product (w_fold); the loop emits dec_l3's activation a3 and the mel is
#     one dec_l4 product after the loop.
# The sums are reassociated against the standard cell, so codes may flip in
# rare near-0.5 cases (the fast-serving contract).


def is_quantized(params: Params) -> bool:
    """True for weight-only int8 trees (``ops.quant``)."""
    return _is_quant_dict(params["gru"]["w_ih"])


def _use_fused(cfg: BVRNNConfig, batch: int) -> bool:
    """The fused_cell policy for a batch size."""
    if cfg.fused_cell == "auto":
        return batch < FUSED_AUTO_MAX_B
    return bool(cfg.fused_cell)


def _fuse_inference_params(params: Params, cfg: BVRNNConfig) -> Params:
    """The fused cell's weights from a float tree.  ``w_fold`` and ``b_fold``
    are formed at full precision (float64 sums, rounded once to float32)
    whatever ``cfg.precision``, so that no TF32 setting reaches them; only
    the products that use them follow the precision.  A bf16-stored tree
    forms them as the reference does in bf16: each elementwise op rounded
    to bf16 and each product a bf16 product."""
    if is_quantized(params):
        raise TypeError("fused_cell does not support quantized weights")
    h = params["gru"]["w_hh"].shape[0]
    enc1, enc2, enc3 = params["enc"]
    dec1, dec2, dec3, dec4 = params["dec"]
    px1, px2, px3 = params["phi_x"]
    gru = params["gru"]
    inv_std = 1.0 / params["std_mel"]
    if _bf16_storage(params):
        w_fold = P.matmul_bf16(dec4["w"], px1["w"] * inv_std[:, None])
        b_fold = P.matmul_bf16((dec4["b"] - params["mean_mel"]) * inv_std, px1["w"]) + px1["b"]
    else:
        px1_w = px1["w"].double()
        w_fold = (dec4["w"].double() @ (px1["w"] * inv_std[:, None]).double()).float()
        b_fold = (((dec4["b"] - params["mean_mel"]) * inv_std).double() @ px1_w).float() \
            + px1["b"]
    return {
        "w_h_combo": torch.cat([enc1["w"][h:], dec1["w"][h:], gru["w_hh"]], dim=1),
        "w_pz_combo": torch.cat([dec1["w"][:h], gru["w_ih"][h:]], dim=1),
        "w_ih_top": gru["w_ih"][:h],
        "w_enc1_x": enc1["w"][:h],
        "b_enc1": enc1["b"],
        "enc2": enc2,
        "enc3": enc3,
        "b_dec1": dec1["b"],
        "dec2": dec2,
        "dec3": dec3,
        "dec4": dec4,
        # norm(a3 @ W4 + b4) @ Wpx1 + bpx1
        #   == a3 @ (W4 @ (Wpx1 * inv_std[:, None]))
        #      + ((b4 - mean) * inv_std) @ Wpx1 + bpx1
        "w_fold": w_fold,
        "b_fold": b_fold,
        "px2": px2,
        "px3": px3,
        "phi_z": params["phi_z"],
        "b_ih": gru["b_ih"],
        "b_hh": gru["b_hh"],
    }


def _fused_h_combo(fp, h, prec):
    """All that reads only the carried h, one (B, h) x (h, 5h) product:
    (enc_l1 h-part, dec_l1 h-part, GRU hidden gates before their bias)."""
    H = h.shape[-1]
    combo = _matmul(h, fp["w_h_combo"], prec)
    return combo[..., :H], combo[..., H : 2 * H], combo[..., 2 * H :]


def _fused_tail(fp, h, z_t, d1h, gh, prec):
    """phi_z -> dec stack -> folded generated-feature stack -> GRU update.
    Returns (h_next, a3), a3 being dec's last hidden activation."""
    H = h.shape[-1]
    p = z_t
    for lyr in fp["phi_z"]:
        p = F.elu(_dense(lyr, p, prec))
    pzc = _matmul(p, fp["w_pz_combo"], prec)
    d1z, gi_bot = pzc[..., :H], pzc[..., H:]
    d = F.elu(d1z + d1h + fp["b_dec1"])
    d = F.elu(_dense(fp["dec2"], d, prec))
    a3 = F.elu(_dense(fp["dec3"], d, prec))
    u = F.elu(_matmul(a3, fp["w_fold"], prec) + fp["b_fold"])
    u = F.elu(_dense(fp["px2"], u, prec))
    xg = F.elu(_dense(fp["px3"], u, prec))
    gi = _matmul(xg, fp["w_ih_top"], prec) + gi_bot + fp["b_ih"]
    ghb = gh + fp["b_hh"]
    r = _sigmoid(gi[..., :H] + ghb[..., :H])
    zz = _sigmoid(gi[..., H : 2 * H] + ghb[..., H : 2 * H])
    n = torch.tanh(gi[..., 2 * H :] + r * ghb[..., 2 * H :])
    return (1.0 - zz) * n + zz * h, a3


def _fused_enc_prob(fp, encx_t, e1h, prec):
    """The enc stack from the hoisted phi_x projection and the combo's
    h-part: the encoder's probabilities."""
    a = F.elu(encx_t + e1h + fp["b_enc1"])
    a = F.elu(_dense(fp["enc2"], a, prec))
    return _sigmoid(_dense(fp["enc3"], a, prec))


def _fused_enc(fp, encx_t, e1h, mask_t, prec):
    """:func:`_fused_enc_prob`, rounded and masked."""
    return _apply_bit_mask(torch.round(_fused_enc_prob(fp, encx_t, e1h, prec)), mask_t)


def _fused_dec_seq(fp, a3_seq, prec):
    """The dec_l4 product after the loop: (B, T, h) -> mel (B, T, x)."""
    return _dense(fp["dec4"], a3_seq, prec)


# ---------------------------------------------------------------------------
# Weights prepared for the scans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScanParams:
    """A BVRNN tree with its weight matrices in the precision's type (float32
    or bf16; int8 ``q`` widened, exactly), or under bf16 storage every
    tensor in bf16, and the fused cell's weights when the config can use
    them."""

    std: Params
    fused: Params | None
    # run the frames under torch's scan operator (a traced program holds one
    # step, whatever its frame count) instead of a Python loop
    traced: bool = False
    # the scans' chunk graphs by key (_chunk_graph), captured on first use:
    # they read these tensors, so they live and die with them.  Their static
    # buffers serve one scan at a time: scans on one stream queue in order,
    # but two threads scanning at once need a ScanParams each
    graphs: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)


def _cast_weights(tree, precision: str):
    """Every weight matrix (keys starting with ``w``) in the precision's
    type; biases and mel statistics stay float32."""
    dtype = torch.float32 if precision == "highest" else torch.bfloat16

    def walk(node, key):
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if _is_quant_dict(node):
            return {"q": node["q"].to(dtype), "scale": node["scale"]}
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node.to(dtype) if key.startswith("w") else node

    return walk(tree, "")


def prepare(params: Params | ScanParams, cfg: BVRNNConfig) -> ScanParams:
    """Cast once what every step would otherwise cast; build the fused
    cell's weights if ``cfg.fused_cell`` may pick it (a TypeError for int8
    trees)."""
    if isinstance(params, ScanParams):
        return params
    if cfg.dtype == torch.bfloat16:
        # every tensor in bf16 (a float32 tree rounded once), int8 ``q`` and
        # its ``scale`` too: the reference casts both to the activations' type
        params = _cast_tree(params, torch.bfloat16)
        return ScanParams(params, _fuse_inference_params(params, cfg) if cfg.fused_cell else None)
    fused = None
    if cfg.fused_cell:
        fused = _cast_weights(_fuse_inference_params(params, cfg), cfg.precision)
    return ScanParams(_cast_weights(params, cfg.precision), fused)


def _fused_params(sp: ScanParams) -> Params:
    if sp.fused is None:
        raise ValueError("these ScanParams were prepared without the fused cell")
    return sp.fused


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------


def _advance(params, z_t, h, prec):
    """Decoder half of a standard step: codes -> (decoded frame, next h)."""
    phi_z_t = phi_z_apply(params, z_t, prec)
    dec_t = dec_apply(params, torch.cat([phi_z_t, h], -1), prec)
    phi_x_gen = phi_x_apply(params, _normalize(params, dec_t), prec)
    h_next = gru_step(params["gru"], torch.cat([phi_x_gen, phi_z_t], -1), h, prec)
    return dec_t, h_next


def _loop(step, h, xs: list, statics=None):
    """The frames (axis 1) of ``xs`` one ``step`` call each: (final h, each
    of the step's outputs stacked on axis 1)."""
    outs = []
    for t in range(xs[0].shape[1]):
        h, o = step(h, *(x[:, t] for x in xs), **({} if statics is None else statics[t]))
        outs.append(o)
    return h, tuple(torch.stack(o, 1) for o in zip(*outs))


def _frames(step, h, xs: list, traced: bool, statics=None, cache=None, key=()):
    """``step(h, *x_t) -> (h, outs)`` over the frames (axis 1) of ``xs``:
    (final h, each of ``outs`` stacked on axis 1).  A Python loop, or, with
    ``traced`` and more than one frame, ``torch._higher_order_ops.scan``,
    which runs the same step and keeps a traced program one step long.
    ``statics`` gives the loop's steps one keyword argument each (a host
    value, so not under ``traced``).  ``cache``, a prepared ``ScanParams``'s
    graphs, and ``key``, what the step computes, let a scan of at least
    :data:`CHUNK` frames with neither, no gradient and no compiler tracing
    it run its whole chunks through :func:`_chunk_graph` (the rest of its
    frames run the loop).  Every BVRNN scan runs here, timed as the span
    ``bvrnn.scan``."""
    with tracing.span("bvrnn.scan"):
        T = xs[0].shape[1]
        if traced and T > 1:
            if statics is not None:
                raise ValueError("a traced scan takes no per-step host values")
            from torch._higher_order_ops.scan import scan

            # frames first, in and out (torch versions differ in where scan
            # leaves the frame axis of its outputs for dim != 0)
            h, outs = scan(lambda c, x: step(c, *x), h, [x.movedim(1, 0) for x in xs])
            return h, tuple(o.movedim(0, 1) for o in outs)
        run = None
        if (cache is not None and T >= CHUNK and statics is None and not torch.is_grad_enabled()
                and not tracing._tracing()):
            run = _chunk_graph(cache, key, step, h, [x[:, :CHUNK] for x in xs])
        if run is None:
            return _loop(step, h, xs, statics)
        B, whole = h.shape[0], T - T % CHUNK
        outs = None
        for t0 in range(0, whole, CHUNK):
            h, o = run(h, [x[:, t0 : t0 + CHUNK] for x in xs])
            if outs is None:
                outs = [c.new_empty((B, T) + c.shape[2:]) for c in o]
            for out, c in zip(outs, o):
                out[:, t0 : t0 + CHUNK] = c
            tracing.count("bvrnn.graph_frames", CHUNK * B)
        if whole < T:
            h, o = _loop(step, h, [x[:, whole:] for x in xs])
            for out, c in zip(outs, o):
                out[:, whole:] = c
        # a runner may leave h in a buffer its next chunk overwrites
        return h.clone(), tuple(outs)


def _chunk_graph(cache: dict, key: tuple, step, h: torch.Tensor, xs: list):
    """The runner of a scan's whole chunks, ``run(h, xs) -> (next h, the
    chunk's outputs)`` over :data:`CHUNK` frames: on the card, the
    :class:`_ChunkGraph` of ``key`` with the batch, type and device of ``h``
    and the matmul flags a product reads when it is captured (a flag
    flipped later gets a graph of its own), captured from ``step`` and the
    first chunk ``xs`` on its first use and kept in ``cache``; None (the
    loop) off the card or while the stream is being captured by someone
    else."""
    if h.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    key = key + (h.shape[0], CHUNK, h.dtype, h.device, torch.get_float32_matmul_precision(),
                 torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    graph = cache.get(key)
    if graph is None:
        graph = cache[key] = _ChunkGraph(step, h, xs)
    return graph


class _ChunkGraph:
    """A CUDA graph of :func:`_loop` over one chunk of frames, with its
    static buffers: a call copies the state and the chunk's inputs into
    them, replays, and returns the next state and the stacked outputs in
    buffers that the next call overwrites.  It is captured and replayed on
    the device of its tensors, whichever device is current."""

    def __init__(self, step, h, xs):
        with torch.cuda.device(h.device):
            self.h = h.clone(memory_format=torch.contiguous_format)
            self.xs = [x.clone(memory_format=torch.contiguous_format) for x in xs]
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                _loop(step, self.h, self.xs)  # cuBLAS's handle and workspace for this stream
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                self.h_next, self.outs = _loop(step, self.h, self.xs)
        tracing.count("bvrnn.graph_captures")

    def __call__(self, h, xs):
        with torch.cuda.device(self.h.device):
            self.h.copy_(h)
            for buf, x in zip(self.xs, xs):
                buf.copy_(x)
            self.graph.replay()
        return self.h_next, self.outs


def _code_mask(cfg, y, var_bitrate, frame_valid):
    if cfg.var_bit:
        if var_bitrate is None:
            raise ValueError("var_bit config needs a bitrate")
        mask = bit_mask_from_bitrate(var_bitrate, cfg.z_dim, cfg.dtype)
    else:
        mask = torch.ones(y.shape[0], y.shape[1], cfg.z_dim, device=y.device, dtype=cfg.dtype)
    if frame_valid is not None:
        mask = mask * frame_valid.to(mask.dtype)[:, :, None]
    return mask


def _scan(params, cfg, y, var_bitrate, h, frame_valid=None, want_mel=False, want_states=False):
    """The greedy encode scan.  Returns the codes (B, T, z), the decoded mel
    (B, T, x) if ``want_mel`` (else None), the state before each frame (B,
    T, h) if ``want_states`` (else None), and the final state."""
    sp = prepare(params, cfg)
    prec = cfg.precision
    mask = _code_mask(cfg, y, var_bitrate, frame_valid)
    h = h.to(cfg.dtype)
    phi_x = phi_x_apply(sp.std, _normalize(sp.std, y.to(cfg.dtype)), prec)  # (B, T, h), hoisted
    fused = _use_fused(cfg, y.shape[0])
    cache = sp.graphs if params is sp else None  # a raw tree is prepared anew every call
    key = ("scan", fused, want_mel, want_states, prec)
    if fused:
        fp = _fused_params(sp)

        def step(h, encx_t, mask_t):
            e1h, d1h, gh = _fused_h_combo(fp, h, prec)
            z_t = _fused_enc(fp, encx_t, e1h, mask_t, prec)
            h_next, a3 = _fused_tail(fp, h, z_t, d1h, gh, prec)
            return h_next, (z_t, a3) + ((h,) if want_states else ())

        h, outs = _frames(step, h, [_matmul(phi_x, fp["w_enc1_x"], prec), mask], sp.traced,
                          cache=cache, key=key)
        mel = _fused_dec_seq(fp, outs[1], prec) if want_mel else None
    else:
        p = sp.std

        def step(h, phi_x_t, mask_t):
            enc_t = enc_apply(p, torch.cat([phi_x_t, h], -1), prec)
            z_t = _apply_bit_mask(torch.round(enc_t), mask_t)
            dec_t, h_next = _advance(p, z_t, h, prec)
            return h_next, (z_t, dec_t) + ((h,) if want_states else ())

        h, outs = _frames(step, h, [phi_x, mask], sp.traced, cache=cache, key=key)
        mel = outs[1] if want_mel else None
    return outs[0], mel, outs[2] if want_states else None, h


def encode(params, cfg, y, var_bitrate, h):
    """Greedy encode.  y: (B, T, x_dim); var_bitrate: (B, T) or None;
    h: (B, h_dim).  Returns (codes (B, T, z), h_seq (B, T, h)) where
    ``h_seq[:, t]`` is the state before frame t."""
    codes, _, hs, _ = _scan(params, cfg, y, var_bitrate, h, want_states=True)
    return codes, hs


def encode_with_state(params, cfg, y, var_bitrate, h):
    """Like :func:`encode` but returns the final hidden state."""
    codes, _, _, h_final = _scan(params, cfg, y, var_bitrate, h)
    return codes, h_final


def encode_decode(params, cfg, y, var_bitrate, h, frame_valid=None):
    """Encode and decode in one scan: (codes, decoded mel, final h).

    The encoder's closed loop already computes ``decode``'s output for the
    emitted codes.  ``frame_valid`` (B, T) forces the codes of invalid
    frames to 0.5 inside the scan, as ``decode`` sees 0.5-padded codes.
    """
    codes, mel, _, h_final = _scan(params, cfg, y, var_bitrate, h, frame_valid, want_mel=True)
    return codes, mel, h_final


def enc_from_states(params, cfg, y, h_seq):
    """The encoder's probabilities (before rounding and masking) each frame
    would get from the given states: frame t from ``h_seq[:, t]`` (B, T, h)
    instead of from the scan's own state, all frames in one batch."""
    sp = prepare(params, cfg)
    prec = cfg.precision
    h_seq = h_seq.to(cfg.dtype)
    phi_x = phi_x_apply(sp.std, _normalize(sp.std, y.to(cfg.dtype)), prec)
    if _use_fused(cfg, y.shape[0]):
        fp = _fused_params(sp)
        e1h, _, _ = _fused_h_combo(fp, h_seq, prec)
        return _fused_enc_prob(fp, _matmul(phi_x, fp["w_enc1_x"], prec), e1h, prec)
    return enc_apply(sp.std, torch.cat([phi_x, h_seq], -1), prec)


def codes_from_states(params, cfg, y, var_bitrate, h_seq):
    """The codes each frame would get from the given states
    (:func:`enc_from_states`, rounded and masked).  With another model's
    ``encode`` states this is the chaos-free comparison of two precisions: a
    trained closed loop amplifies any difference in its state, so
    free-running codes part after the first flip, while these differ only
    where the per-frame function does."""
    mask = _code_mask(cfg, y, var_bitrate, None)
    return _apply_bit_mask(torch.round(enc_from_states(params, cfg, y, h_seq)), mask)


def decode(params, cfg, z, h):
    """Codes (B, T, z_dim) -> (mel (B, T, x_dim), final h); phi_z per step.
    The fused cell runs the same (B, h) x (h, 5h) combo product as the
    encoder (its enc columns unused), so the decoder's state stays bitwise
    equal to the encoder's."""
    sp = prepare(params, cfg)
    prec = cfg.precision
    z, h = z.to(cfg.dtype), h.to(cfg.dtype)
    fused = _use_fused(cfg, z.shape[0])
    cache = sp.graphs if params is sp else None
    key = ("decode", fused, prec)
    if fused:
        fp = _fused_params(sp)

        def fused_step(h, z_t):
            _, d1h, gh = _fused_h_combo(fp, h, prec)
            h_next, a3 = _fused_tail(fp, h, z_t, d1h, gh, prec)
            return h_next, (a3,)

        h, (a3,) = _frames(fused_step, h, [z], sp.traced, cache=cache, key=key)
        return _fused_dec_seq(fp, a3, prec), h

    def step(h, z_t):
        dec_t, h_next = _advance(sp.std, z_t, h, prec)
        return h_next, (dec_t,)

    h, (mel,) = _frames(step, h, [z], sp.traced, cache=cache, key=key)
    return mel, h


def decode_plc(params, cfg, z, lost, h, conceal_bits=None, mode="expect", every_step=False):
    """:func:`decode` with packet-loss concealment from the BVRNN's prior.

    Frames flagged in ``lost`` (B, T) ignore their ``z`` entries and take
    codes from ``P(z_t | h_t)``: the probabilities in ``'expect'`` mode, or
    ``round(P)`` (half to even) in ``'map'`` mode, masked to
    ``conceal_bits`` (B, T) bits/frame (None: all ``z_dim`` bits) with
    masked bits at 0.5.  Received frames run exactly :func:`decode`'s
    step, so with no loss the output is bitwise :func:`decode`'s, and
    nothing before a stream's first lost frame changes.  The fused cell
    shares :func:`_fused_h_combo` / :func:`_fused_tail` with fused
    :func:`decode`; the prior stays the standard per-step MLP.  It runs
    only on steps where some stream lost its frame (read from ``lost`` once,
    before the loop), or, with ``every_step``, on every step, selected by
    ``torch.where`` alone: the form a traced program takes, which reads
    nothing of ``lost`` on the host.  Both forms give the same bits, since
    ``where`` returns a received frame's ``z`` exactly.  Returns (mel (B,
    T, x_dim), final h)."""
    if mode not in ("expect", "map"):
        raise ValueError(f"unknown concealment mode {mode!r}")
    sp = prepare(params, cfg)
    prec = cfg.precision
    B, T = z.shape[:2]
    z, h = z.to(cfg.dtype), h.to(cfg.dtype)
    lost = lost > 0
    if conceal_bits is not None:
        cmask = bit_mask_from_bitrate(conceal_bits, cfg.z_dim, cfg.dtype)
    else:
        cmask = torch.ones(B, T, cfg.z_dim, device=z.device, dtype=cfg.dtype)
    statics = None
    if not every_step:  # the steps where some stream lost its frame, read on the host
        with tracing.span("bvrnn.lost_read"):
            statics = [{"prior": v} for v in lost.any(0).tolist()]

    def codes_at(h, z_t, lost_t, cmask_t, prior):
        if not prior:
            return z_t
        prior_t = prior_apply(sp.std, h, prec)
        z_hat = torch.round(prior_t) if mode == "map" else prior_t
        return torch.where(lost_t[:, None], _apply_bit_mask(z_hat, cmask_t), z_t)

    xs = [z, lost, cmask]
    if _use_fused(cfg, B):
        fp = _fused_params(sp)

        def fused_step(h, z_t, lost_t, cmask_t, prior=True):
            z_t = codes_at(h, z_t, lost_t, cmask_t, prior)
            _, d1h, gh = _fused_h_combo(fp, h, prec)
            h_next, a3 = _fused_tail(fp, h, z_t, d1h, gh, prec)
            return h_next, (a3,)

        h, (a3,) = _frames(fused_step, h, xs, sp.traced, statics)
        return _fused_dec_seq(fp, a3, prec), h

    def step(h, z_t, lost_t, cmask_t, prior=True):
        dec_t, h_next = _advance(sp.std, codes_at(h, z_t, lost_t, cmask_t, prior), h, prec)
        return h_next, (dec_t,)

    h, (mel,) = _frames(step, h, xs, sp.traced, statics)
    return mel, h


# ---------------------------------------------------------------------------
# Training forward (scheduled sampling + Bernoulli KL)
# ---------------------------------------------------------------------------


def draw_train_noise(generator: torch.Generator, p_use_gen: float, frames: int, batch: int,
                     z_dim: int, dtype: torch.dtype = torch.float32):
    """The random draws of :func:`forward_train` from a (CPU) generator:
    ``use_gen`` (T,) bool, one uniform draw a frame shared across the batch
    below ``p_use_gen``, and ``bin_noise`` (T, B, z_dim) uniform in [0, 1),
    drawn in the compute dtype (as the reference draws it in bf16 mode)."""
    use_gen = torch.rand(frames, generator=generator) < p_use_gen
    bin_noise = torch.rand(frames, batch, z_dim, generator=generator, dtype=dtype)
    return use_gen, bin_noise


def _cast_tree(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree if tree.dtype == dtype else tree.to(dtype)


def _straight_through(enc_t, shifted_noise_t, greedy: bool):
    """Binarisation with a straight-through gradient: ``round`` (half to
    even, as ``jnp.round``) of ``enc`` or of ``(noise - 0.5) + enc``, the
    noise given shifted."""
    z_hard = torch.round(enc_t) if greedy else torch.round(shifted_noise_t + enc_t)
    return enc_t + (z_hard - enc_t).detach()


def _bernoulli_kld(enc, prior, mask):
    """Bernoulli KL(enc || prior) of (T, B, z) stacked frames, probabilities
    clamped at 1e-3, summed over the masked bits, a mean over the batch,
    then over the frames."""
    c = 1e-3
    kld_elem = enc * (
        torch.log(torch.clamp(enc, min=c)) - torch.log(torch.clamp(prior, min=c))
    ) + (1.0 - enc) * (
        torch.log(torch.clamp(1.0 - enc, min=c)) - torch.log(torch.clamp(1.0 - prior, min=c))
    )
    return torch.mean(torch.mean(torch.sum(kld_elem * mask, -1), -1))


def forward_train(params: Params, cfg: BVRNNConfig, y: torch.Tensor, use_gen: torch.Tensor,
                  greedy: bool, var_bitrate: torch.Tensor | None, bin_noise: torch.Tensor,
                  *, dtype: torch.dtype = torch.float32):
    """Training forward (``bvsc_tpu.models.bvrnn.forward_train``), with the
    random draws given (:func:`draw_train_noise`).

    Per frame, ``use_gen[t]`` picks the closed-loop state ``h2`` over the
    teacher-forced ``h`` (scheduled sampling, one choice for the whole
    batch); the binary bottleneck is straight-through (greedy rounding, or
    ``bin_noise``-sampled); ``h`` and ``h2`` advance through the one shared
    GRU; the Bernoulli KL(enc || prior) is clamped at 1e-3 and bit-masked
    under ``var_bit``.  ``dtype`` is the compute type: float32 trees given
    with ``torch.bfloat16`` are cast here (gradients flow back through the
    cast), and every product then takes bf16 operands to a bf16 result.
    ``cfg.fused_cell`` picks the fused step (the same objective,
    reassociated, its KL always in float32).  Returns (mel_hat (B, T,
    x_dim) in ``dtype``, scalar KLD: the mean over frames of each frame's
    batch mean)."""
    B = y.shape[0]
    if is_quantized(params):
        raise TypeError("forward_train needs float weights")
    params = _cast_tree(params, dtype)
    gen_steps = [bool(u) for u in use_gen.tolist()]
    # frame-major (T, B, z) bit mask, its 0.5 fill and the shifted noise,
    # made once (each as _apply_bit_mask and the rounding form them)
    mask = _code_mask(cfg, y, var_bitrate, None).to(dtype).transpose(0, 1)
    fill = 0.5 * (1.0 - mask)
    shifted = bin_noise - 0.5
    ynorm = _normalize(params, y.to(dtype))
    phi_x = phi_x_apply(params, ynorm)
    if _use_fused(cfg, B):
        return _forward_train_fused(params, cfg, phi_x, mask, fill, gen_steps, greedy, shifted)
    gru = params["gru"]
    h = h2 = torch.zeros(B, cfg.h_dim, dtype=dtype, device=y.device)
    decs, encs, priors = [], [], []
    # frames by unbind, whose backward is one stack (a slice's is a zero
    # fill of the whole sequence and a copy, every frame)
    for t, phi_x_t in enumerate(phi_x.unbind(1)):
        h_sel = h2 if gen_steps[t] else h
        enc_t = enc_apply(params, torch.cat([phi_x_t, h_sel], -1))
        z_t = _straight_through(enc_t, shifted[t], greedy) * mask[t] + fill[t]
        phi_z_t = phi_z_apply(params, z_t)
        dec_t = dec_apply(params, torch.cat([phi_z_t, h_sel], -1))
        phi_x_gen = phi_x_apply(params, _normalize(params, dec_t))
        encs.append(enc_t)
        priors.append(prior_apply(params, h_sel))
        h, h2 = (gru_step(gru, torch.cat([phi_x_t, phi_z_t], -1), h),
                 gru_step(gru, torch.cat([phi_x_gen, phi_z_t], -1), h2))
        decs.append(dec_t)
    return torch.stack(decs, 1), _bernoulli_kld(torch.stack(encs), torch.stack(priors), mask)


def _forward_train_fused(params, cfg, phi_x, mask, fill, gen_steps, greedy, shifted):
    """The fused-cell training step (``bvsc_tpu``'s ``_forward_train_fused``):
    the enc_l1 / prior_l1 / dec_l1 h-parts of the selected state in one
    product, both GRU hidden projections (h and h2) as one stacked (2B, h)
    product, enc_l1's phi_x part and the teacher GRU input gates over the
    whole sequence before the loop, and dec_l4 -> normalize -> phi_x_l1
    folded (``w_fold``), the mel one dec_l4 product after the loop."""
    B, H = phi_x.shape[0], cfg.h_dim
    dtype = phi_x.dtype
    fp = _cast_tree(_fuse_inference_params(params, cfg), dtype)
    gru = params["gru"]
    prior1, prior2, prior3 = params["prior"]
    w_hsel_combo = torch.cat([params["enc"][0]["w"][H:], prior1["w"],
                              params["dec"][0]["w"][H:]], dim=1)
    encx = _matmul(phi_x, fp["w_enc1_x"], "highest")
    gi_teach_top = _matmul(phi_x, fp["w_ih_top"], "highest")

    # chunk / split / unbind, whose backward is one cat or stack (a slice's
    # is a zero fill and a copy each)
    def gates(gi, gh, h):
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = _sigmoid(i_r + h_r)
        z = _sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    h = h2 = torch.zeros(B, H, dtype=dtype, device=phi_x.device)
    a3s, encs, priors = [], [], []
    for t, (encx_t, gi_top_t) in enumerate(zip(encx.unbind(1), gi_teach_top.unbind(1))):
        h_sel = h2 if gen_steps[t] else h
        e1h, p1h, d1h = _matmul(h_sel, w_hsel_combo, "highest").chunk(3, dim=-1)
        a = F.elu(encx_t + e1h + fp["b_enc1"])
        a = F.elu(_dense(fp["enc2"], a))
        enc_t = _sigmoid(_dense(fp["enc3"], a))
        p = F.elu(p1h + prior1["b"])
        p = F.elu(_dense(prior2, p))
        prior_t = _sigmoid(_dense(prior3, p))
        z_t = _straight_through(enc_t, shifted[t], greedy) * mask[t] + fill[t]

        pz = z_t
        for lyr in fp["phi_z"]:
            pz = F.elu(_dense(lyr, pz))
        d1z, gi_bot = _matmul(pz, fp["w_pz_combo"], "highest").split([H, 3 * H], dim=-1)
        d = F.elu(d1z + d1h + fp["b_dec1"])
        d = F.elu(_dense(fp["dec2"], d))
        a3 = F.elu(_dense(fp["dec3"], d))
        u = F.elu(_matmul(a3, fp["w_fold"], "highest") + fp["b_fold"])
        u = F.elu(_dense(fp["px2"], u))
        xg = F.elu(_dense(fp["px3"], u))
        gi_gen_top = _matmul(xg, fp["w_ih_top"], "highest")

        gh_h, gh_h2 = (_matmul(torch.cat([h, h2], 0), gru["w_hh"], "highest")
                       + fp["b_hh"]).chunk(2, dim=0)
        h, h2 = (gates(gi_top_t + gi_bot + fp["b_ih"], gh_h, h),
                 gates(gi_gen_top + gi_bot + fp["b_ih"], gh_h2, h2))
        a3s.append(a3)
        encs.append(enc_t)
        priors.append(prior_t)
    kld = _bernoulli_kld(torch.stack(encs).float(), torch.stack(priors).float(), mask.float())
    return _fused_dec_seq(fp, torch.stack(a3s, 1), "highest"), kld
