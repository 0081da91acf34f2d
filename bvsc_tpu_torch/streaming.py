"""Streaming runtime: chunked encode and decode at the 34.8 ms algorithmic
latency (port of ``bvsc_tpu/streaming.py``).

The codec is causal end to end (512-sample STFT lookahead + one 256-sample
hop = 34.8 ms at 22.05 kHz), so it streams with explicit carried state:

* streaming mel: a rolling 1024-sample window, one frame per 256-sample hop
  (reflect pre-roll at stream start; ``flush()`` reflects the tail like the
  one-shot right padding), through ``MelFrontend.log_mel``, the one-shot
  frontend's own arithmetic;
* streaming BVRNN: ``encode_with_state`` / ``decode`` / ``encode_decode``
  with the carried h;
* streaming vocoder: conv_pre and conv_post carry their left context and
  the four transposed convs their overlap-add tail, as the reference does
  (the bias is added after the overlap, to emitted samples only); each
  stage's residual stack runs the offline path's one stage function
  (``models.vocoder.Vocoder.stage``) over a carried stage context: on the
  kernel path the kernel (K1, or K1-bf16 in fast mode), on the direct path
  the plain blocks (with ``approx_snake`` and in the codec's
  ``voc_dtype``), which never reach a kernel.

**The stage context.**  The reference streams its residual stacks as XLA
convs, one left-context buffer per conv (18 a stage).  K1 takes a stage's
input, not a conv's: it computes a whole block, halo included, from the
block's input.  So each stage, on either path, carries the last ``CTX``
samples of its input, ``CTX`` the largest of its blocks' halos
(``ops.amp_resblock.halo``: 24, 72 and 120 for k = 3, 7 and 11), and the
count of samples each row's stream fed it (``fed``, saturating at
``CTX``, past which the start mask passes everything).  A step runs the
stage's blocks on [context | new samples] with ``ctx=CTX, start=fed``,
which returns only the new outputs, then rolls
the context.  The outputs are the per-conv buffers' outputs; only the
state's layout differs.  A per-row ``start`` lets rows of one state begin
at different ticks, as a batched serving engine's slots do.

**Numerics.**  Within the port, streaming equals one-shot: the codes
bitwise and the waveform to the overlap-add's reordered sums (≤1e-5 at
parity).  A frame whose analysis window reaches past the input's end (the
last two) reads the reflected tail here, while the one-shot path reads the
zeros of its length bucket there (``BVRNNCodecModel._pad_length``), as in
the reference; the two agree on those frames only when the input length is
a multiple of the bucket.  ``fused_cell='auto'`` picks the cell by batch
(``models.bvrnn._use_fused``), so a stream and a one-shot call at the same
batch run the same cell, and a serving engine at B >= 32 runs the standard
one.  Nothing here changes the process-wide TF32 flags.

The vocoder state is in the codec's vocoder segment's type
(:func:`voc_state_dtype`): float32, or bf16 on a direct path with
``voc_dtype='bf16'`` and, under the bf16 storage dtype, on either path (the
kernels then take the stage windows in bf16 and return bf16).  The
BVRNN's state ``h`` is in the storage dtype.  ``StreamingEncoder.feed``
returns float32 codes under either storage dtype (the values 0, 0.5 and 1
are exact in both): its callers hand codes to numpy, which has no bf16.  The symmetric and anti-aliased vocoder variants
look ahead, so they do not stream (ValueError, as in the reference).  Every
class runs on its codec's device and returns tensors there; a CUDA codec on
the kernel path launches the kernels, a ``device='cpu'`` codec takes their
plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from bvsc_tpu_torch.codec import SCALING, CodecWeights, _host_array
from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.device import resolve_device
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod
from bvsc_tpu_torch.models.vocoder import Vocoder, activation
from bvsc_tpu_torch.ops.amp_resblock import halo
from bvsc_tpu_torch.ops.conv import conv1d, conv_transpose1d
from bvsc_tpu_torch.ops.snake import leaky_relu
from bvsc_tpu_torch.utils import tracing

# Not called here: every stage runs models.vocoder.Vocoder.stage.  The
# benchmark (portbench/lib/program.py:stage_ranges) wraps these two names on
# this module as well as on models.vocoder, and raises where one is missing.
from bvsc_tpu_torch.models.vocoder import amp_block, amp_stack  # noqa: E402,F401

# ---------------------------------------------------------------------------
# Streaming vocoder: state init + step
# ---------------------------------------------------------------------------


def voc_compute_dtype(codec) -> torch.dtype:
    """The streaming vocoder's residual-stack mode for this codec: its
    offline one (float32 at parity, bf16 in fast serving)."""
    return codec.voc_compute_dtype


def voc_state_dtype(codec) -> torch.dtype:
    """The streaming vocoder state's type: the codec's vocoder segment's,
    bf16 under the bf16 storage dtype (on the kernel path too: the kernels
    take bf16 in and out) and on a direct path with ``voc_dtype='bf16'``,
    else float32."""
    return codec.weights.voc_dtype


def stage_context(cfg: VocoderConfig) -> int:
    """Samples of input a stage carries: its blocks' largest halo."""
    return max(halo(k, d) for k, d in zip(cfg.resblock_kernel_sizes,
                                          cfg.resblock_dilation_sizes))


def _conv_state(batch: int, ch: int, k: int, dilation: int, device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Left-context buffer of (k-1)*dilation zeros (== one-shot zero pads)."""
    return torch.zeros(batch, ch, (k - 1) * dilation, device=device, dtype=dtype)


def _stream_conv(state: torch.Tensor, x: torch.Tensor, p: dict, dilation: int = 1,
                 precision: str = "highest"):
    """Causal conv step: consume (B, C, T), emit (B, C', T), carry context."""
    ctx = torch.cat([state, x], -1)
    y = conv1d(ctx, p, dilation=dilation, precision=precision)
    return ctx[..., ctx.shape[-1] - state.shape[-1]:], y


def _stream_conv_transpose(state: torch.Tensor, x: torch.Tensor, p: dict, stride: int,
                           precision: str = "highest"):
    """Transposed-conv step with overlap-add carry: emits exactly
    stride * T finalized samples and carries the (k - stride)-sample tail
    that later inputs still add into.  The bias is added to emitted samples
    only, after the overlap, so the overlap region counts it once."""
    y = conv_transpose1d(x, {"w": p["w"]}, stride=stride,
                         precision=precision)  # (B, C', (T-1)s + k)
    overlap = p["w"].shape[-1] - stride
    if overlap:
        y[..., :overlap] += state
    emit_len = stride * x.shape[-1]
    emit = y[..., :emit_len]
    if p.get("b") is not None:
        emit = emit + p["b"][None, :, None]
    return y[..., emit_len: emit_len + overlap], emit


def _stream_stage(state: dict, x: torch.Tensor, voc: Vocoder, i: int):
    """Stage ``i``'s residual stack on new samples x (B, C, T) over its
    carried context (module docstring): ``voc.stage`` on (B, C, ctx + T)
    -> (B, C, T), the span ``vocoder.stage``."""
    ctx = state["ctx"].shape[-1]
    window = torch.cat([state["ctx"], x], -1)
    with tracing.span("vocoder.stage"):
        y = voc.stage(i, window, ctx=ctx, start=state["fed"])
    fed = torch.clamp(state["fed"] + x.shape[-1], max=ctx)
    return {"ctx": window[..., -ctx:], "fed": fed}, y


def generator_stream_init(cfg: VocoderConfig, batch: int, device=None,
                          dtype: torch.dtype = torch.float32) -> dict:
    """Zero state for the streaming generator (causal configs only), on
    ``device`` (default CUDA, which raises without a card), its buffers in
    ``dtype`` (:func:`voc_state_dtype`)."""
    if any(cfg.layers_sym) or cfg.pre_sym or cfg.post_sym:
        raise ValueError("streaming requires a fully causal vocoder config")
    if any(cfg.layers_antialias) or cfg.antialias_post:
        raise ValueError("streaming is incompatible with anti-aliased activations")
    device = resolve_device(device)
    C0 = cfg.upsample_initial_channel
    ctx = stage_context(cfg)
    state: dict = {"conv_pre": _conv_state(batch, cfg.num_mels, 7, 1, device, dtype),
                   "ups": [], "stages": []}
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        out_ch = C0 // (2 ** (i + 1))
        state["ups"].append(torch.zeros(batch, out_ch, k - u, device=device, dtype=dtype))
        state["stages"].append({"ctx": torch.zeros(batch, out_ch, ctx, device=device,
                                                   dtype=dtype),
                                "fed": torch.zeros(batch, dtype=torch.int32, device=device)})
    ch = C0 // (2 ** len(cfg.upsample_rates))
    state["conv_post"] = _conv_state(batch, ch, 7, 1, device, dtype)
    return state


def generator_stream_step(voc: Vocoder, state: dict, mel: torch.Tensor, *,
                          precision: str = "highest"):
    """Consume (B, num_mels, T) mel frames, emit (B, 1, T * prod(upsample))
    finalized samples (the one-shot output's next ones), on the prepared
    generator ``voc`` (``models.vocoder.prepare_vocoder``: its path, stack
    mode and ``approx_snake``), in the dtype of its params, ``mel`` and
    ``state``.  ``precision`` sets conv_pre, the upsamplers and conv_post,
    as in ``models.vocoder.generator_apply``.  Returns (new state,
    waveform); the span ``vocoder``."""
    params, cfg = voc.params, voc.cfg
    with tracing.span("vocoder"):
        # the new state's keys in generator_stream_init's order (a traced
        # program's state input and output share one tree layout)
        new: dict = {"conv_pre": None, "ups": [], "stages": [], "conv_post": None}
        new["conv_pre"], x = _stream_conv(state["conv_pre"], mel, params["conv_pre"],
                                          precision=precision)
        for i, u in enumerate(cfg.upsample_rates):
            if cfg.activation == "lrelu":
                x = leaky_relu(x)
            st, x = _stream_conv_transpose(state["ups"][i], x, params["ups"][i], u, precision)
            new["ups"].append(st)
            st, x = _stream_stage(state["stages"][i], x, voc, i)
            new["stages"].append(st)
        x = activation(x, params["act_post"], cfg, voc.approx)
        new["conv_post"], x = _stream_conv(state["conv_post"], x, params["conv_post"],
                                           precision=precision)
        return new, torch.tanh(x)


def _vocode_step(w: CodecWeights, state: dict, mel: torch.Tensor):
    """Decoded mel (B, T, M) -> (new vocoder state, float32 waveform (B, T *
    hop)), on the codec's weights ``w`` (``codec.CodecWeights``) and path."""
    state, wav = generator_stream_step(w.vocoder, state,
                                       mel.transpose(1, 2).contiguous().to(w.voc_dtype),
                                       precision=w.precision)
    return state, wav[:, 0, :].to(torch.float32) / SCALING


def vocoder_state(codec, batch: int, device=None) -> dict:
    """The zero streaming vocoder state of ``batch`` rows for ``codec``, on
    ``device`` (default the codec's) and in :func:`voc_state_dtype`."""
    return generator_stream_init(codec.conf.vocoder_config, batch,
                                 codec.device if device is None else device,
                                 voc_state_dtype(codec))


# ---------------------------------------------------------------------------
# Streaming encoder, decoder and packet codec
# ---------------------------------------------------------------------------


class StreamingEncoder:
    """Samples in -> binary codes out, one code vector per 256-sample hop.

    The first code comes once ``winsize - pad_left = 768`` samples have
    arrived (the 512-sample lookahead + one hop = 34.8 ms at 22.05 kHz).
    Samples queue on the host; codes come back on the codec's device, as
    float32 under either storage dtype (module docstring).
    """

    def __init__(self, codec, batch: int = 1, bitrate: float = 3000.0):
        self.codec = codec
        conf = codec.conf
        self.hop = conf.hopsize
        self.win = conf.winsize
        self.pad_left = conf.mel_pad_left
        self.pad_right = conf.winsize - conf.mel_pad_left - conf.hopsize
        self.bits = codec.bits_per_frame(bitrate)
        self.batch = batch
        self.h = codec._h0(batch)
        # host-side raw sample queue holding the padded stream tail
        self._buf = np.zeros((batch, 0), np.float32)
        self._started = False
        self._flushed = False

    def _none(self) -> torch.Tensor:
        return torch.zeros(self.batch, 0, self.codec.conf.z_dim, device=self.codec.device)

    @torch.no_grad()
    def feed(self, samples) -> torch.Tensor:
        """Push (batch, n) samples; returns (batch, n_new_frames, z_dim) codes
        (possibly zero frames)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        samples = _host_array(samples).reshape(self.batch, -1)
        if not self._started:
            if self._buf.shape[1] + samples.shape[1] < self.pad_left + 1:
                self._buf = np.concatenate([self._buf, samples], axis=1)
                return self._none()
            x = np.concatenate([self._buf, samples], axis=1)
            # reflect pre-roll, identical to the one-shot left padding
            pre = x[:, 1: self.pad_left + 1][:, ::-1]
            self._buf = np.concatenate([pre, x], axis=1)
            self._started = True
        else:
            self._buf = np.concatenate([self._buf, samples], axis=1)
        return self._drain()

    @torch.no_grad()
    def flush(self) -> torch.Tensor:
        """Reflect-pad the tail (the one-shot right padding) and emit the
        rest."""
        if not self._started or self._flushed:
            raise RuntimeError("flush() needs a started stream, once")
        self._flushed = True
        tail = self._buf[:, -self.pad_right - 1: -1][:, ::-1]
        self._buf = np.concatenate([self._buf, tail], axis=1)
        return self._drain()

    def _drain(self) -> torch.Tensor:
        n = (self._buf.shape[1] - self.win) // self.hop + 1
        if n <= 0:
            return self._none()
        seg = self._buf[:, : (n - 1) * self.hop + self.win]
        self._buf = self._buf[:, n * self.hop:]
        codec = self.codec
        x = torch.as_tensor(np.ascontiguousarray(seg), device=codec.device) * SCALING
        mel = codec.frontend.log_mel(x.unfold(-1, self.win, self.hop)).transpose(1, 2)
        bits = torch.full((self.batch, n), self.bits, device=codec.device)
        codes, self.h = bvrnn_mod.encode_with_state(codec.scan_params, codec.bvrnn_cfg, mel,
                                                    bits, self.h)
        return codes.to(torch.float32)


class StreamingDecoder:
    """Binary codes in -> waveform out, 256 samples per code frame.

    conceal_bitrate: bps, a scalar or per stream (batch,), masking
    concealed frames to the stream's real bit allocation (the receiver
    knows it); None conceals with all ``z_dim`` prior bits."""

    def __init__(self, codec, batch: int = 1, conceal_bitrate=None):
        self.codec = codec
        conf = codec.conf
        self.batch = batch
        self.h = codec._h0(batch)
        self.voc_state = vocoder_state(codec, batch)
        # conceal_bits == z_dim is "all prior bits" (the mask saturates), so
        # one code path serves both cases
        cb = (float(conf.z_dim) if conceal_bitrate is None
              else codec.bits_per_frame(conceal_bitrate))
        self.conceal_bits = torch.broadcast_to(
            torch.as_tensor(cb, dtype=torch.float32, device=codec.device), (batch,))

    @torch.no_grad()
    def feed(self, codes, lost=None) -> torch.Tensor:
        """Push (batch, n, z_dim) code frames; returns (batch, n * hop)
        samples.

        lost: optional (batch, n) 0/1 mask of frames whose packets never
        arrived; their codes are ignored and concealed from the BVRNN's prior
        (``models.bvrnn.decode_plc``)."""
        codec = self.codec
        codes = torch.as_tensor(codes, dtype=torch.float32, device=codec.device)
        B, T = codes.shape[:2]
        if T == 0:
            return torch.zeros(self.batch, 0, device=codec.device)
        if lost is not None:
            lost = torch.as_tensor(_host_array(lost).reshape(B, T), device=codec.device)
            mel, self.h = bvrnn_mod.decode_plc(
                codec.scan_params, codec.bvrnn_cfg, codes, lost, self.h,
                self.conceal_bits[:, None].expand(B, T))
        else:
            mel, self.h = bvrnn_mod.decode(codec.scan_params, codec.bvrnn_cfg, codes, self.h)
        self.voc_state, wav = _vocode_step(codec.weights, self.voc_state, mel)
        return wav

    def conceal(self, n_frames: int = 1) -> torch.Tensor:
        """Audio for ``n_frames`` lost packets: the decoder free-runs on the
        prior's expected codes and the vocoder keeps streaming, 256 samples
        per lost frame, with no gap in the output."""
        codes = torch.full((self.batch, n_frames, self.codec.conf.z_dim), 0.5,
                           device=self.codec.device)
        return self.feed(codes, lost=np.ones((self.batch, n_frames), np.float32))


def _fused_packet_step(w: CodecWeights, state: dict, chunk: torch.Tensor, bits: torch.Tensor):
    """One 256-sample packet on the codec's weights ``w``: window roll ->
    mel of one frame -> the BVRNN's ``encode_decode`` at T = 1 -> streaming
    vocoder step.

    state: {window (B, 1024), h (B, h_dim), voc (vocoder state)}.  One GRU
    state serves both ends: the closed loop keeps the encoder's and the
    decoder's states equal given the codes, so ``encode_decode`` emits the
    codes and the decoded mel in one pass.  Returns (state, codes (B, z),
    waveform (B, 256))."""
    hop = chunk.shape[-1]
    window = torch.cat([state["window"][:, hop:], chunk], -1)
    mel = w.frontend.log_mel((window * SCALING)[:, None, :]).transpose(1, 2)  # (B, 1, M)
    codes, mel_hat, h = bvrnn_mod.encode_decode(w.scan, w.bvrnn_cfg, mel, bits[:, None],
                                                state["h"])
    voc, wav = _vocode_step(w, state["voc"], mel_hat)
    return {"window": window, "h": h, "voc": voc}, codes[:, 0, :], wav


def _packet_decode_step(w: CodecWeights, state: dict, codes: torch.Tensor, lost: torch.Tensor,
                        cbits: torch.Tensor, every_step: bool = False):
    """The receiver's step on the codec's weights ``w``: codes (B, T, z)
    with lost-frame flags (B, T) and concealment bits/frame (B,) ->
    ``decode_plc`` -> streaming vocoder step.  state: {h (B, h_dim), voc}.
    ``every_step`` is ``decode_plc``'s traceable form.  Returns (state,
    waveform (B, T * hop))."""
    cb = cbits[:, None].expand(codes.shape[0], codes.shape[1])
    mel, h = bvrnn_mod.decode_plc(w.scan, w.bvrnn_cfg, codes, lost, state["h"], cb,
                                  every_step=every_step)
    voc, wav = _vocode_step(w, state["voc"], mel)
    return {"h": h, "voc": voc}, wav


class FusedPacketCodec:
    """Real-time packet codec: samples in, resynthesised samples out, one
    step per 11.6 ms packet.

    The rolling mel window lives on the device inside the state, so per
    packet only 256 samples cross to the device.  Output equals the
    one-shot ``codec(x, bitrate)`` (module docstring)."""

    def __init__(self, codec, batch: int = 1, bitrate: float = 3000.0):
        self.codec = codec
        conf = codec.conf
        self.hop = conf.hopsize
        self.winsize = conf.winsize
        self.pad_left = conf.mel_pad_left
        self.pad_right = conf.winsize - conf.mel_pad_left - conf.hopsize
        self.batch = batch
        dev = codec.device
        self.bits = torch.full((batch,), codec.bits_per_frame(bitrate), device=dev)
        self.state = {
            "window": torch.zeros(batch, conf.winsize, device=dev),
            "h": codec._h0(batch),
            "voc": vocoder_state(codec, batch),
        }
        self._prefix = np.zeros((batch, 0), np.float32)
        self._tail = np.zeros((batch, 0), np.float32)  # last pad_right + 1 samples
        self._started = False
        self._flushed = False

    def _step(self, chunk: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """One packet through :func:`_fused_packet_step`: (codes, waveform)."""
        chunk = torch.as_tensor(np.ascontiguousarray(chunk), device=self.codec.device)
        self.state, codes, wav = _fused_packet_step(self.codec.weights, self.state, chunk,
                                                    self.bits)
        return codes, wav

    def _none(self) -> torch.Tensor:
        return torch.zeros(self.batch, 0, device=self.codec.device)

    @torch.no_grad()
    def process(self, samples) -> torch.Tensor:
        """Push (batch, n) samples; returns the decoded audio of every frame
        completed (possibly none)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        samples = _host_array(samples).reshape(self.batch, -1)
        self._tail = np.concatenate([self._tail, samples], axis=1)[:, -(self.pad_right + 1):]
        if self._started:
            return self._drain(samples)
        self._prefix = np.concatenate([self._prefix, samples], axis=1)
        need = self.winsize - self.pad_left  # 768
        if self._prefix.shape[1] < need:
            return self._none()
        x = self._prefix
        # the first frame's window: [reflect pre-roll | x[:768]]; pre-load the
        # state so that rolling in its last hop reproduces it exactly
        pre = x[:, 1: self.pad_left + 1][:, ::-1]
        window0 = np.concatenate([pre, x[:, :need]], axis=1)
        preload = np.concatenate([np.zeros((self.batch, self.hop), np.float32),
                                  window0[:, : -self.hop]], axis=1)
        self.state["window"] = torch.as_tensor(preload, device=self.codec.device)
        outs = [self._step(window0[:, -self.hop:])[1]]
        self._started = True
        self._prefix = np.zeros((self.batch, 0), np.float32)
        if x.shape[1] > need:
            outs.append(self._drain(x[:, need:]))
        return torch.cat(outs, 1)

    def _drain(self, samples: np.ndarray) -> torch.Tensor:
        self._prefix = np.concatenate([self._prefix, samples], axis=1)
        outs = []
        while self._prefix.shape[1] >= self.hop:
            outs.append(self._step(self._prefix[:, : self.hop])[1])
            self._prefix = self._prefix[:, self.hop:]
        return torch.cat(outs, 1) if outs else self._none()

    @torch.no_grad()
    def flush(self) -> torch.Tensor:
        """Reflect-pad the tail (the one-shot right padding).  Exactly two
        more frames belong to the one-shot output: the last one-shot frame's
        window ends where the reflected padding ends."""
        if not self._started or self._flushed:
            raise RuntimeError("flush() needs a started stream, once")
        self._flushed = True
        tail = self._tail[:, -self.pad_right - 1: -1][:, ::-1]
        pad = (-(self._prefix.shape[1] + tail.shape[1])) % self.hop
        ext = np.concatenate([tail, np.zeros((self.batch, pad), np.float32)], axis=1)
        return self._drain(ext)[:, : 2 * self.hop]


class StreamingCodec:
    """Full-duplex convenience wrapper: samples -> codes -> samples."""

    def __init__(self, codec, batch: int = 1, bitrate: float = 3000.0):
        self.encoder = StreamingEncoder(codec, batch, bitrate)
        self.decoder = StreamingDecoder(codec, batch)

    def process(self, samples) -> torch.Tensor:
        return self.decoder.feed(self.encoder.feed(samples))

    def flush(self) -> torch.Tensor:
        return self.decoder.feed(self.encoder.flush())
