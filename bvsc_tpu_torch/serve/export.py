"""AOT serving bundles: the codec's programs as ``torch.export`` programs,
stored with their weights in one ``.bvscx`` file.

Port of ``bvsc_tpu/serve/export.py``.  A serving host reloads the file with
:class:`ServingBundle`: no model code, converter or config parsing runs at
serve time, only the exported ATen graphs and the two residual-stack custom
ops (``torch.ops.bvsc_torch.amp_resblock_f32`` / ``_bf16``, registered by
``bvsc_tpu_torch.ops.amp_resblock``), which launch K1 or K1-bf16 on a card
as the live path does, and count their launches the same way (the
anti-aliased activation's op, ``bvsc_torch::antialias_act`` of
``ops.resample``, is the same kind, but no exported codec calls it).

Bundle contents (``meta.json`` is the manifest, format :data:`FORMAT`):

* per length bucket, batched one-shot programs ``encode`` / ``decode`` /
  ``forward`` (mel -> the one-scan ``encode_decode`` -> vocoder) /
  ``vocode`` (mel -> waveform, unscaled), traced from
  ``codec._encode_impl``, ``_decode_impl``, ``_forward_impl`` and
  ``_generator_impl``: the functions the live methods call;
* the packet programs at batch 1: ``packet_step``
  (``streaming._fused_packet_step``) and ``packet_decode_step``
  (``streaming._packet_decode_step``: ``decode_plc`` in its traceable
  form, then the streaming vocoder);
* with ``engine_batch=N``, the engines' ticks for N slots: ``engine_tick``
  (``serve.engine._fused_tick``) and ``engine_decode_tick``
  (``_decode_tick``), traced with a symbolic slot count (the manifest's
  ``engine.slots`` range), so that an engine with ``mesh=`` runs them on
  blocks of N / devices slots;
* the weights once, as program inputs (``params/weights.npz``, keyed by
  their path in ``codec.CodecWeights.tree()``): the mel frontend's window
  and DFT/mel bases, the scan's prepared weights and, on the kernel path,
  the residual stacks' packed kernel weights, or on the direct path the
  whole prepared generator (``models.vocoder.prepare_direct_params``), each
  in the dtype its program reads (bf16 stored as its 16 bits, the dtype in
  the manifest), so loading does no relayout.  An int8 codec's weights are
  stored as ``models.bvrnn.prepare`` widens them (exact).  The manifest's
  ``serving`` entry records the numerics, ``use_pallas``, ``approx_snake``,
  ``voc_dtype`` and the storage ``dtype`` among them; a bundle without
  ``use_pallas`` ran the kernels, one without ``dtype`` is float32.  A
  bf16-storage bundle holds bf16 weights and bf16 state, and its ``vocode``
  program casts its mel to the vocoder weights' type (the reference's
  ``vocode`` program raises a TypeError there: a float32 mel meets bf16
  weights in its first conv).  A codec whose vocoder looks ahead (not
  ``VocoderConfig.causal``: symmetric or anti-aliased, the full BigVGAN)
  does not export: the live codec vocodes only a clip's own frames
  (``codec._generator_impl``), a program only its bucket's.

The BVRNN's frame loops are traced as ``torch._higher_order_ops.scan`` over
the live path's own step function (``models.bvrnn._frames``), so a program
holds one step whatever its bucket's frame count: export, save and load
take about as long for 256 frames as for 16.  The manifest records the
shapes and dtypes of the packet and engine state trees; the loader builds
their zeros.  Programs hold the shapes they were traced at (batch, length
buckets); ``batch=None`` traces the one-shot programs with a symbolic
batch.  Each program is traced on the codec's
device and moved to the serving device at load
(``torch.export.passes.move_to_device_pass``); in fast mode
(``precision='default'``) a bf16 product traced on the CPU stays the CPU's
form (a float32 product of bf16-rounded operands) on a card, where the live
path takes one bf16 GEMM.

``bvsc_tpu``'s bundles (format ``"bvsc-serve-1"``, StableHLO) are refused
here, naming ``bvsc_tpu.serve.ServingBundle``; ``bvsc_tpu`` refuses this
format as unknown.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import time
import zipfile

import numpy as np
import torch

from bvsc_tpu_torch.codec import (_decode_impl, _encode_impl, _forward_impl, _generator_impl,
                                  _host_array, bits_per_frame, frame_bits)
from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.device import canonical, resolve_device, set_parity_mode
from bvsc_tpu_torch.ops import amp_resblock  # noqa: F401  (registers the ops the programs call)
from bvsc_tpu_torch.ops.precision import cudnn_fp32
from bvsc_tpu_torch.models.bvrnn import FUSED_AUTO_MAX_B
from bvsc_tpu_torch.serve.engine import (DecodeEngine, ServingEngine, _decode_tick, _fused_tick,
                                         slot_blocks)
from bvsc_tpu_torch.streaming import (FusedPacketCodec, _fused_packet_step, _packet_decode_step,
                                      vocoder_state)

FORMAT = "bvsc-serve-torch-1"
BVSC_TPU_FORMAT = "bvsc-serve-1"
WEIGHTS = "params/weights.npz"
MAX_BATCH = 65535  # a symbolic batch's bound: the kernels' grid dimension
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
# what a malformed bundle raises while it is read
_MALFORMED = (zipfile.BadZipFile, KeyError, json.JSONDecodeError, OSError, TypeError,
              AttributeError, IndexError, EOFError)


# ---------------------------------------------------------------------------
# trees of tensors <-> flat, '/'-keyed lists
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key, tensor) pairs of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flatten(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(items) -> dict:
    """Inverse of :func:`_flatten` (digit keys are list indices)."""
    tree: dict = {}
    for key, value in items:
        *path, last = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _specs(tree) -> list:
    """[key, shape, dtype] of every leaf: a state tree in the manifest."""
    return [[k, list(t.shape), _dtype_name(t.dtype)] for k, t in _flatten(tree)]


def _zeros(specs, device) -> dict:
    return _unflatten((k, torch.zeros(shape, dtype=_DTYPES[dtype], device=device))
                      for k, shape, dtype in specs)


def _batch_dims(tree, dim):
    """``{0: dim}`` for every tensor of a tree: a ``dynamic_shapes`` entry
    with the batch symbolic on every leaf."""
    if isinstance(tree, dict):
        return {k: _batch_dims(v, dim) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_batch_dims(v, dim) for v in tree]
    return {0: dim}


def _slot_range(codec, slots: int) -> tuple[int, int]:
    """The slot counts an engine program traced at ``slots`` serves: any
    with a pinned ``fused_cell``; with ``'auto'``, which picks the cell by
    batch, those on the same side of its threshold.  One slot traces
    static (torch.export specialises a traced size of 1)."""
    if slots == 1:
        return 1, 1
    if codec.fused_cell != "auto":
        return 1, MAX_BATCH
    return (1, FUSED_AUTO_MAX_B - 1) if slots < FUSED_AUTO_MAX_B else (FUSED_AUTO_MAX_B, MAX_BATCH)


def _weights_npz(items) -> bytes:
    """The weights as an npz, bf16 as its 16 bits."""
    arrays = {}
    for key, t in items:
        t = t.detach().cpu().contiguous()
        arrays[key] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


class _Program(torch.nn.Module):
    """``fn(weights, *inputs)`` with the weights as one list of tensors, in
    the bundle's order: the exported module's inputs.  The codec's own
    tensors are never read, so none is baked into the program."""

    def __init__(self, fn, weights, keys: list[str]):
        super().__init__()
        self._fn, self._w, self._keys = fn, weights, keys

    def forward(self, weights: list, *inputs):
        w = self._w.with_tree(_unflatten(zip(self._keys, weights)), traced=True)
        return self._fn(w, *inputs)


def export_serving_bundle(codec, path: str, *, batch: int | None = 1,
                          lengths: tuple[int, ...] = (2 ** 16,), packet: bool = True,
                          engine_batch: int | None = None) -> dict:
    """Export ``codec`` (a port ``BVRNNCodecModel``) to a ``.bvscx`` bundle
    at ``path``, tracing on the codec's device.  Returns the manifest.

    ``lengths`` are sample counts, each rounded up to the codec's length
    bucket: one program of each one-shot kind per bucket.  ``batch=None``
    traces the one-shot programs with a symbolic batch (1 to
    :data:`MAX_BATCH`); that needs a pinned ``fused_cell``, since ``'auto'``
    picks the cell by batch size.  The packet programs run at batch 1;
    ``engine_batch=N`` adds both engines' ticks for N slots, traced with a
    symbolic slot count (:func:`_slot_range`).  A codec whose vocoder looks
    ahead raises ValueError (module docstring)."""
    if not codec.conf.vocoder_config.causal:
        raise ValueError("the codec's vocoder looks ahead (symmetric or anti-aliased): its "
                         "programs would vocode the length bucket's frames where the live "
                         "codec vocodes a clip's own, so it does not export")
    if batch is None and codec.fused_cell == "auto":
        raise ValueError("batch=None (a symbolic batch) needs a pinned fused_cell: 'auto' picks "
                         "the cell by batch size; build the codec with fused_cell=True or False")
    conf, w, dev = codec.conf, codec.weights, codec.device
    items = _flatten(w.tree())
    keys, weights = [k for k, _ in items], [t for _, t in items]
    # a symbolic batch is traced at 2 (a traced 1 would be specialised)
    B = 2 if batch is None else int(batch)
    pb = 1  # a live session is one row; an engine serves many
    dim = None if batch is not None else torch.export.Dim("batch", min=1, max=MAX_BATCH)
    blobs: dict[str, bytes] = {}
    seconds: dict[str, float] = {}

    def export(name: str, fn, *inputs, batched=(), batch_dim=None):
        """One program: ``fn(weights, *inputs)``, the inputs at positions
        ``batched`` (every leaf of a tree input) with ``batch_dim`` (the
        one-shot programs' symbolic batch by default) on their first
        axis."""
        bdim = dim if batch_dim is None else batch_dim
        dynamic = None
        if bdim is not None and batched:
            dynamic = ([None] * len(weights), tuple(
                _batch_dims(x, bdim) if i in batched else None for i, x in enumerate(inputs)))
        t0 = time.perf_counter()
        with torch.no_grad():
            ep = torch.export.export(_Program(fn, w, keys), (weights, *inputs),
                                     dynamic_shapes=dynamic)
        if ep.state_dict or ep.constants:
            raise RuntimeError(f"{name}: the trace baked tensors into the program "
                               f"({sorted(ep.state_dict) + sorted(ep.constants)})")
        ep.example_inputs = None  # else saved with the program: the weights again
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        blobs[f"programs/{name}.pt2"] = buf.getvalue()
        seconds[name] = time.perf_counter() - t0
        return f"programs/{name}.pt2"

    buckets, seen = [], set()
    for length in sorted(int(x) for x in lengths):
        Lp = codec._pad_length(length)
        if Lp in seen:
            continue
        seen.add(Lp)
        Tp = codec.frontend.num_frames(Lp)
        x = torch.zeros(B, Lp, device=dev)
        bits = torch.zeros(B, Tp, device=dev)
        codes = torch.full((B, Tp, conf.z_dim), 0.5, device=dev)
        mel = torch.zeros(B, conf.num_mels, Tp, device=dev)
        n = torch.tensor(Tp, device=dev)
        names = {
            "encode": export(f"encode_{Lp}", _encode_impl, x, bits, batched=(0, 1)),
            "decode": export(f"decode_{Lp}", lambda w, c, Lp=Lp: _decode_impl(w, c, Lp), codes,
                             batched=(0,)),
            "forward": export(f"forward_{Lp}",
                              lambda w, x, b, n, Lp=Lp: _forward_impl(w, x, b, n, Lp),
                              x, bits, n, batched=(0, 1)),
            "vocode": export(f"vocode_{Lp}", lambda w, m, Lp=Lp: _generator_impl(w, m, Lp), mel,
                             batched=(0,)),
        }
        buckets.append({"length": Lp, "frames": Tp, "programs": names})

    def state(rows, window: bool) -> dict:
        tree = {"window": torch.zeros(rows, conf.winsize, device=dev)} if window else {}
        return {**tree, "h": torch.zeros(rows, conf.h_dim, device=dev, dtype=codec.dtype),
                "voc": vocoder_state(codec, rows)}

    packet_meta = None
    if packet:
        s0, d0 = state(pb, True), state(pb, False)
        packet_meta = {
            "batch": pb,
            "step": export("packet_step", _fused_packet_step, s0,
                           torch.zeros(pb, conf.hopsize, device=dev), torch.zeros(pb, device=dev)),
            "decode_step": export(
                "packet_decode_step",
                lambda w, s, c, lost, cb: _packet_decode_step(w, s, c, lost, cb, every_step=True),
                d0, torch.full((pb, 1, conf.z_dim), 0.5, device=dev),
                torch.zeros(pb, 1, device=dev), torch.zeros(pb, device=dev)),
            "state": _specs(s0), "decode_state": _specs(d0),
        }

    engine_meta = None
    if engine_batch:
        EB = int(engine_batch)
        lo, hi = _slot_range(codec, EB)
        slots = None if lo == hi else torch.export.Dim("slots", min=lo, max=hi)
        s0, d0 = state(EB, True), state(EB, False)
        active = torch.zeros(EB, dtype=torch.bool, device=dev)
        engine_meta = {
            "batch": EB,
            "slots": [lo, hi],
            "tick": export("engine_tick", _fused_tick, s0,
                           torch.zeros(EB, conf.hopsize, device=dev), torch.zeros(EB, device=dev),
                           active, batched=(0, 1, 2, 3) if slots else (), batch_dim=slots),
            "decode_tick": export(
                "engine_decode_tick",
                lambda w, s, c, lost, cb, a: _decode_tick(w, s, c, lost, cb, a, every_step=True),
                d0, torch.full((EB, conf.z_dim), 0.5, device=dev), torch.zeros(EB, device=dev),
                torch.zeros(EB, device=dev), active, batched=(0, 1, 2, 3, 4) if slots else (),
                batch_dim=slots),
            "state": _specs(s0), "decode_state": _specs(d0),
        }

    manifest = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "traced_on": str(dev),
        "batch": batch,
        # the numerics every program of the bundle was traced with
        "serving": {"precision": codec.precision, "voc_compute_dtype":
                    _dtype_name(codec.voc_compute_dtype), "voc_dtype": codec.voc_dtype,
                    "fused_cell": codec.fused_cell, "quantize": codec.quantize,
                    "use_pallas": codec.use_pallas, "approx_snake": codec.approx_snake,
                    "dtype": _dtype_name(codec.dtype)},
        "config": dataclasses.asdict(conf),
        "buckets": buckets,
        "packet": packet_meta,
        "engine": engine_meta,
        "weights": {"file": WEIGHTS,
                    "tensors": [[k, list(t.shape), _dtype_name(t.dtype)] for k, t in items]},
        "program_bytes": {k: len(v) for k, v in blobs.items()},
        "export_seconds": seconds,
    }
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(manifest, indent=1))
        zf.writestr(WEIGHTS, _weights_npz(items))
        for name, blob in blobs.items():
            zf.writestr(name, blob)
    os.replace(tmp, path)
    return manifest


# ---------------------------------------------------------------------------
# loading and serving
# ---------------------------------------------------------------------------


def _load_weights(zf: zipfile.ZipFile, spec: dict, device) -> list[torch.Tensor]:
    with np.load(io.BytesIO(zf.read(spec["file"]))) as z:
        out = []
        for key, shape, dtype in spec["tensors"]:
            t = torch.from_numpy(np.array(z[key]))
            if dtype == "bfloat16":
                t = t.view(torch.bfloat16)
            if t.dtype != _DTYPES[dtype] or list(t.shape) != list(shape):
                raise ValueError(f"weight {key!r} is {t.dtype} {tuple(t.shape)}, the manifest "
                                 f"says {dtype} {tuple(shape)}")
            out.append(t.to(device))
    return out


class ServingBundle:
    """Reload and serve a ``.bvscx`` bundle on ``device`` (default the
    first CUDA card, raising without one; ``device='cpu'`` for the CPU).

    Mirrors the live codec's API at the export shapes: ``forward(x,
    bitrate)`` (also ``__call__``), ``encode``, ``decode(codes, length)``,
    ``vocode(mel)``, ``bits_per_frame``, and the real-time
    :meth:`packet_codec`, :meth:`packet_decoder`, :meth:`serving_engine`
    and :meth:`decode_engine`.  Results are tensors on ``device``.
    Programs load at first use and stay loaded.  A parity bundle
    (``precision='highest'``) turns TF32 off for the process
    (``device.set_parity_mode``), as a parity codec does."""

    def __init__(self, path: str, device: str | torch.device | None = None):
        self.path = path
        self.device = resolve_device(device)
        # a malformed file raises a clean ValueError, as the .bvsc reader does
        try:
            with zipfile.ZipFile(path) as zf:
                meta = json.loads(zf.read("meta.json"))
            fmt = meta.get("format")
        except _MALFORMED as e:
            raise ValueError(f"{path}: not a valid .bvscx bundle ({e!r})") from e
        if fmt == BVSC_TPU_FORMAT:
            raise ValueError(f"{path}: a bvsc_tpu bundle ({fmt!r}: StableHLO programs); serve "
                             "it with bvsc_tpu.serve.ServingBundle")
        if fmt != FORMAT:
            raise ValueError(f"{path}: unknown bundle format {fmt!r}, expected {FORMAT!r}")
        try:
            with zipfile.ZipFile(path) as zf:
                self.conf = CodecConfig.from_dict(meta["config"])
                self.weights = _load_weights(zf, meta["weights"], self.device)
                self.batch = None if meta["batch"] is None else int(meta["batch"])
                precision = meta["serving"]["precision"]
                names = set(zf.namelist())
            programs = [p for b in meta["buckets"] for p in b["programs"].values()]
            for part, kinds in (("packet", ("step", "decode_step")),
                                ("engine", ("tick", "decode_tick"))):
                programs += [meta[part][k] for k in kinds] if meta.get(part) else []
            if missing := [p for p in programs if p not in names]:
                raise KeyError(f"missing programs {missing}")
        except (*_MALFORMED, ValueError) as e:
            raise ValueError(f"{path}: not a valid .bvscx bundle ({e!r})") from e
        self.meta = meta
        # the vocoder path the programs were traced on; a bundle written
        # before the manifest recorded it ran the kernels
        self.use_pallas = bool(meta["serving"].get("use_pallas", True))
        self.approx_snake = bool(meta["serving"].get("approx_snake", False))
        self.voc_dtype = meta["serving"].get("voc_dtype", "f32")
        self.dtype = _DTYPES[meta["serving"].get("dtype", "float32")]  # the storage type
        if precision == "highest":
            set_parity_mode()
        self._programs: dict[tuple, torch.nn.Module] = {}
        self._weights = {canonical(self.device): self.weights}

    @classmethod
    def load(cls, path: str, device: str | torch.device | None = None) -> "ServingBundle":
        return cls(path, device)

    # -- internals -------------------------------------------------------------

    def _program(self, name: str, device: torch.device | None = None) -> torch.nn.Module:
        device = canonical(self.device if device is None else device)
        mod = self._programs.get((name, device))
        if mod is None:
            try:
                with zipfile.ZipFile(self.path) as zf:
                    ep = torch.export.load(io.BytesIO(zf.read(name)))
            except (*_MALFORMED, RuntimeError, ValueError) as e:
                raise ValueError(f"{self.path}: program {name!r} does not load ({e!r})") from e
            from torch.export.passes import move_to_device_pass

            mod = self._programs[(name, device)] = move_to_device_pass(ep, device).module()
        return mod

    @torch.no_grad()
    def _call(self, name: str, *inputs, device: torch.device | None = None):
        """Program ``name`` on ``device`` (default the bundle's), with the
        weights' copy there."""
        device = canonical(self.device if device is None else device)
        w = self._weights.get(device)
        if w is None:
            w = self._weights[device] = [t.to(device) for t in self.weights]
        # forward itself: the public methods check the inputs' batch and
        # bucket before a call, so the module's per-call check of every
        # input's shape (its forward pre-hook) is skipped; a traced graph's
        # convs run under cuDNN's process flag, pinned here as the live
        # path pins them (ops.conv)
        with cudnn_fp32():
            return self._program(name, device).forward(w, *inputs)

    def _zeros(self, specs) -> dict:
        return _zeros(specs, self.device)

    def _bucket(self, length: int) -> dict:
        for b in self.meta["buckets"]:
            if b["length"] >= length:
                return b
        top = self.meta["buckets"][-1]["length"] if self.meta["buckets"] else 0
        raise ValueError(f"no exported bucket covers {length} samples (the longest is {top}); "
                         "export with larger lengths")

    def _frames(self, length: int) -> int:
        c = self.conf
        return 1 + (length + c.winsize - c.hopsize - c.winsize) // c.hopsize

    def _as_input(self, x, ndim: int, what: str) -> tuple[torch.Tensor, bool]:
        """To a float32 tensor on the device, promoting a missing batch
        axis; checks the batch against the export's."""
        if not isinstance(x, torch.Tensor):
            x = np.array(x, np.float32)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        squeeze = x.dim() == ndim - 1
        if squeeze:
            x = x[None]
        if x.dim() != ndim:
            raise ValueError(f"{what} has shape {tuple(x.shape)}")
        if self.batch is not None and x.shape[0] != self.batch:
            raise ValueError(f"the bundle was exported for batch {self.batch}, got {x.shape[0]}")
        if not 0 < x.shape[0] <= MAX_BATCH:
            raise ValueError(f"batch {x.shape[0]} outside 1..{MAX_BATCH}")
        return x, squeeze

    def _wave_call(self, kind: str, x, bitrate):
        x, squeeze = self._as_input(x, 2, "waveform")
        L = x.shape[1]
        b = self._bucket(L)
        xp = torch.nn.functional.pad(x, (0, b["length"] - L))
        n = self._frames(L)
        bits = frame_bits(self.conf, bitrate, x.shape[0], L, n, b["frames"], self.device)
        args = (xp, bits.contiguous())
        if kind == "forward":
            args += (torch.tensor(n, device=self.device),)
        return self._call(b["programs"][kind], *args), L, n, squeeze

    # -- public API --------------------------------------------------------------

    def forward(self, x, bitrate) -> torch.Tensor:
        """One-shot resynthesis through the exported fused program."""
        y, L, _, squeeze = self._wave_call("forward", x, bitrate)
        y = y[:, :L]
        return y[0] if squeeze else y

    __call__ = forward

    def encode(self, x, bitrate) -> torch.Tensor:
        """(batch, length) or (length,) waveform -> codes (batch, frames,
        z_dim); ``bitrate`` a scalar or a per-frame schedule."""
        codes, _, n, squeeze = self._wave_call("encode", x, bitrate)
        codes = codes[:, :n]
        return codes[0] if squeeze else codes

    def decode(self, codes, length: int) -> torch.Tensor:
        """(batch, frames, z_dim) or (frames, z_dim) codes -> waveform."""
        codes, squeeze = self._as_input(codes, 3, "codes")
        T = codes.shape[1]
        b = self._bucket(max(T * self.conf.hopsize, length))
        codes = torch.nn.functional.pad(codes, (0, 0, 0, b["frames"] - T), value=0.5)
        y = self._call(b["programs"]["decode"], codes)[:, :length]
        return y[0] if squeeze else y

    def vocode(self, mel, length: int | None = None) -> torch.Tensor:
        """Mel (batch, num_mels, frames) or (num_mels, frames) -> the
        vocoder's waveform (no codec scaling); ``length`` defaults to
        frames x hop.  Frames past the input are padded at the log-clamp
        floor, log(1e-5): the causal vocoder's first samples do not see
        them."""
        mel, squeeze = self._as_input(mel, 3, "mel")
        T, hop = mel.shape[2], self.conf.hopsize
        length = T * hop if length is None else length
        b = self._bucket(max(T * hop, length))
        mel = torch.nn.functional.pad(mel, (0, b["frames"] - T), value=float(np.log(1e-5)))
        y = self._call(b["programs"]["vocode"], mel)[:, :length]
        return y[0] if squeeze else y

    def bits_per_frame(self, bitrate):
        """bps -> bits/frame, with the live codec's rounding."""
        return bits_per_frame(self.conf, bitrate)

    def packet_codec(self, bitrate: float = 3000.0) -> "ExportedPacketCodec":
        return ExportedPacketCodec(self, bitrate)

    def packet_decoder(self, conceal_bitrate=None) -> "ExportedPacketDecoder":
        return ExportedPacketDecoder(self, conceal_bitrate)

    def serving_engine(self, mesh=None) -> "BundleServingEngine":
        """Batched full-duplex serving at the export's ``engine_batch``
        slots, over ``mesh``'s devices if given."""
        return BundleServingEngine(self, mesh)

    def decode_engine(self, mesh=None) -> "BundleDecodeEngine":
        return BundleDecodeEngine(self, mesh)


def _require(bundle: ServingBundle, part: str, how: str) -> dict:
    meta = bundle.meta.get(part)
    if not meta:
        raise ValueError(f"the bundle was exported without {part} programs; export with {how}")
    return meta


class ExportedPacketCodec(FusedPacketCodec):
    """``streaming.FusedPacketCodec`` on the bundle's ``packet_step``: the
    host bookkeeping (reflect pre-roll, hop chunking, flush) is the live
    class's; only the device step is the exported program."""

    def __init__(self, bundle: ServingBundle, bitrate: float = 3000.0):
        # no super().__init__: there is no live codec; the bundle stands in
        # for it (the bookkeeping reads only its .device)
        pk = _require(bundle, "packet", "packet=True")
        conf = bundle.conf
        self.codec = bundle
        self._step_name = pk["step"]
        self.hop = conf.hopsize
        self.winsize = conf.winsize
        self.pad_left = conf.mel_pad_left
        self.pad_right = conf.winsize - conf.mel_pad_left - conf.hopsize
        self.batch = int(pk["batch"])
        self.bits = torch.full((self.batch,), bundle.bits_per_frame(bitrate), device=bundle.device)
        self.state = bundle._zeros(pk["state"])
        self._prefix = np.zeros((self.batch, 0), np.float32)
        self._tail = np.zeros((self.batch, 0), np.float32)
        self._started = False
        self._flushed = False

    def _step(self, chunk: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        chunk = torch.as_tensor(np.ascontiguousarray(chunk), device=self.codec.device)
        self.state, codes, wav = self.codec._call(self._step_name, self.state, chunk, self.bits)
        return codes, wav


class ExportedPacketDecoder:
    """The receiver on the bundle's ``packet_decode_step``: the surface of
    ``streaming.StreamingDecoder`` (``feed(codes, lost=None)``,
    ``conceal(n)``), one program call per frame.  ``conceal_bitrate``
    masks concealed frames to the stream's allocation; None conceals with
    all ``z_dim`` bits."""

    def __init__(self, bundle: ServingBundle, conceal_bitrate=None):
        pk = _require(bundle, "packet", "packet=True")
        conf = bundle.conf
        self.bundle = bundle
        self._step_name = pk["decode_step"]
        self.batch = int(pk["batch"])
        self.hop = conf.hopsize
        self.z_dim = conf.z_dim
        cb = (float(conf.z_dim) if conceal_bitrate is None
              else bundle.bits_per_frame(conceal_bitrate))
        self.conceal_bits = torch.full((self.batch,), float(cb), device=bundle.device)
        self.state = bundle._zeros(pk["decode_state"])

    def feed(self, codes, lost=None) -> torch.Tensor:
        """codes (batch, n, z_dim); lost: optional (batch, n) 0/1 flags.
        Returns (batch, n * hop) samples."""
        dev = self.bundle.device
        codes = torch.as_tensor(codes, dtype=torch.float32, device=dev).reshape(
            self.batch, -1, self.z_dim)
        n = codes.shape[1]
        lost = (torch.zeros(self.batch, n, device=dev) if lost is None else
                torch.as_tensor(_host_array(lost), device=dev).reshape(self.batch, n))
        outs = []
        for t in range(n):
            self.state, wav = self.bundle._call(
                self._step_name, self.state, codes[:, t: t + 1].contiguous(),
                lost[:, t: t + 1].contiguous(), self.conceal_bits)
            outs.append(wav)
        return torch.cat(outs, 1) if outs else torch.zeros(self.batch, 0, device=dev)

    def conceal(self, n_frames: int = 1) -> torch.Tensor:
        """Audio for ``n_frames`` lost packets, concealed from the prior."""
        codes = np.full((self.batch, n_frames, self.z_dim), 0.5, np.float32)
        return self.feed(codes, lost=np.ones((self.batch, n_frames), np.float32))


def _engine_blocks(bundle: ServingBundle, mesh) -> tuple[dict, int, list]:
    """The engine manifest, its slot count and the slot blocks over
    ``mesh``; a block must lie in the range the programs were traced for
    (a bundle traced before that range was recorded serves no mesh)."""
    eng = _require(bundle, "engine", "engine_batch=N")
    B = int(eng["batch"])
    blocks = slot_blocks(B, mesh, bundle.device)
    lo, hi = eng.get("slots", (B, B))
    for sl, _ in blocks:
        if not lo <= sl.stop - sl.start <= hi:
            raise ValueError(f"the bundle's engine programs take {lo}..{hi} slots, a block of the "
                             f"mesh has {sl.stop - sl.start}; export with another engine_batch")
    return eng, B, blocks


def _state_zeros(specs, rows: int, device) -> dict:
    """A manifest state tree's zeros at ``rows`` slots on ``device``."""
    return _zeros([[k, [rows, *shape[1:]], dtype] for k, shape, dtype in specs], device)


class BundleServingEngine(ServingEngine):
    """``serve.engine.ServingEngine`` with its device step the bundle's
    ``engine_tick`` and its zero state from the manifest; the slot count is
    the export's ``engine_batch``, over ``mesh``'s devices if given (each
    with its own copy of the weights, which are the programs' inputs)."""

    def __init__(self, bundle: ServingBundle, mesh=None):
        eng, self.B, self._blocks = _engine_blocks(bundle, mesh)
        conf = bundle.conf
        self.codec = bundle  # .conf and .bits_per_frame: all the engine reads of it
        self.hop = conf.hopsize
        self.win = conf.winsize
        self.pad_left = conf.mel_pad_left
        self.z_dim = conf.z_dim
        self.device = bundle.device
        self._tick_name = eng["tick"]
        self._init_states()
        self._init_host_slots()
        self._warm()

    def _init_device_state(self, rows: int, device) -> dict:
        return _state_zeros(self.codec.meta["engine"]["state"], rows, device)

    def _tick_call(self, state, chunk, bits, active, block: int = 0):
        return self.codec._call(self._tick_name, state, chunk, bits, active,
                                device=self._blocks[block][1])


class BundleDecodeEngine(DecodeEngine):
    """``serve.engine.DecodeEngine`` on the bundle's ``engine_decode_tick``."""

    def __init__(self, bundle: ServingBundle, mesh=None):
        eng, self.B, self._blocks = _engine_blocks(bundle, mesh)
        self.codec = bundle
        self.hop = bundle.conf.hopsize
        self.z_dim = bundle.conf.z_dim
        self.device = bundle.device
        self._tick_name = eng["decode_tick"]
        self._init_states()
        self._init_host_slots()
        self._warm()

    def _init_device_state(self, rows: int, device) -> dict:
        return _state_zeros(self.codec.meta["engine"]["decode_state"], rows, device)

    def _tick_call(self, state, codes, lost, cbits, active, block: int = 0):
        return self.codec._call(self._tick_name, state, codes, lost, cbits, active,
                                device=self._blocks[block][1])
