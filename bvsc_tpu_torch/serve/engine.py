"""Batched multi-stream serving engines (port of ``bvsc_tpu/serve/engine.py``).

Up to ``max_streams`` concurrent codec sessions share one fixed-shape
batched state on the codec's device (the reference's serving config: 128
concurrent streams on one card):

* every stream owns a row (a slot) of the state: the rolling 1024-sample
  STFT window, the BVRNN hidden state, and the streaming vocoder's state
  (``streaming.generator_stream_init``: conv_pre / conv_post contexts, the
  upsamplers' overlap-add tails, and each stage's 120-sample context with
  its per-row ``fed`` count); per tick only the new 256-sample hop of each
  stream crosses to the device;
* :meth:`ServingEngine.tick` advances every stream with a full frame queued
  by one frame in one call of ``streaming._fused_packet_step`` over all B
  rows (window roll -> ``MelFrontend.log_mel`` -> the BVRNN's
  ``encode_decode`` at T = 1 -> ``generator_stream_step``, whose stages run
  K1 or K1-bf16 on a CUDA codec on the kernel path, or the plain blocks on
  the direct path), then keeps the rows of the slots that did
  not advance (:func:`_merge_active`); so one slot is a ``FusedPacketCodec``
  by construction;
* per-stream bitrates are a (B,) vector (the bit-priority mask takes bits
  per row);
* opening a stream zeroes its rows of every leaf, ``fed`` included, so its
  stages' ``start`` masks see a stream that begins at that tick; a stream's
  first tick preloads its window row with the reflect pre-roll, so the
  rolled-in hop reproduces the one-shot left padding.

:class:`DecodeEngine` is the receiver's side: codes (and lost-frame flags)
in, audio out, one ``models.bvrnn.decode_plc`` step at T = 1 and one
streaming vocoder step per tick; one slot is a ``StreamingDecoder``.

Host-side per-slot sample queues are numpy.  ``tick`` runs without
autograd whatever thread calls it (grad mode is per thread), and both
engines tick once with no slot active when they are built, so the kernels
are built and the libraries set up before the first stream arrives.  The
engines run on their codec's device; the only way onto the CPU is a
``device='cpu'`` codec.  Nothing here changes the process-wide TF32 flags.

``fused_cell='auto'`` picks the BVRNN cell by batch (``models.bvrnn``), so
an engine of 32 or more slots runs the standard cell whatever a solo
stream of the same codec runs.

``mesh=`` (a ``parallel.mesh.Mesh``) serves the slots over several devices
from this one process, as the reference's mesh shards the slot batch: each
device of the mesh holds a replica of the codec's weights (the codec's own
tensors where the device is the codec's) and a contiguous block of the
slots, with its own state (:attr:`ServingEngine.states`, one tree a
block).  A tick enqueues every block's step on its device before it reads
any back, then assembles the host outputs in slot order; one slot is the
same function of its inputs as in an unsharded engine, with the products
summed over a block's rows instead of all of them.  ``max_streams`` must
divide over the mesh's devices.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from bvsc_tpu_torch import streaming as S
from bvsc_tpu_torch.device import canonical
from bvsc_tpu_torch.parallel.mesh import Mesh, row_blocks
from bvsc_tpu_torch.utils import tracing


class EngineStateLost(RuntimeError):
    """A tick failed; the engine rebuilt zeroed device state before raising.

    The reference's tick donates its state, so a failed dispatch can leave
    it deleted; the port keeps the contract callers rely on: after this
    exception the engine object stays usable, but every stream's hidden
    state is gone, so callers close (and clients reopen) all active
    streams.  The BVSP daemon does exactly that.
    """


class _SampleQueue:
    """Chunked FIFO of float32 samples: O(1) amortized push/pop.

    A flat ``np.concatenate`` queue re-copies the entire backlog on every
    push: a client that sends a long recording up front would make that
    O(n²) while holding the daemon's lock.  Chunks are only touched when
    popped.
    """

    __slots__ = ("_chunks", "_off", "_len")

    def __init__(self):
        self._chunks: collections.deque[np.ndarray] = collections.deque()
        self._off = 0  # consumed samples of the head chunk
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def push(self, samples: np.ndarray) -> None:
        x = np.asarray(samples, np.float32).reshape(-1)
        if x.size:
            self._chunks.append(x)
            self._len += x.size

    def pop(self, n: int) -> np.ndarray:
        if n > self._len:
            raise ValueError(f"pop({n}) from a {self._len}-sample queue")
        out = np.empty(n, np.float32)
        got = 0
        while got < n:
            head = self._chunks[0]
            take = min(head.size - self._off, n - got)
            out[got: got + take] = head[self._off: self._off + take]
            got += take
            self._off += take
            if self._off == head.size:
                self._chunks.popleft()
                self._off = 0
        self._len -= n
        return out


def _merge_active(active: torch.Tensor, new, old):
    """``where(active, new, old)`` row by row over a state tree (dicts and
    lists of tensors whose first axis is the slot): the slots that did not
    advance keep their rows.  The (B,) mask is reshaped to each leaf's rank,
    from the stages' (B,) ``fed`` to the (B, C, k) buffers."""
    if isinstance(new, dict):
        return {k: _merge_active(active, new[k], old[k]) for k in new}
    if isinstance(new, list):
        return [_merge_active(active, n, o) for n, o in zip(new, old)]
    return torch.where(active.view(-1, *[1] * (new.dim() - 1)), new, old)


def _zero_rows(tree, sid: int) -> None:
    """Zero slot ``sid``'s row of every leaf, in place."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for leaf in tree:
            _zero_rows(leaf, sid)
    else:
        tree[sid] = 0


def slot_blocks(slots: int, mesh, device) -> list[tuple[slice, torch.device]]:
    """The engine's slot blocks and their devices: all slots on ``device``
    without a mesh, else one contiguous block a device of the mesh."""
    if mesh is None:
        return [(slice(0, slots), canonical(device))]
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a bvsc_tpu_torch.parallel.mesh.Mesh, got {type(mesh)}")
    devices = [canonical(d) for d in mesh.devices.reshape(-1)]
    if slots % len(devices):
        raise ValueError("max_streams must divide evenly over the mesh")
    return list(zip(row_blocks(slots, len(devices)), devices))


def _weights_on(codec, device):
    """The codec's weights (``codec.CodecWeights``) on ``device``: its own
    on its device, else a copy of every tensor."""
    w = codec.weights
    if device == canonical(codec.device):
        return w
    return w.with_tree(_map_tree(w.tree(), lambda t: t.to(device)))


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


class _Sharded:
    """What the serving and decode engines share over slot blocks: the
    blocks (:func:`slot_blocks`), one state tree a block, a slot's block
    and row, and a single-block engine's ``state``."""

    def _set_blocks(self, mesh) -> None:
        self._blocks = slot_blocks(self.B, mesh, self.device)

    @property
    def state(self) -> dict:
        """The state tree of an engine without a mesh (a sharded engine has
        one a block: :attr:`states`)."""
        if len(self.states) != 1:
            raise AttributeError("a sharded engine holds one state tree a device: .states")
        return self.states[0]

    @state.setter
    def state(self, tree: dict) -> None:
        if len(self.states) != 1:
            raise AttributeError("a sharded engine holds one state tree a device: .states")
        self.states[0] = tree

    def _init_states(self) -> None:
        self.states = [self._init_device_state(sl.stop - sl.start, dev)
                       for sl, dev in self._blocks]

    def _slot(self, sid: int) -> tuple[int, int]:
        """(block, row) of slot ``sid``."""
        for k, (sl, _) in enumerate(self._blocks):
            if sl.start <= sid < sl.stop:
                return k, sid - sl.start
        raise IndexError(f"slot {sid} outside 0..{self.B - 1}")

    def _zero_slot(self, sid: int) -> None:
        k, row = self._slot(sid)
        _zero_rows(self.states[k], row)

    def _block_inputs(self, *arrays) -> list[tuple]:
        """Each block's rows of the host arrays, on its device."""
        return [tuple(torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev) for a in arrays)
                for sl, dev in self._blocks]

    def _copy_inputs(self, *arrays) -> list[tuple]:
        """A tick's :meth:`_block_inputs`, counted as its host-to-device
        copies (one an array and block) and their bytes."""
        inputs = self._block_inputs(*arrays)
        tracing.count(self._KIND + ".h2d_copies", len(arrays) * len(inputs))
        tracing.count(self._KIND + ".h2d_bytes", sum(a.nbytes for a in arrays))
        return inputs


def _fused_tick(w, state: dict, chunk: torch.Tensor, bits: torch.Tensor,
                active: torch.Tensor):
    """Every slot by one 256-sample frame on the codec's weights ``w``
    (``codec.CodecWeights``): one ``_fused_packet_step`` over all B rows,
    then the masked merge.  state: {window (B, win), h (B, h), voc}; chunk
    (B, hop); bits (B,) bits/frame; active (B,) bool.  Returns (state,
    codes (B, z), waveform (B, hop))."""
    new, codes, wav = S._fused_packet_step(w, state, chunk, bits)
    return _merge_active(active, new, state), codes, wav


def _decode_tick(w, state: dict, codes: torch.Tensor, lost: torch.Tensor,
                 cbits: torch.Tensor, active: torch.Tensor, every_step: bool = False):
    """Every decode slot by one frame on the codec's weights ``w``:
    ``decode_plc`` at T = 1 (codes (B, z), per-slot ``lost`` 0/1 flags and
    concealment bits ``cbits``; ``every_step`` its traceable form), the
    streaming vocoder step, the masked merge.  state: {h (B, h), voc}.
    Returns (state, waveform (B, hop))."""
    new, wav = S._packet_decode_step(w, state, codes[:, None], lost[:, None], cbits,
                                     every_step)
    return _merge_active(active, new, state), wav


class ServingEngine(_Sharded):
    """Batched full-duplex serving: samples in, codes and resynthesised
    samples out, one frame per stream per :meth:`tick`."""

    _KIND = "serve"  # its spans' and counters' prefix (utils.tracing)

    def __init__(self, codec, max_streams: int = 128, mesh=None):
        """codec: a port ``BVRNNCodecModel``; the engine runs on its device,
        or with ``mesh`` over the mesh's devices (module docstring)."""
        self.codec = codec
        conf = codec.conf
        self.B = max_streams
        self.hop = conf.hopsize
        self.win = conf.winsize
        self.pad_left = conf.mel_pad_left
        self.z_dim = conf.z_dim
        self.device = codec.device
        self._set_blocks(mesh)
        self._weights = [_weights_on(codec, dev) for _, dev in self._blocks]
        self._init_states()
        self._init_host_slots()
        self._warm()

    def _init_device_state(self, rows: int, device) -> dict:
        """Fresh zeroed state of ``rows`` slots on ``device`` (also the
        recovery path after :class:`EngineStateLost`)."""
        return {
            "window": torch.zeros(rows, self.win, device=device),
            "h": torch.zeros(rows, self.codec.conf.h_dim, device=device, dtype=self.codec.dtype),
            "voc": S.vocoder_state(self.codec, rows, device),
        }

    def _init_host_slots(self) -> None:
        self.bits = np.zeros(self.B, np.float32)
        self._free = list(range(self.B))
        self._active = np.zeros(self.B, bool)
        self._started = np.zeros(self.B, bool)
        self._inq = [_SampleQueue() for _ in range(self.B)]
        # last pad_right + 1 raw input samples per slot: the reflect source
        # of the one-shot-equivalent tail at begin_flush (as
        # streaming.FusedPacketCodec._tail)
        self._tail = [np.zeros(0, np.float32) for _ in range(self.B)]
        self._flushing = np.zeros(self.B, bool)

    @torch.no_grad()
    def _warm(self) -> None:
        """One tick with no slot active (the state keeps every row)."""
        inputs = self._block_inputs(np.zeros((self.B, self.hop), np.float32),
                                    np.zeros(self.B, np.float32), np.zeros(self.B, bool))
        for k, args in enumerate(inputs):
            self.states[k], codes, _ = self._tick_call(self.states[k], *args, k)
            codes.cpu()

    def _tick_call(self, state, chunk, bits, active, block: int = 0):
        """The device step of one tick on one block of slots (a test
        replaces it to inject a failure)."""
        return _fused_tick(self._weights[block], state, chunk, bits, active)

    # -- stream management ----------------------------------------------------

    def open_stream(self, bitrate: float) -> int:
        if not self._free:
            raise RuntimeError("no free stream slots")
        sid = self._free.pop(0)
        self._active[sid] = True
        self._started[sid] = False
        self._inq[sid] = _SampleQueue()
        self._tail[sid] = np.zeros(0, np.float32)
        self._flushing[sid] = False
        self.bits[sid] = self.codec.bits_per_frame(bitrate)
        self._zero_slot(sid)
        return sid

    def close_stream(self, sid: int) -> None:
        if not self._active[sid]:
            raise RuntimeError(f"slot {sid} is not open")
        self._active[sid] = False
        self._free.append(sid)

    def set_bitrate(self, sid: int, bitrate: float) -> None:
        """Mid-stream bitrate switch (the codec is bitrate-scalable)."""
        self.bits[sid] = self.codec.bits_per_frame(bitrate)

    def push(self, sid: int, samples: np.ndarray) -> None:
        if self._flushing[sid]:
            raise ValueError("stream is flushing (begin_flush); no more input")
        x = np.asarray(samples, np.float32).reshape(-1)
        pad_right = self.win - self.pad_left - self.hop
        self._tail[sid] = np.concatenate([self._tail[sid], x])[-(pad_right + 1):]
        self._inq[sid].push(x)

    def queued(self, sid: int) -> int:
        """Samples buffered but not yet consumed (host-side backlog)."""
        return len(self._inq[sid])

    def begin_flush(self, sid: int) -> bool:
        """End of input: append the one-shot right reflect padding, so that
        the queue drains to the one-shot frame count, two frames past the
        last full real-input frame, as ``streaming.FusedPacketCodec.flush``.
        For input length L the queue then holds ``L + pad_right`` samples;
        the first tick consumes ``hop + pad_right``, so ``(L - hop)//hop + 1``
        frames drain and the sub-hop remainder stays unconsumed, as the
        one-shot's last window never reaches it either.  Returns False (a
        no-op) when the stream can never produce a first frame (total input
        < winsize - pad_left): it then drains to nothing, like a one-shot
        call on an input too short to frame."""
        if self._flushing[sid]:
            return True
        if not self._started[sid] and len(self._inq[sid]) < self.win - self.pad_left:
            return False
        pad_right = self.win - self.pad_left - self.hop
        self._inq[sid].push(self._tail[sid][-pad_right - 1: -1][::-1])
        self._flushing[sid] = True
        return True

    def has_frame(self, sid: int) -> bool:
        """Whether a tick() would advance this stream (a full frame:
        winsize - pad_left samples before the first output, hop after)."""
        if not self._active[sid]:
            return False
        need = (self.win - self.pad_left) if not self._started[sid] else self.hop
        return len(self._inq[sid]) >= need

    # -- processing -----------------------------------------------------------

    def _gather(self, open_ids: list[int]):
        """The host slot loop of a tick over the open slots: (the slots
        advanced, their input chunk (B, hop), the (slot, window) preloads of
        the streams that start)."""
        advanced = []
        chunk = np.zeros((self.B, self.hop), np.float32)
        preload: list[tuple[int, np.ndarray]] = []
        need = self.win - self.pad_left  # lookahead + the first hop
        for sid in open_ids:
            q = self._inq[sid]
            if not self._started[sid]:
                if len(q) < need:
                    continue
                x = q.pop(need)
                window0 = np.concatenate([x[1: self.pad_left + 1][::-1], x])  # reflect pre-roll
                # preload the slot's window so rolling in the final hop
                # reproduces window0 exactly (one-shot left padding)
                preload.append((sid, np.concatenate([np.zeros(self.hop, np.float32),
                                                     window0[: -self.hop]])))
                chunk[sid] = window0[-self.hop:]
                self._started[sid] = True
            elif len(q) >= self.hop:
                chunk[sid] = q.pop(self.hop)
            else:
                continue
            advanced.append(sid)
        return advanced, chunk, preload

    @torch.no_grad()
    def tick(self) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """Advance every stream with a full frame queued by one frame.

        Returns {sid: (codes (z_dim,), wav (hop,))} for advanced streams,
        numpy arrays.  A tick that advances a stream records its spans and
        counters (``utils.tracing``); one that advances none records none."""
        open_ids = np.flatnonzero(self._active).tolist()
        if not any(self.has_frame(sid) for sid in open_ids):
            return {}
        with tracing.span("serve.tick", numbered=True):
            with tracing.span("serve.gather"):
                advanced, chunk, preload = self._gather(open_ids)
                active = np.zeros(self.B, bool)
                active[advanced] = True
            try:
                with tracing.span("serve.copy"):
                    for sid, window in preload:  # only on stream-start ticks
                        k, row = self._slot(sid)
                        self.states[k]["window"][row] = torch.from_numpy(window).to(
                            self._blocks[k][1])
                    tracing.count("serve.h2d_copies", len(preload))
                    tracing.count("serve.h2d_bytes", sum(w.nbytes for _, w in preload))
                    inputs = self._copy_inputs(chunk, self.bits, active)
                with tracing.span("serve.issue"):
                    outs = []  # every block's step enqueued before any read-back
                    for k, args in enumerate(inputs):
                        self.states[k], codes, wav = self._tick_call(self.states[k], *args, k)
                        outs.append(torch.cat([codes.float(), wav.float()], 1))
                with tracing.span("serve.wait"):
                    out = np.concatenate([o.cpu().numpy() for o in outs])[advanced]
            except Exception as e:
                # the engine survives; every stream's state is gone
                self._init_states()
                self._started[:] = False
                raise EngineStateLost(
                    "tick failed; device state rebuilt: close and reopen all active streams"
                ) from e
            tracing.count("serve.frames", len(advanced))
            tracing.count("serve.slots_open", len(open_ids))
            tracing.count("serve.starts", len(preload))
            z = self.z_dim
            return {sid: (row[:z], row[z:]) for sid, row in zip(advanced, out)}


class DecodeEngine(_Sharded):
    """Batched decode-only serving: code streams in, audio out.

    The receiver-side counterpart of :class:`ServingEngine` (e.g. a relay
    decoding many remote parties at once).  Every slot carries (BVRNN h,
    streaming-vocoder state) on the device; ``tick()`` advances all slots
    with a queued frame at once.  Frames may be flagged lost (``push_lost``
    / the ``lost`` argument of ``push``): they are concealed from the
    BVRNN's own prior with no output gap, per stream.  One slot is a
    ``StreamingDecoder`` fed frame by frame with ``lost=``.
    """

    _KIND = "decode"

    def __init__(self, codec, max_streams: int = 128, mesh=None):
        """As :class:`ServingEngine`'s: the codec's device, or ``mesh``."""
        self.codec = codec
        conf = codec.conf
        self.B = max_streams
        self.hop = conf.hopsize
        self.z_dim = conf.z_dim
        self.device = codec.device
        self._set_blocks(mesh)
        self._weights = [_weights_on(codec, dev) for _, dev in self._blocks]
        self._init_states()
        self._init_host_slots()
        self._warm()

    def _init_device_state(self, rows: int, device) -> dict:
        """Fresh zeroed state of ``rows`` slots on ``device`` (recovery path
        after :class:`EngineStateLost`)."""
        return {"h": torch.zeros(rows, self.codec.conf.h_dim, device=device,
                                 dtype=self.codec.dtype),
                "voc": S.vocoder_state(self.codec, rows, device)}

    def _init_host_slots(self) -> None:
        self._free = list(range(self.B))
        self._active = np.zeros(self.B, bool)
        # per-slot host queues of (codes (z,), lost flag) frames
        self._inq: list[collections.deque] = [collections.deque() for _ in range(self.B)]
        # conceal bits == z_dim is the same as "all prior bits"
        self.cbits = np.full(self.B, float(self.z_dim), np.float32)

    @torch.no_grad()
    def _warm(self) -> None:
        """One tick with no slot active (the state keeps every row)."""
        B = self.B
        inputs = self._block_inputs(np.full((B, self.z_dim), 0.5, np.float32),
                                    np.zeros(B, np.float32), self.cbits, np.zeros(B, bool))
        for k, args in enumerate(inputs):
            self.states[k], wav = self._tick_call(self.states[k], *args, k)
            wav.cpu()

    def _tick_call(self, state, codes, lost, cbits, active, block: int = 0):
        """The device step of one decode tick on one block of slots."""
        return _decode_tick(self._weights[block], state, codes, lost, cbits, active)

    def open_stream(self, conceal_bitrate=None) -> int:
        """conceal_bitrate: bps masking this stream's concealed frames to its
        real allocation (the receiver knows it, e.g. from the .bvsc table);
        None conceals with all ``z_dim`` prior bits."""
        if not self._free:
            raise RuntimeError("no free stream slots")
        sid = self._free.pop(0)
        self._active[sid] = True
        self._inq[sid] = collections.deque()
        self.cbits[sid] = (float(self.z_dim) if conceal_bitrate is None
                           else self.codec.bits_per_frame(conceal_bitrate))
        self._zero_slot(sid)
        return sid

    def close_stream(self, sid: int) -> None:
        if not self._active[sid]:
            raise RuntimeError(f"slot {sid} is not open")
        self._active[sid] = False
        self._free.append(sid)

    def push(self, sid: int, codes: np.ndarray, lost=None) -> None:
        """Enqueue (n, z_dim) code frames; lost: optional (n,) 0/1 flags."""
        codes = np.asarray(codes, np.float32).reshape(-1, self.z_dim)
        lost = np.zeros(codes.shape[0]) if lost is None else np.asarray(lost)
        if lost.shape != (codes.shape[0],):
            raise ValueError(f"lost shape {lost.shape} != ({codes.shape[0]},)")
        for frame, flag in zip(codes, lost):
            self._inq[sid].append((frame, bool(flag)))

    def queued(self, sid: int) -> int:
        """Code frames buffered but not yet decoded (host-side backlog)."""
        return len(self._inq[sid])

    def has_frame(self, sid: int) -> bool:
        """Whether a tick() would advance this stream (>= 1 queued frame)."""
        return bool(self._active[sid]) and bool(self._inq[sid])

    def push_lost(self, sid: int, n: int = 1) -> None:
        """Enqueue n never-arrived frames (concealed at tick)."""
        neutral = np.full(self.z_dim, 0.5, np.float32)
        for _ in range(n):
            self._inq[sid].append((neutral, True))

    @torch.no_grad()
    def tick(self) -> dict[int, np.ndarray]:
        """Advance every stream with a queued frame; {sid: wav (hop,)}.  As
        :meth:`ServingEngine.tick`, records its spans and counters when it
        advances a stream."""
        open_ids = np.flatnonzero(self._active).tolist()
        if not any(self._inq[sid] for sid in open_ids):
            return {}
        with tracing.span("decode.tick", numbered=True):
            with tracing.span("decode.gather"):
                advanced = [sid for sid in open_ids if self._inq[sid]]
                codes = np.full((self.B, self.z_dim), 0.5, np.float32)
                lost = np.zeros(self.B, np.float32)
                for sid in advanced:
                    frame, flag = self._inq[sid].popleft()
                    codes[sid] = frame
                    lost[sid] = float(flag)
                active = np.zeros(self.B, bool)
                active[advanced] = True
            try:
                with tracing.span("decode.copy"):
                    inputs = self._copy_inputs(codes, lost, self.cbits, active)
                with tracing.span("decode.issue"):
                    outs = []  # every block's step enqueued before any read-back
                    for k, args in enumerate(inputs):
                        self.states[k], wav = self._tick_call(self.states[k], *args, k)
                        outs.append(wav.float())
                with tracing.span("decode.wait"):
                    out = np.concatenate([o.cpu().numpy() for o in outs])[advanced]
            except Exception as e:
                self._init_states()
                raise EngineStateLost(
                    "decode tick failed; device state rebuilt: close and reopen all active "
                    "streams") from e
            tracing.count("decode.frames", len(advanced))
            tracing.count("decode.slots_open", len(open_ids))
            tracing.count("decode.concealed", int(lost.sum()))
            return dict(zip(advanced, out))
