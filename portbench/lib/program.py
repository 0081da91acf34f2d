"""Where the benchmark touches the program under test, ``bvsc_tpu_torch``.

Everything here is the program's public surface (the codec, the serving
engines) plus the module attributes the benchmark wraps from its own files
to mark a layer's calls: the codec's mel step, the BVRNN scan and the
vocoder; each vocoder stage (``amp_stack`` on the kernel path, ``amp_block``
on the direct path, one-shot and streaming).  A wrapper only passes the call
through (and keeps what it returns, where the check needs it).
"""

from __future__ import annotations

import contextlib

import torch

from portbench.counts import stage_bound_s
from portbench.lib.trace import PhaseEvents, ranged, wrapped


def sync(device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def import_program():
    """The program's modules, imported on first use."""
    import bvsc_tpu_torch.codec as codec
    import bvsc_tpu_torch.models.bvrnn as bvrnn
    import bvsc_tpu_torch.models.vocoder as vocoder
    import bvsc_tpu_torch.serve.engine as engine
    import bvsc_tpu_torch.streaming as streaming
    from bvsc_tpu_torch.config import CodecConfig

    return {"codec": codec, "bvrnn": bvrnn, "vocoder": vocoder, "engine": engine,
            "streaming": streaming, "CodecConfig": CodecConfig}


def build_codec(conf: dict, bvrnn_params: dict, vocoder_params: dict, device, **override):
    """``BVRNNCodecModel`` of the configuration file ``conf`` on the given
    weights; ``override`` replaces constructor arguments (a control)."""
    m = import_program()
    kwargs = dict(conf["program"])
    kwargs.update(override)
    return m["codec"].BVRNNCodecModel(config=m["CodecConfig"].from_dict(conf["codec"]),
                                      bvrnn_params=bvrnn_params, vocoder_params=vocoder_params,
                                      device=device, **kwargs)


class StageLog:
    """The shapes of the vocoder-stage calls made while it is on, and their
    least time (``counts.stage_bound_s``) at the configuration's types."""

    def __init__(self, vcfg: dict, compute: str, io: str):
        self.vcfg, self.compute, self.io = vcfg, compute, io
        self.on = False
        self.bound_s = 0.0
        self.calls = 0

    def add(self, x, kernel_sizes, dilations, ctx: int) -> None:
        if self.on:
            rows, channels, samples = x.shape[0], x.shape[1], x.shape[-1] - ctx
            self.bound_s += stage_bound_s(channels, kernel_sizes, dilations, rows, samples,
                                          self.compute, self.io)[0]
            self.calls += 1

    def stack_wrapper(self, fn):
        """Around ``amp_stack(x, blocks, compute_dtype, ctx=0, start=None)``."""
        v = self.vcfg
        ranged_fn = ranged("stage")(fn)

        def inner(x, *args, **kwargs):
            self.add(x, v["resblock_kernel_sizes"], v["resblock_dilation_sizes"],
                     kwargs.get("ctx", 0))
            return ranged_fn(x, *args, **kwargs)
        return inner

    def block_wrapper(self, fn):
        """Around ``amp_block(x, block, cfg, kernel_size, dilations, ..., ctx=0)``:
        the stage's work is logged once, at its first block (the direct path
        runs a stage as its blocks, then their average), so that both paths
        count the same stage."""
        v = self.vcfg
        ranged_fn = ranged("stage")(fn)

        def inner(x, block, cfg, kernel_size, dilations, *args, **kwargs):
            if kernel_size == v["resblock_kernel_sizes"][0]:
                self.add(x, v["resblock_kernel_sizes"], v["resblock_dilation_sizes"],
                         kwargs.get("ctx", 0))
            return ranged_fn(x, block, cfg, kernel_size, dilations, *args, **kwargs)
        return inner


@contextlib.contextmanager
def stage_ranges(log: StageLog):
    """Every vocoder stage call in a ``portbench.stage`` range, logged."""
    m = import_program()
    with contextlib.ExitStack() as stack:
        for mod in (m["vocoder"], m["streaming"]):
            stack.enter_context(wrapped(mod, "amp_stack", log.stack_wrapper))
            stack.enter_context(wrapped(mod, "amp_block", log.block_wrapper))
        yield


@contextlib.contextmanager
def call_ranges(events: PhaseEvents | None = None):
    """The codec call's layers in ``portbench.<label>`` ranges (mel, scan,
    vocoder), and timed by ``events`` when given."""
    m = import_program()

    def both(label):
        def make(fn):
            fn = ranged(label)(fn)
            return events.wrap(label)(fn) if events is not None else fn
        return make

    with wrapped(m["codec"], "_mel_impl", both("mel")), \
            wrapped(m["bvrnn"], "encode_decode", both("scan")), \
            wrapped(m["codec"], "_generator_impl", both("vocoder")):
        yield


@contextlib.contextmanager
def capture_scan(holder: dict):
    """``models.bvrnn.encode_decode`` keeping its last (codes, decoded mel)
    in ``holder['scan']``: the codes and mel the codec's call computed."""
    m = import_program()

    def make(fn):
        def inner(*args, **kwargs):
            out = fn(*args, **kwargs)
            holder["scan"] = (out[0], out[1])
            return out
        return inner

    with wrapped(m["bvrnn"], "encode_decode", make):
        yield
