"""The check that decides ``correct`` comes out false on the faults a cell
can have and on its control: a run of each cell (its look for a card
skipped, small widths on the CPU) with the timed path broken underneath.
``pytest portbench/tests``."""

from __future__ import annotations

import pytest
import torch

from portbench import control, run as bench
from portbench.lib import program

CPU = torch.device("cpu")
SEED = 2**31 + 77


def small(cell: str) -> dict:
    spec = bench.cell_spec(cell)
    spec["conf"]["codec"].update(h_dim=48, z_dim=12)
    t = spec["traffic"]
    if t["kind"] == "offline":
        t.update(batch=3, clip_s=0.5, shift_s=0.05, check_rows=2)
    else:
        t.update(slots=4, call_s=[0.2, 0.4], warm_ticks=3, warm_s=0.1, check_share=0.5)
        if t["kind"] == "serve":
            t["bank_rows"] = 2
    return spec


def correct(spec: dict) -> bool:
    rec = bench.run_cell(spec, SEED, 0.3, False, CPU)
    return bench.verdict(rec, spec["limits"])[0]


def altered_codes(fn):
    """The scan's codes with the first bit of each row's first frame turned
    over (a bit every frame carries)."""
    def inner(*args, **kwargs):
        codes, *rest = fn(*args, **kwargs)
        codes = codes.clone()
        codes[:, 0, 0] = 1 - codes[:, 0, 0]
        return (codes, *rest)
    return inner


def altered_wave(fn):
    """The vocoder's waveform with one sample moved by half its peak."""
    def inner(*args, **kwargs):
        y = fn(*args, **kwargs).clone()
        y[..., 300] += 0.5 * y.abs().max()
        return y
    return inner


def altered_step_wave(index: int):
    def make(fn):
        def inner(*args, **kwargs):
            out = list(fn(*args, **kwargs))
            wav = out[index].clone()
            wav[:, 100] += 0.5 * wav.abs().max() + 0.1
            out[index] = wav
            return tuple(out)
        return inner
    return make


def half_batch(fn):
    """The scan run on the first half of the rows, its outputs repeated for
    the rest (the batch's second half left out)."""
    def inner(params, cfg, mel, bits, h, *args, **kwargs):
        n = (mel.shape[0] + 1) // 2
        idx = torch.arange(mel.shape[0], device=mel.device) % n
        out = fn(params, cfg, mel[:n], bits[:n], h[:n],
                 *(a[:n] if torch.is_tensor(a) else a for a in args),
                 **{k: v[:n] if torch.is_tensor(v) else v for k, v in kwargs.items()})
        return tuple(o[idx] for o in out)
    return inner


def unchanged_state(fn):
    """A tick that returns its state as it got it."""
    def inner(w, state, *args, **kwargs):
        out = fn(w, state, *args, **kwargs)
        return (state, *out[1:])
    return inner


OFFLINE = ["varbit-f32.offline-b256", "fixed64-bf16.offline-b512"]


@pytest.mark.parametrize("cell", OFFLINE + ["varbit-f32.serve128", "varbit-f32.decode128-loss10"])
def test_portbench_sound_small_run_is_correct(cell):
    assert correct(small(cell))


@pytest.mark.parametrize("cell", OFFLINE)
@pytest.mark.parametrize("fault", ["codes", "wave", "half_batch"])
def test_portbench_offline_fault_is_not_correct(cell, fault):
    m = program.import_program()
    mod, attr, wrap = {"codes": (m["bvrnn"], "encode_decode", altered_codes),
                       "wave": (m["codec"], "_generator_impl", altered_wave),
                       "half_batch": (m["bvrnn"], "encode_decode", half_batch)}[fault]
    spec = small(cell)
    if fault == "half_batch":  # rows enough that the check's sample meets the left-out half
        spec["traffic"].update(batch=8, check_rows=4)
    with program.wrapped(mod, attr, wrap):
        assert not correct(spec)


@pytest.mark.parametrize("fault", ["codes", "wave", "state"])
def test_portbench_serve_fault_is_not_correct(fault):
    m = program.import_program()
    mod, attr, wrap = {
        "codes": (m["bvrnn"], "encode_decode", altered_codes),
        "wave": (m["streaming"], "_fused_packet_step", altered_step_wave(2)),
        "state": (m["engine"], "_fused_tick", unchanged_state),
    }[fault]
    spec = small("varbit-f32.serve128")
    with program.wrapped(mod, attr, wrap):
        assert not correct(spec)


@pytest.mark.parametrize("fault", ["wave", "state"])
def test_portbench_decode_fault_is_not_correct(fault):
    m = program.import_program()
    mod, attr, wrap = {
        "wave": (m["streaming"], "_packet_decode_step", altered_step_wave(1)),
        "state": (m["engine"], "_decode_tick", unchanged_state),
    }[fault]
    spec = small("varbit-f32.decode128-loss10")
    with program.wrapped(mod, attr, wrap):
        assert not correct(spec)


@pytest.mark.parametrize("cell", OFFLINE + ["varbit-f32.serve128", "varbit-f32.decode128-loss10"])
def test_portbench_control_is_not_correct(cell):
    spec = small(cell)
    got = control.control(spec, SEED, CPU)
    assert not bench.verdict(got, spec["limits"])[0], got
