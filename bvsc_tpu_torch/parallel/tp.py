"""Tensor-parallel BVRNN encode and decode, Megatron-style over a ``model``
axis (port of ``bvsc_tpu/parallel/tp.py``).

Data parallelism does nothing for one stream's latency: each frame of the
scan reads all of the BVRNN's weights (~23 M at h 1024).  Sharding them
over a ``model`` axis divides each rank's weight traffic by its size.  With
H = h_dim and D ranks on the axis, each rank owns H / D hidden units:

  dec MLP   col -> row (sum) -> col -> row (sum)
  phi_x MLP col -> row (sum) -> col -> all-gather (the GRU's input is full)
  GRU       column-parallel per gate: full (x, h) in, the local slice of h
            out; h is all-gathered once at each step's start

so a step makes 3 sums and 2 all-gathers of (B, H)-sized tensors
(``parallel.collectives``).  The math is ``models.bvrnn``'s one-device
``decode`` / ``encode_with_state`` up to float32 summation order (a
row-parallel sum splits its contraction), in the reference's order of
operations: a row-parallel bias added once after the sum; phi_z hoisted
over the sequence and replicated in decode, per step in encode;
``torch.round`` half to even; masked bits 0.5; a fixed-rate model ignores
the bitrate.  The products are torch GEMMs, as the one-device scan's are:
no Pallas kernel lies here.

Under the bf16 storage dtype (``cfg.dtype``, the shards from
``shard_tp_params(dtype=torch.bfloat16)``) the inputs, the state and every
op are bf16 as on one device; a row-parallel partial product stays float32
until its sum over the ranks, which is rounded once, as one device's
product is.

SPMD: every rank of the mesh calls the same function with the same global
inputs and gets the global outputs back.  On a 2-D (data x model) mesh the
batch's rows are split over ``data`` (contiguous blocks) and gathered again
at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bvsc_tpu_torch.convert import to_torch
from bvsc_tpu_torch.models import bvrnn as B
from bvsc_tpu_torch.parallel.collectives import all_gather, all_sum
from bvsc_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_2d_mesh, make_mesh, row_blocks

MODEL_AXIS = "model"


def make_tp_mesh(n_devices: int | None = None, devices=None,
                 axis_name: str = MODEL_AXIS) -> Mesh:
    return make_mesh(n_devices, devices, axis_name)


def make_dp_tp_mesh(n_data: int, n_model: int, devices=None, data_axis: str = DATA_AXIS,
                    model_axis: str = MODEL_AXIS) -> Mesh:
    """2-D mesh: streams split over ``data`` x weights over ``model`` (the
    composed serving layout: batch throughput x one stream's latency)."""
    return make_2d_mesh(n_data, n_model, (data_axis, model_axis), devices)


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------


def prepare_tp_params(params) -> dict:
    """A BVRNN tree with the packed [r|z|n] GRU matrices split per gate, so
    that each can be column-split; the MLP stacks pass through."""
    gru = params["gru"]
    H = gru["w_hh"].shape[0]

    def gates(w):
        return {"r": w[..., :H], "z": w[..., H: 2 * H], "n": w[..., 2 * H:]}

    return {
        "dec": params["dec"], "phi_x": params["phi_x"], "phi_z": params["phi_z"],
        "enc": params["enc"],
        "gru_ih": gates(gru["w_ih"]), "gru_hh": gates(gru["w_hh"]),
        "gru_bih": gates(gru["b_ih"]), "gru_bhh": gates(gru["b_hh"]),
        "mean_mel": params["mean_mel"], "std_mel": params["std_mel"],
    }


COL, ROW, REPL = "col", "row", "repl"


def tp_param_layout() -> dict:
    """How each leaf of :func:`prepare_tp_params`'s tree is split (JAX's
    ``tp_param_specs``): ``col`` weights keep their output columns' slice
    and biases their slice, ``row`` weights their input rows' slice; a
    row-parallel layer's bias and everything ``repl`` stay whole."""
    col, row = {"w": COL, "b": COL}, {"w": ROW, "b": REPL}
    gates = {k: COL for k in ("r", "z", "n")}
    return {
        "dec": [col, row, col, row],  # [2H->H col] [H->H row] [H->H col] [H->x row]
        "phi_x": [col, row, col],  # [x->H col] [H->H row] [H->H col, gathered]
        "phi_z": [{"w": REPL, "b": REPL} for _ in range(3)],  # hoisted, replicated
        "enc": [col, row, col],  # [2H->H col] [H->H row] [H->z col, gathered]
        "gru_ih": gates, "gru_hh": gates, "gru_bih": gates, "gru_bhh": gates,
        "mean_mel": REPL, "std_mel": REPL,
    }


def _split(t: torch.Tensor, how: str, index: int, size: int) -> torch.Tensor:
    if how == REPL or size == 1:
        return t.contiguous()
    dim = 0 if how == ROW or t.dim() == 1 else t.dim() - 1
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"a dimension of {n} does not divide over {size} model ranks")
    return t.narrow(dim, index * (n // size), n // size).contiguous()


def shard_tp_params(tp_params, mesh: Mesh, axis_name: str = MODEL_AXIS,
                    dtype: torch.dtype = torch.float32) -> dict:
    """This rank's slices of :func:`prepare_tp_params`'s tree (numpy or
    tensors), in ``dtype`` (the storage type) on its device, laid out as
    :func:`tp_param_layout`."""
    ax = mesh.axis(axis_name)

    def walk(node, how):
        if isinstance(how, dict):
            return {k: walk(node[k], how[k]) for k in how}
        if isinstance(how, list):
            return [walk(n, h) for n, h in zip(node, how)]
        return _split(to_torch(node, mesh.device, dtype=dtype), how, ax.index, ax.size)

    return walk(tp_params, tp_param_layout())


# ---------------------------------------------------------------------------
# The sharded scans
# ---------------------------------------------------------------------------


def _col(x, p, prec):
    """Column-parallel Linear: full input, this rank's output slice."""
    return B._matmul(x, p["w"], prec) + p["b"]


def _row(x_loc, p, prec, ax):
    """Row-parallel Linear: this rank's input slice, summed to the full
    output, the bias added once after the sum; a bf16 partial product is
    summed in float32 and rounded once."""
    if x_loc.dtype == torch.bfloat16:
        part = torch.matmul(x_loc.to(torch.float32), p["w"].to(torch.float32))
        return all_sum(part, ax).to(torch.bfloat16) + p["b"]
    return all_sum(B._matmul(x_loc, p["w"], prec), ax) + p["b"]


def _dec_and_gru(p, prec, ax, phi_z_t, h_full_t, h_loc):
    """The closed loop's tail: dec MLP -> phi_x of the generated frame ->
    GRU.  Returns (dec_t, full; the next h, this rank's slice)."""
    a = F.elu(_col(torch.cat([phi_z_t, h_full_t], -1), p["dec"][0], prec))
    a = F.elu(_row(a, p["dec"][1], prec, ax))
    a = F.elu(_col(a, p["dec"][2], prec))
    dec_t = _row(a, p["dec"][3], prec, ax)
    xn = (dec_t - p["mean_mel"]) / p["std_mel"]
    b = F.elu(_col(xn, p["phi_x"][0], prec))
    b = F.elu(_row(b, p["phi_x"][1], prec, ax))
    b = F.elu(_col(b, p["phi_x"][2], prec))
    x_in = torch.cat([all_gather(b, ax, -1), phi_z_t], -1)
    gi = {g: B._matmul(x_in, p["gru_ih"][g], prec) + p["gru_bih"][g] for g in "rzn"}
    gh = {g: B._matmul(h_full_t, p["gru_hh"][g], prec) + p["gru_bhh"][g] for g in "rzn"}
    r = B._sigmoid(gi["r"] + gh["r"])
    zg = B._sigmoid(gi["z"] + gh["z"])
    n = torch.tanh(gi["n"] + r * gh["n"])
    return dec_t, (1.0 - zg) * n + zg * h_loc


def _local_rows(mesh: Mesh, *xs, dtype: torch.dtype = torch.float32):
    """Each input on this rank's device in ``dtype``, cut to its rows of the
    ``data`` axis."""
    ax = mesh.axis(DATA_AXIS)
    out = []
    for x in xs:
        x = torch.as_tensor(x).to(mesh.device, torch.float32).to(dtype)
        out.append(x[row_blocks(x.shape[0], ax.size)[ax.index]])
    return out


def _global_rows(mesh: Mesh, *xs):
    ax = mesh.axis(DATA_AXIS)
    return tuple(all_gather(x.contiguous(), ax, 0) for x in xs)


def _h_slice(h_full: torch.Tensor, ax) -> torch.Tensor:
    n = h_full.shape[-1] // ax.size
    return h_full[..., ax.index * n: (ax.index + 1) * n]


@torch.no_grad()
def decode_tp(tp_params: dict, cfg: B.BVRNNConfig, z, h0, mesh: Mesh,
              axis_name: str = MODEL_AXIS) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor-parallel closed-loop decode (``models.bvrnn.decode``'s
    semantics, the standard cell).  ``tp_params`` is this rank's
    :func:`shard_tp_params`; z (B, T, z_dim) codes and h0 (B, h_dim), the
    same on every rank.  Returns (mel (B, T, x_dim), final h (B, h_dim)) on
    every rank, on its device."""
    ax, prec = mesh.axis(axis_name), cfg.precision
    p = tp_params
    z, h0 = _local_rows(mesh, z, h0, dtype=cfg.dtype)
    phi_z = B._mlp_elu(p["phi_z"], z, prec, F.elu)  # hoisted, replicated
    h_loc, decs = _h_slice(h0, ax), []
    for phi_z_t in phi_z.unbind(1):
        h_full = all_gather(h_loc, ax, -1)
        dec_t, h_loc = _dec_and_gru(p, prec, ax, phi_z_t, h_full, h_loc)
        decs.append(dec_t)
    return _global_rows(mesh, torch.stack(decs, 1), all_gather(h_loc, ax, -1))


@torch.no_grad()
def encode_tp(tp_params: dict, cfg: B.BVRNNConfig, y, var_bitrate, h0, mesh: Mesh,
              axis_name: str = MODEL_AXIS) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor-parallel greedy encode (``models.bvrnn.encode_with_state``'s
    semantics): the enc MLP col -> row -> col (gathered over z), then the
    closed loop's tail.  y (B, T, x_dim) mels, var_bitrate (B, T)
    bits/frame (ignored by a fixed-rate model), h0 (B, h_dim), the same on
    every rank.  Returns (codes (B, T, z_dim), final h) on every rank.
    z_dim and h_dim must divide over the axis."""
    ax, prec = mesh.axis(axis_name), cfg.precision
    p = tp_params
    if var_bitrate is None:
        if cfg.var_bit:
            raise ValueError("var_bit config needs a bitrate")
        var_bitrate = torch.zeros(y.shape[:2])
    (bits,) = _local_rows(mesh, var_bitrate)
    y, h0 = _local_rows(mesh, y, h0, dtype=cfg.dtype)
    ynorm = (y - p["mean_mel"]) / p["std_mel"]
    a = F.elu(_col(ynorm, p["phi_x"][0], prec))  # phi_x of the input, hoisted
    a = F.elu(_row(a, p["phi_x"][1], prec, ax))
    phi_x = all_gather(F.elu(_col(a, p["phi_x"][2], prec)), ax, -1)
    if cfg.var_bit:
        mask = B.bit_mask_from_bitrate(bits, cfg.z_dim, cfg.dtype)
    else:
        mask = torch.ones(*bits.shape, cfg.z_dim, device=bits.device, dtype=cfg.dtype)
    h_loc, codes = _h_slice(h0, ax), []
    for phi_x_t, mask_t in zip(phi_x.unbind(1), mask.unbind(1)):
        h_full = all_gather(h_loc, ax, -1)
        e = F.elu(_col(torch.cat([phi_x_t, h_full], -1), p["enc"][0], prec))
        e = F.elu(_row(e, p["enc"][1], prec, ax))
        enc_t = B._sigmoid(all_gather(_col(e, p["enc"][2], prec), ax, -1))
        z_t = B._apply_bit_mask(torch.round(enc_t), mask_t)
        phi_z_t = B._mlp_elu(p["phi_z"], z_t, prec, F.elu)
        _, h_loc = _dec_and_gru(p, prec, ax, phi_z_t, h_full, h_loc)
        codes.append(z_t)
    return _global_rows(mesh, torch.stack(codes, 1), all_gather(h_loc, ax, -1))
