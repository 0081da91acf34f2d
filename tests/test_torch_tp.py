"""The port's tensor-parallel BVRNN scans (bvsc_tpu_torch.parallel.tp) on
gloo ranks on the CPU, against bvsc_tpu.parallel.tp on the virtual CPU
devices and against the port's one-device scans, on the same numpy-seeded
weights at the small config (h 48, z 12).

Gates (``tests/test_tp.py``'s): codes bitwise; mel and h within 2e-5 (a
row-parallel sum splits its contraction, so sums run in another order).
Ranks run in spawned processes that import no JAX
(``tests/torch_parallel_ranks.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.parallel import tp as JT
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, to_torch
from bvsc_tpu_torch.models import bvrnn as B
from torch_parallel_ranks import spawn

torch.set_num_threads(1)

H, Z, X, BATCH, T = 48, 12, 80, 2, 12
TOL = 2e-5
MESHES = [(2, "1d"), (4, "1d"), (4, "2d")]  # ranks, model mesh or 2 x 2 data x model


@pytest.fixture(scope="module")
def setup():
    jcfg = jb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, precision=jax.lax.Precision.HIGHEST)
    tree = jax.tree.map(np.asarray, jb.init_bvrnn_params(jax.random.key(0), jcfg))
    tree["mean_mel"] = np.linspace(-6.0, -4.0, X).astype(np.float32)
    tree["std_mel"] = np.linspace(1.0, 3.0, X).astype(np.float32)
    rng = np.random.default_rng(0)
    z = rng.integers(0, 2, (BATCH, T, Z)).astype(np.float32)
    y = (rng.standard_normal((BATCH, T, X)) - 5.0).astype(np.float32)
    bits = rng.integers(1, Z + 1, (BATCH, T)).astype(np.float32)
    h0 = np.zeros((BATCH, H), np.float32)
    return jcfg, tree, z, y, bits, h0


@pytest.fixture(scope="module")
def port_one_device(setup):
    _, tree, z, y, bits, h0 = setup
    cfg = B.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z)
    p = to_torch(bvrnn_params_from_jax(tree))
    mel, h = B.decode(p, cfg, torch.from_numpy(z), torch.from_numpy(h0))
    codes, h_enc = B.encode_with_state(p, cfg, torch.from_numpy(y), torch.from_numpy(bits),
                                       torch.from_numpy(h0))
    return {"mel": mel.numpy(), "h": h.numpy(), "codes": codes.numpy(), "h_enc": h_enc.numpy()}


@pytest.fixture(scope="module")
def jax_tp(setup):
    jcfg, tree, z, y, bits, h0 = setup
    out = {}
    for n, kind in MESHES:
        mesh = JT.make_dp_tp_mesh(2, n // 2) if kind == "2d" else JT.make_tp_mesh(n)
        tpp = JT.shard_tp_params(mesh, JT.prepare_tp_params(jax.tree.map(jnp.asarray, tree)))
        mel, h = JT.decode_tp(tpp, jcfg, jnp.asarray(z), jnp.asarray(h0), mesh)
        codes, h_enc = JT.encode_tp(tpp, jcfg, jnp.asarray(y), jnp.asarray(bits),
                                    jnp.asarray(h0), mesh)
        out[(n, kind)] = {k: np.asarray(v) for k, v in
                          {"mel": mel, "h": h, "codes": codes, "h_enc": h_enc}.items()}
    return out


@pytest.fixture(scope="module")
def port_tp(setup, tmp_path_factory):
    _, tree, z, y, bits, h0 = setup
    params = bvrnn_params_from_jax(tree)
    cfg = {"x_dim": X, "h_dim": H, "z_dim": Z}
    return {(n, kind): spawn(n, tmp_path_factory.mktemp(f"tp{n}{kind}"), "tp", kind, params,
                             cfg, z, y, bits, h0) for n, kind in MESHES}


def _check(got, ref):
    np.testing.assert_array_equal(got["codes"], ref["codes"])
    for k in ("mel", "h", "h_enc"):
        assert got[k].shape == ref[k].shape
        assert np.abs(got[k] - ref[k]).max() <= TOL, k


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}{m[1]}")
def test_tp_matches_one_device(port_tp, port_one_device, mesh):
    for rank_out in port_tp[mesh]:
        _check(rank_out, port_one_device)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}{m[1]}")
def test_tp_matches_bvsc_tpu(port_tp, jax_tp, mesh):
    _check(port_tp[mesh][0], jax_tp[mesh])


def test_ranks_agree(port_tp):
    """Every rank returns the same global outputs, bitwise."""
    for outs in port_tp.values():
        for other in outs[1:]:
            for k, v in outs[0].items():
                np.testing.assert_array_equal(other[k], v)


def test_prepare_and_layout(setup):
    """The per-gate split keeps the packed [r|z|n] columns, and each leaf of
    the prepared tree has a layout."""
    from bvsc_tpu_torch.parallel import tp as T

    _, tree, *_ = setup
    prep = T.prepare_tp_params(bvrnn_params_from_jax(tree))
    w = tree["gru"]["w_ih"]
    np.testing.assert_array_equal(np.concatenate([prep["gru_ih"][g] for g in "rzn"], -1), w)
    layout = T.tp_param_layout()
    assert set(layout) == set(prep)
