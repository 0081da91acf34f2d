"""Packet-loss concealment in the port (bvsc_tpu_torch.models.bvrnn
.decode_plc, prior_apply, and BVRNNCodecModel.decode(lost=, conceal_bitrate=,
conceal_mode=)) against bvsc_tpu's, at the small config of tests/test_plc.py
(h 48, z 12) on the same seeded numpy weights carried across with convert.

* decode_plc in 'expect' and 'map' mode, with and without conceal_bits, in
  the standard and the fused cell: mel and h to 2e-5 (the BVRNN gate); the
  int8 form (standard cell) to the same gate.
* Within the port: no loss is bitwise decode; a concealed frame equals the
  prior at the state before it, masked, substituted by hand (1e-4); nothing
  before the first loss changes, and the state re-converges after a burst.
* The codec surface against the JAX codec's, with the full-width vocoder:
  SNR > 40 dB and 1e-4 abs; its errors and 1-D mask promotion.

'map' rounds the prior, so an epsilon in h flips a bit where P is near 0.5;
the seed and loss pattern keep P away from it, and the tests print the
smallest |P - 0.5| met on a lost frame.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.codec import BVRNNCodecModel as JCodec
from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.eval.metrics import snr_db
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.ops import quant as jq
from bvsc_tpu_torch import BVRNNCodecModel, CodecConfig
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, vocoder_params_from_jax
from bvsc_tpu_torch.models import bvrnn as tb
from bvsc_tpu_torch.ops import quant as tq
from test_torch_amp_resblock import perturbed_generator_params

torch.set_num_threads(1)

X_DIM, H_DIM, Z_DIM = 16, 48, 12
T, B = 40, 3
TOL = 2e-5  # the BVRNN gate of the port (ROADMAP.md)
MANUAL_TOL = 1e-4  # tests/test_plc.py's manual-substitution bound
CONCEAL_BITS = 5.0
MODES = ["expect", "map"]
CELLS = ["standard", "fused"]


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(cell):
    fused = cell == "fused"
    return (jb.BVRNNConfig(x_dim=X_DIM, h_dim=H_DIM, z_dim=Z_DIM,
                           precision=jax.lax.Precision.HIGHEST, fused_cell=fused),
            tb.BVRNNConfig(x_dim=X_DIM, h_dim=H_DIM, z_dim=Z_DIM, fused_cell=fused))


@pytest.fixture(scope="module")
def tree():
    """Seeded numpy weights (the port's init), with mel statistics."""
    mean_std = (np.random.default_rng(1).standard_normal(X_DIM) * 0.1,
                np.abs(np.random.default_rng(2).standard_normal(X_DIM)) + 0.5)
    return tb.init_bvrnn_params(5, _cfgs("standard")[1], mean_std)


@pytest.fixture(scope="module")
def codes(tree):
    """Codes of a seeded input from the JAX encoder at a per-frame VBR
    schedule (so masked 0.5 bits appear)."""
    rng = np.random.default_rng(11)
    y = rng.standard_normal((B, T, X_DIM)).astype(np.float32)
    bits = rng.integers(4, Z_DIM + 1, size=(B, T)).astype(np.float32)
    jcfg = _cfgs("standard")[0]
    z, _ = jb.encode(jax.tree.map(_j, tree), jcfg, _j(y), _j(bits), jnp.zeros((B, H_DIM)))
    return np.asarray(z)


@pytest.fixture(scope="module")
def lost():
    """~15 % Bernoulli losses per stream and one 3-frame burst; frame 0 is
    received."""
    rng = np.random.default_rng(21)
    m = (rng.random((B, T)) < 0.15).astype(np.float32)
    m[1, 20:23] = 1.0
    m[:, 0] = 0.0
    return m


def _port_params(tree):
    return bvrnn_params_from_jax(tree)


def _h0():
    return np.zeros((B, H_DIM), np.float32)


def _prior_gaps(monkeypatch, lost_mask):
    """Wrap the port's prior_apply to record min |P - 0.5| over the rows
    whose frame is lost, in call order."""
    calls, gaps = [], []
    real = tb.prior_apply
    steps = [t for t in range(T) if lost_mask[:, t].any()]

    def spy(params, h, precision="highest"):
        p = real(params, h, precision)
        t = steps[len(calls)]
        calls.append(t)
        rows = lost_mask[:, t] > 0
        gaps.append(float((p[_t(rows)] - 0.5).abs().min()))
        return p

    monkeypatch.setattr(tb, "prior_apply", spy)
    return gaps


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("with_bits", [False, True], ids=["all_bits", "conceal_bits"])
def test_decode_plc_matches_jax(tree, codes, lost, monkeypatch, cell, mode, with_bits):
    jcfg, tcfg = _cfgs(cell)
    cbits = np.full((B, T), CONCEAL_BITS, np.float32) if with_bits else None
    mel, h = jb.decode_plc(jax.tree.map(_j, tree), jcfg, _j(codes), _j(lost), _j(_h0()),
                           None if cbits is None else _j(cbits), mode=mode)
    gaps = _prior_gaps(monkeypatch, lost)
    tmel, th = tb.decode_plc(_port_params(tree), tcfg, _t(codes), _t(lost), _t(_h0()),
                             None if cbits is None else _t(cbits), mode=mode)
    print(f"{cell} {mode}: smallest |P - 0.5| on a lost frame {min(gaps):.3g}")
    assert len(gaps) == int(lost.any(0).sum())  # the prior ran on every step with a loss
    np.testing.assert_allclose(tmel.numpy(), np.asarray(mel), atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=TOL)


@pytest.mark.parametrize("mode", MODES)
def test_int8_decode_plc_matches_jax(tree, codes, lost, mode):
    """Weight-only int8 trees (standard cell: the fused cell refuses them)."""
    jcfg, tcfg = _cfgs("standard")
    jq_tree = jq.quantize_bvrnn_params(jax.tree.map(_j, tree))
    tq_tree = tq.quantize_bvrnn_params(_port_params(tree))
    cbits = np.full((B, T), CONCEAL_BITS, np.float32)
    mel, h = jb.decode_plc(jq_tree, jcfg, _j(codes), _j(lost), _j(_h0()), _j(cbits), mode=mode)
    tmel, th = tb.decode_plc(tq_tree, tcfg, _t(codes), _t(lost), _t(_h0()), _t(cbits), mode=mode)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(mel), atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=TOL)


def test_prior_apply_matches_jax(tree):
    h = np.random.default_rng(3).standard_normal((B, H_DIM)).astype(np.float32)
    ref = jb.prior_apply(jax.tree.map(_j, tree), _j(h), jax.lax.Precision.HIGHEST)
    got = tb.prior_apply(_port_params(tree), _t(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    assert ((got > 0) & (got < 1)).all()


@pytest.mark.parametrize("cell", CELLS)
def test_no_loss_is_decode(tree, codes, cell):
    """lost all zero: bitwise the port's own decode, mel and state."""
    _, tcfg = _cfgs(cell)
    p = _port_params(tree)
    mel, h = tb.decode(p, tcfg, _t(codes), _t(_h0()))
    for mode in MODES:
        pmel, ph = tb.decode_plc(p, tcfg, _t(codes), torch.zeros(B, T), _t(_h0()), mode=mode)
        assert torch.equal(pmel, mel) and torch.equal(ph, h)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", MODES)
def test_concealed_frame_is_the_masked_prior(tree, codes, cell, mode):
    """One lost frame decodes as the prior at the state before it, rounded
    in 'map' mode, masked to conceal_bits, substituted into the codes by
    hand and run through the plain decode; frames before it are bitwise
    unchanged."""
    _, tcfg = _cfgs(cell)
    p = _port_params(tree)
    t_lost = 7
    _, h_t = tb.decode(p, tcfg, _t(codes[:, :t_lost]), _t(_h0()))
    prior = tb.prior_apply(tb.prepare(p, tcfg).std, h_t)
    prior = torch.round(prior) if mode == "map" else prior
    lost = torch.zeros(B, T)
    lost[:, t_lost] = 1.0
    for cbits, k in ((None, Z_DIM), (torch.full((B, T), CONCEAL_BITS), int(CONCEAL_BITS))):
        manual = torch.from_numpy(codes.copy())
        manual[:, t_lost] = prior
        manual[:, t_lost, k:] = 0.5
        mel_manual, _ = tb.decode(p, tcfg, manual, _t(_h0()))
        mel, _ = tb.decode_plc(p, tcfg, _t(codes), lost, _t(_h0()), cbits, mode=mode)
        assert torch.equal(mel[:, :t_lost], mel_manual[:, :t_lost])
        np.testing.assert_allclose(mel.numpy(), mel_manual.numpy(), atol=MANUAL_TOL)


@pytest.mark.parametrize("cell", CELLS)
def test_causal_and_reconverges_after_burst(tree, codes, cell):
    """A 3-frame burst: nothing before it changes, and the mel error well
    after it is a small fraction of the error at it (GRU forgetting), as in
    tests/test_plc.py."""
    _, tcfg = _cfgs(cell)
    p = _port_params(tree)
    clean, _ = tb.decode(p, tcfg, _t(codes), _t(_h0()))
    lost = torch.zeros(B, T)
    lost[:, 10:13] = 1.0
    mel, _ = tb.decode_plc(p, tcfg, _t(codes), lost, _t(_h0()))
    err = (mel - clean).abs().mean(dim=(0, 2)).numpy()
    assert (err[:10] == 0).all()
    assert err[10:13].max() > 0
    tail, peak = err[T - 8:].mean(), err[10:16].max()
    assert tail < 0.3 * peak, f"no re-convergence: tail {tail:.4g} vs peak {peak:.4g}"


def test_unknown_mode_raises(tree, codes):
    with pytest.raises(ValueError, match="unknown concealment mode"):
        tb.decode_plc(_port_params(tree), _cfgs("standard")[1], _t(codes), torch.zeros(B, T),
                      _t(_h0()), mode="x")


# -- the codec surface: small BVRNN, full-width vocoder ----------------------

SMALL = dict(h_dim=H_DIM, z_dim=Z_DIM)
L, CB = 6615, 2  # 0.3 s at 22.05 kHz
BUCKET = 16


@pytest.fixture(scope="module")
def codecs():
    jconf = JCodecConfig(**SMALL)
    bcfg = tb.BVRNNConfig(x_dim=80, h_dim=H_DIM, z_dim=Z_DIM)
    mean_std = (np.random.default_rng(1).standard_normal(80) * 0.5 - 4.0,
                np.abs(np.random.default_rng(2).standard_normal(80)) + 1.0)
    btree = tb.init_bvrnn_params(6, bcfg, mean_std)
    vtree = perturbed_generator_params(jconf.vocoder_config, seed=3)
    jc = JCodec(config=jconf, bvrnn_params=jax.tree.map(_j, btree),
                vocoder_params=jax.tree.map(_j, vtree), length_bucket=BUCKET)
    tc = BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_params=bvrnn_params_from_jax(btree),
                         vocoder_params=vocoder_params_from_jax(vtree), length_bucket=BUCKET,
                         device="cpu")
    return jc, tc


@pytest.fixture(scope="module")
def stream(codecs):
    """Codes of a seeded input, and a loss mask over its frames (~10 %
    Bernoulli losses and a 2-frame burst per stream)."""
    jc, _ = codecs
    x = (np.random.default_rng(12).standard_normal((CB, L)) * 0.3).astype(np.float32)
    codes = np.asarray(jc.encode(x, 3000))
    n = codes.shape[1]
    m = (np.random.default_rng(13).random((CB, n)) < 0.1).astype(np.float32)
    m[:, n // 2: n // 2 + 2] = 1.0
    m[:, 0] = 0.0
    return codes, m


@pytest.mark.parametrize("mode,conceal_bitrate", [("expect", None), ("expect", 3000),
                                                   ("map", 1500)])
def test_codec_decode_lost_matches_jax(codecs, stream, mode, conceal_bitrate):
    jc, tc = codecs
    codes, lost = stream
    kw = dict(lost=lost, conceal_bitrate=conceal_bitrate, conceal_mode=mode)
    ref = np.asarray(jc.decode(codes, L, **kw))
    got = tc.decode(codes, L, **kw).numpy()
    assert got.shape == ref.shape == (CB, L) and np.isfinite(got).all()
    assert snr_db(ref, got) > 40.0
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_codec_decode_lost_within_port(codecs, stream):
    """No loss is bitwise decode; audio before each stream's first lost
    frame is bitwise the clean decode's; a per-frame conceal_bitrate and a
    tensor mask are taken."""
    _, tc = codecs
    codes, lost = stream
    clean = tc.decode(codes, L)
    assert torch.equal(tc.decode(codes, L, lost=np.zeros_like(lost)), clean)
    out = tc.decode(codes, L, lost=torch.from_numpy(lost),
                    conceal_bitrate=np.full(lost.shape[1], 3000.0))
    assert torch.equal(out, tc.decode(codes, L, lost=lost, conceal_bitrate=3000))
    hop = tc.conf.hopsize
    for b in range(CB):
        first = int(np.argmax(lost[b] > 0))
        assert torch.equal(out[b, : first * hop], clean[b, : first * hop])
        assert not torch.equal(out[b], clean[b])


def test_codec_1d_mask_promotion(codecs, stream):
    _, tc = codecs
    codes, lost = stream
    one = tc.decode(codes[0], L, lost=lost[0], conceal_mode="map")
    assert one.shape == (L,)
    assert torch.equal(one, tc.decode(codes[:1], L, lost=lost[:1], conceal_mode="map")[0])


@pytest.mark.parametrize("case", ["short_mask", "batch_mismatch", "unknown_mode"])
def test_codec_decode_errors_match_jax(codecs, stream, case):
    """The port raises the JAX codec's ValueError, with its wording."""
    jc, tc = codecs
    codes, lost = stream
    kw = {"short_mask": dict(lost=lost[:, 1:]), "batch_mismatch": dict(lost=lost[0]),
          "unknown_mode": dict(lost=lost, conceal_mode="x")}[case]
    with pytest.raises(ValueError) as ref:
        jc.decode(codes, L, **kw)
    with pytest.raises(ValueError) as got:
        tc.decode(codes, L, **kw)
    assert str(got.value) == str(ref.value)
