"""The reference's PyTorch checkpoints in the port (``bvsc_tpu_torch.convert``,
``codec.load_bvrnn_checkpoint`` / ``load_vocoder_checkpoint``) against
``bvsc_tpu.convert`` and ``bvsc_tpu.BVRNNCodecModel`` reading the same
files.  No upstream file is in the checkout: the state dicts are built here
in the upstream key layout that ``bvsc_tpu/convert.py`` reads, from
numpy-seeded weights (a small BVRNN, h 48 and z 12; the vocoder at full
width; discriminators at an eighth of their width).

* The converters give bitwise the trees of the JAX ones (through
  ``*_params_from_jax``) in every layout: weight norm as ``weight_g`` /
  ``weight_v`` or as the parametrization, or a plain ``weight``;
  activations with and without the alias-free ``.act`` level and ``beta``;
  discriminators weight- or spectral-normed.
* Files through both codecs: codes bit-exact, waveform SNR > 40 dB and
  1e-4; under bf16 storage the BVRNN weights bitwise the JAX codec's.
* The port trainers' ``bvrnn_`` / ``g_`` files load their params bitwise,
  told from upstream ``g_`` files by their ``format`` key; an Orbax
  directory is refused naming its exporter.
* ``cli/synthesize`` and ``cli/export_bvrnn_npz`` on upstream files.
"""

import dataclasses
import importlib
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu import convert as jconv
from bvsc_tpu.codec import BVRNNCodecModel as JCodec
from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.eval.metrics import snr_db
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu_torch import BVRNNCodecModel, CodecConfig
from bvsc_tpu_torch import convert as tconv
from bvsc_tpu_torch.cli import export_bvrnn_npz, synthesize
from bvsc_tpu_torch.codec import load_bvrnn_checkpoint, load_vocoder_checkpoint
from bvsc_tpu_torch.data.audio import load_wav, save_wav
from bvsc_tpu_torch.models import discriminators as D
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.train import checkpoint as ckpt
from test_torch_amp_resblock import perturbed_generator_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(h_dim=48, z_dim=12)
L, B = 6615, 2  # 0.3 s at 22.05 kHz
BUCKET = 16
DISC_MULT = 0.125  # the discriminators' width: the layouts do not depend on it
GEN_LAYOUTS = ("weight_g", "parametrizations", "weight")


def _equal_trees(got, ref) -> None:
    """Same names, dtypes and values, bit for bit."""
    got, ref = tconv.flatten_tree(got), tconv.flatten_tree(ref)
    assert sorted(got) == sorted(ref)
    for name in got:
        assert got[name].dtype == ref[name].dtype, name
        assert torch.equal(got[name], ref[name]), name


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _tensors(sd: dict) -> dict:
    """A numpy-valued state dict as torch saves one."""
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _weight_normed(tree: dict, seed: int) -> dict:
    """Each conv ``{w, b}`` as ``{g, v, b}``: v = w, g = ||w|| scaled per
    channel by a seeded factor, so that the fold moves every weight."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) and "w" in node:
            w = np.asarray(node["w"], np.float32)
            norm = np.sqrt((w.astype(np.float64) ** 2).sum(axis=tuple(range(1, w.ndim)),
                                                          keepdims=True))
            g = (norm * rng.uniform(0.5, 1.5, norm.shape)).astype(np.float32)
            return {"g": g, "v": w, "b": np.asarray(node["b"], np.float32)}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(tree)


def _relayout(sd: dict, layout: str = "weight_g", act: bool = False, beta: bool = True) -> dict:
    """An upstream state dict with ``weight_g`` / ``weight_v`` weight norm
    rewritten in ``layout`` (the parametrization; ``weight`` is written as
    such already), activations under the alias-free ``.act`` level, and
    without ``beta`` (Snake)."""
    out = {}
    for k, v in sd.items():
        if layout == "parametrizations":
            k = k.replace(".weight_g", ".parametrizations.weight.original0")
            k = k.replace(".weight_v", ".parametrizations.weight.original1")
        if act and (".activations." in k or k.startswith("activation_post.")):
            head, leaf = k.rsplit(".", 1)
            k = f"{head}.act.{leaf}"
        if not beta and k.endswith(".beta"):
            continue
        out[k] = v
    return out


def _discriminator_sd(tree: list) -> dict:
    """A port MPD / MRD tree -> the upstream state dict (``weight_g`` /
    ``weight_v``, or spectral norm's ``weight_orig`` / ``weight_u`` /
    ``weight_v``)."""
    sd = {}
    for i, disc in enumerate(tree):
        convs = [(f"convs.{j}", p) for j, p in enumerate(disc["convs"])]
        for name, p in convs + [("conv_post", disc["conv_post"])]:
            pre = f"discriminators.{i}.{name}"
            if "w_orig" in p:
                sd.update({f"{pre}.weight_orig": p["w_orig"], f"{pre}.weight_u": p["sn_u"],
                           f"{pre}.weight_v": p["sn_v"]})
            else:
                sd.update({f"{pre}.weight_g": p["g"], f"{pre}.weight_v": p["v"]})
            sd[f"{pre}.bias"] = p["b"]
    return {k: tconv._np(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def jconf():
    return JCodecConfig(**SMALL)


@pytest.fixture(scope="module")
def btree():
    """The small BVRNN's numpy tree (the JAX init, with mel statistics)."""
    bcfg = jb.BVRNNConfig(x_dim=80, h_dim=SMALL["h_dim"], z_dim=SMALL["z_dim"])
    mean_std = (np.random.default_rng(1).standard_normal(80) * 0.5 - 4.0,
                np.abs(np.random.default_rng(2).standard_normal(80)) + 1.0)
    return _jax_numpy(jb.init_bvrnn_params(jax.random.key(0), bcfg, mean_std))


@pytest.fixture(scope="module")
def bvrnn_sd(btree):
    return jconv.bvrnn_params_to_torch_sd(btree)


@pytest.fixture(scope="module")
def vtree(jconf):
    """A full-width generator, folded (perturbed snakes)."""
    return perturbed_generator_params(jconf.vocoder_config, seed=3)


@pytest.fixture(scope="module")
def gen_sds(vtree):
    """The generator's upstream state dict per layout: weight-normed
    (``weight_g`` / ``weight_v`` and the parametrization) or plain."""
    wn = tconv.vocoder_params_to_torch_sd(_weight_normed(vtree, seed=4))
    return {"weight_g": wn, "parametrizations": _relayout(wn, "parametrizations"),
            "weight": tconv.vocoder_params_to_torch_sd(vtree)}


@pytest.fixture(scope="module")
def files(tmp_path_factory, bvrnn_sd, gen_sds):
    """The upstream files: ``bvrnn.pt`` ({'vrnn': sd}) and one BigVGAN
    ``g_00000001`` ({'generator': sd}) per layout."""
    root = tmp_path_factory.mktemp("upstream")
    torch.save({"vrnn": _tensors(bvrnn_sd)}, root / "bvrnn.pt")
    paths = {"bvrnn": str(root / "bvrnn.pt")}
    for layout, sd in gen_sds.items():
        (root / layout).mkdir()
        torch.save({"generator": _tensors(sd)}, root / layout / "g_00000001")
        paths[layout] = str(root / layout / "g_00000001")
    return paths


def _disc_trees():
    vcfg = CodecConfig().vocoder_config
    narrow = dataclasses.replace(vcfg, discriminator_channel_mult=DISC_MULT)
    sn = dataclasses.replace(narrow, mrd_use_spectral_norm=True)
    return {"mpd": D.init_mpd_params(np.random.default_rng(5), narrow),
            "mrd": D.init_mrd_params(np.random.default_rng(6), narrow),
            "mrd_spectral": D.init_mrd_params(np.random.default_rng(7), sn)}


CASES = (["bvrnn", "bvrnn_bf16"]
         + [f"generator-{layout}{act}{beta}" for layout in GEN_LAYOUTS
            for act in ("", "-act") for beta in ("", "-nobeta")]
         + ["mpd-weight_g", "mpd-parametrizations", "mrd-weight_g", "mrd-parametrizations",
            "mrd_spectral"])


@pytest.mark.parametrize("case", CASES)
def test_converters_match_jax(case, bvrnn_sd, gen_sds, jconf):
    """Every converter and layout: the port's tree is bitwise the JAX
    converter's, carried across by ``*_params_from_jax``."""
    vcfg_j, vcfg_t = jconf.vocoder_config, CodecConfig(**SMALL).vocoder_config
    if case.startswith("bvrnn"):
        dtype, jdtype = ((torch.bfloat16, jnp.bfloat16) if case.endswith("bf16")
                         else (torch.float32, jnp.float32))
        got = tconv.bvrnn_params_from_torch(_tensors(bvrnn_sd), dtype=dtype)
        ref = tconv.bvrnn_params_from_jax(
            _jax_numpy(jconv.bvrnn_params_from_torch(bvrnn_sd, dtype=jdtype)), dtype=dtype)
    elif case.startswith("generator"):
        layout = case.split("-")[1]
        sd = _tensors(_relayout(gen_sds[layout], act="-act" in case, beta="-nobeta" not in case))
        got = tconv.vocoder_params_from_torch(sd, vcfg_t)
        ref = tconv.vocoder_params_from_jax(_jax_numpy(jconv.vocoder_params_from_torch(sd,
                                                                                      vcfg_j)))
        assert ("beta" in got["act_post"]) == ("-nobeta" not in case)
    else:
        kind = case.split("-")[0]
        layout = case.split("-")[1] if "-" in case else "weight_g"
        tree = _disc_trees()[kind]
        sd = _tensors(_relayout(_discriminator_sd(tree), layout))
        convert_t, convert_j = ((tconv.mpd_params_from_torch, jconv.mpd_params_from_torch)
                                if kind == "mpd" else
                                (tconv.mrd_params_from_torch, jconv.mrd_params_from_torch))
        got = convert_t(sd, vcfg_t)
        ref = tconv.discriminator_params_from_jax(_jax_numpy(convert_j(sd, vcfg_j)))
        _equal_trees(got, tconv.to_torch(tree))  # the layouts carry the trainer tree as it is
    _equal_trees(got, ref)


def test_fold_weight_norm_matches_jax(gen_sds):
    """The float64 host fold, rounded once, bitwise ``bvsc_tpu``'s."""
    sd = gen_sds["weight_g"]
    for prefix in ("conv_pre", "ups.0.1", "resblocks.5.convs2.1", "conv_post"):
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
        got = tconv.fold_weight_norm(torch.tensor(g), torch.tensor(v))
        ref = jconv.fold_weight_norm(g, v)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_bvrnn_round_trip(btree, bvrnn_sd):
    """``bvrnn_params_from_torch`` inverts ``bvrnn_params_to_torch_sd``
    bitwise, whose state dict is the JAX one's."""
    p = tconv.bvrnn_params_from_jax(btree)
    sd = tconv.bvrnn_params_to_torch_sd(p)
    assert list(sd) == list(bvrnn_sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], bvrnn_sd[k])
    _equal_trees(tconv.bvrnn_params_from_torch(sd), p)


@pytest.fixture(scope="module")
def x():
    return (np.random.default_rng(11).standard_normal((B, L)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def codecs(files, jconf):
    """Both packages' codecs on the upstream BVRNN ``.pt`` and the
    weight-normed ``g_`` file."""
    jc = JCodec(config=jconf, bvrnn_chkpt_path=files["bvrnn"],
                vocoder_chkpt_path=files["weight_g"], length_bucket=BUCKET)
    tc = BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_chkpt_path=files["bvrnn"],
                         vocoder_chkpt_path=files["weight_g"], length_bucket=BUCKET, device="cpu")
    return jc, tc


def test_codec_from_upstream_files_matches_jax(codecs, x):
    """Codes bit-exact, the waveform SNR > 40 dB and 1e-4 of ``bvsc_tpu``'s."""
    jc, tc = codecs
    np.testing.assert_array_equal(tc.encode(x, 3000).numpy(), np.asarray(jc.encode(x, 3000)))
    got, ref = tc(x, 3000).numpy(), np.asarray(jc(x, 3000))
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert snr_db(ref, got) > 40.0
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_codec_from_files_is_the_codec_from_trees(files, btree, vtree, x):
    """The codec built from the ``.pt`` and the plain ``g_`` file computes
    bit for bit what the codec built from the same trees computes (the
    loaded weights are laid out as the ``.npz`` ones: row-major)."""
    kwargs = dict(config=CodecConfig(**SMALL), length_bucket=BUCKET, device="cpu")
    tc = BVRNNCodecModel(bvrnn_chkpt_path=files["bvrnn"], vocoder_chkpt_path=files["weight"],
                         **kwargs)
    ref = BVRNNCodecModel(bvrnn_params=tconv.bvrnn_params_from_jax(btree),
                          vocoder_params=tconv.vocoder_params_from_jax(vtree), **kwargs)
    assert all(t.is_contiguous() for t in tconv.flatten_tree(tc.bvrnn_params).values())
    np.testing.assert_array_equal(tc(x, 3000).numpy(), ref(x, 3000).numpy())


@pytest.mark.parametrize("layout", GEN_LAYOUTS)
def test_codec_reads_every_layout(files, jconf, codecs, x, layout):
    """Each layout's ``g_`` file: the codec's weights bitwise ``bvsc_tpu``'s
    codec's on the same files, and its codes bit-exact."""
    jc = JCodec(config=jconf, bvrnn_chkpt_path=files["bvrnn"], vocoder_chkpt_path=files[layout],
                length_bucket=BUCKET)
    tc = BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_chkpt_path=files["bvrnn"],
                         vocoder_chkpt_path=files[layout], length_bucket=BUCKET, device="cpu")
    _equal_trees(tc.bvrnn_params, tconv.bvrnn_params_from_jax(_jax_numpy(jc.bvrnn_params)))
    _equal_trees(tc.vocoder_params, tconv.vocoder_params_from_jax(_jax_numpy(jc.vocoder_params)))
    np.testing.assert_array_equal(tc.encode(x, 3000).numpy(),
                                  np.asarray(codecs[0].encode(x, 3000)))


def test_bf16_storage_rounds_bvrnn_once(files, jconf):
    """Under ``dtype=bfloat16`` the loaded BVRNN weights are bitwise the JAX
    codec's (each rounded once from float32)."""
    jc = JCodec(config=jconf, bvrnn_chkpt_path=files["bvrnn"], vocoder_chkpt_path=files["weight"],
                length_bucket=BUCKET, dtype=jnp.bfloat16)
    tc = BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_chkpt_path=files["bvrnn"],
                         vocoder_chkpt_path=files["weight"], length_bucket=BUCKET, device="cpu",
                         dtype=torch.bfloat16)
    ref = tconv.bvrnn_params_from_jax(_jax_numpy(jc.bvrnn_params), dtype=torch.bfloat16)
    _equal_trees(tc.bvrnn_params, ref)
    _equal_trees(tc.vocoder_params, tconv.vocoder_params_from_jax(_jax_numpy(jc.vocoder_params),
                                                                  dtype=torch.bfloat16))


def _port_bvrnn_file(path, params: dict) -> None:
    ckpt.save(path, {"format": ckpt.FORMAT, "kind": "bvrnn", "step": 1, "seed": 0,
                     "params": tconv.flatten_tree(params), "opt": {}})


def _port_g_file(path, params: dict) -> None:
    ckpt.save(path, {"format": ckpt.FORMAT, "kind": "generator", "step": 1,
                     "params": tconv.flatten_tree(params)})


def test_port_trainer_files(tmp_path, btree, vtree, files):
    """A port ``bvrnn_`` file and a weight-normed port ``g_`` file give the
    codec the trainer's params bitwise (the generator folded as
    ``fold_generator_params`` folds it); an upstream ``g_`` of the same
    name is told apart by the port's ``format`` key."""
    bparams = tconv.bvrnn_params_from_jax(btree)
    _port_bvrnn_file(str(tmp_path / "bvrnn_00000001"), bparams)
    wn = tconv.to_torch(_weight_normed(vtree, seed=8))
    (tmp_path / "port").mkdir()
    _port_g_file(str(tmp_path / "port" / "g_00000001"), wn)
    codec = BVRNNCodecModel(config=CodecConfig(**SMALL), device="cpu",
                            bvrnn_chkpt_path=str(tmp_path / "bvrnn_00000001"),
                            vocoder_chkpt_path=str(tmp_path / "port" / "g_00000001"))
    _equal_trees(codec.bvrnn_params, bparams)
    _equal_trees(codec.vocoder_params, voc_mod.fold_generator_params(wn))
    vcfg = codec.conf.vocoder_config
    upstream = load_vocoder_checkpoint(files["weight"], vcfg)
    _equal_trees(upstream, tconv.to_torch(vtree))
    assert os.path.basename(files["weight"]) == "g_00000001"
    with pytest.raises(ValueError, match="bvrnn trainer checkpoint of the port"):
        load_bvrnn_checkpoint(str(tmp_path / "port" / "g_00000001"))
    with pytest.raises(ValueError, match="generator or gan trainer checkpoint"):
        load_vocoder_checkpoint(str(tmp_path / "bvrnn_00000001"), vcfg)


@pytest.mark.parametrize("which", ["bvrnn", "vocoder"])
def test_directories_are_refused(tmp_path, which):
    """A directory (``bvsc_tpu``'s Orbax checkpoint) raises ValueError
    naming the exporter that writes the ``.npz`` the port reads."""
    exporter = {"bvrnn": "scripts/export_bvrnn_npz.py",
                "vocoder": "tools/export_vocoder_npz.py"}[which]
    with pytest.raises(ValueError, match=f"Orbax.*{exporter}"):
        BVRNNCodecModel(config=CodecConfig(**SMALL), device="cpu",
                        **{f"{which}_chkpt_path": str(tmp_path)})


def _jax_script(name: str):
    scripts = os.path.join(REPO, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def test_export_bvrnn_npz_reads_upstream(tmp_path, files):
    """``cli/export_bvrnn_npz`` on the upstream ``.pt``: the float16 arrays
    of ``scripts/export_bvrnn_npz.py`` on the same file, bit for bit."""
    flat = export_bvrnn_npz.export(files["bvrnn"], str(tmp_path / "port.npz"))
    _jax_script("export_bvrnn_npz").main([files["bvrnn"], str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "jax.npz") as ref, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(ref.files) == sorted(flat)
        for k in ref.files:
            assert got[k].dtype == np.float16
            np.testing.assert_array_equal(got[k], ref[k])


def test_synthesize_reads_upstream_g(tmp_path, files, vtree, gen_sds, jconf):
    """``cli/synthesize`` on an upstream ``g_`` writes, bit for bit, the wav
    it writes from the ``.npz`` of the tree ``bvsc_tpu`` converts from the
    same state dict: the plain ``weight`` layout and the weight-normed one."""
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    save_wav(np.random.default_rng(9).standard_normal(4096).astype(np.float32) * 0.1,
             str(wavs / "a.wav"), 22050)
    jtree = _jax_numpy(jconv.vocoder_params_from_torch(gen_sds["weight_g"],
                                                       jconf.vocoder_config))
    np.savez(tmp_path / "plain.npz", **tconv.flatten_tree(vtree))
    np.savez(tmp_path / "folded.npz", **tconv.flatten_tree(jtree))
    out = {}
    for name, path in (("plain.npz", str(tmp_path / "plain.npz")), ("weight", files["weight"]),
                       ("folded.npz", str(tmp_path / "folded.npz")),
                       ("weight_g", files["weight_g"])):
        dst = tmp_path / f"out_{name}"
        synthesize.main(["--input_wavs_dir", str(wavs), "--output_dir", str(dst),
                         "--checkpoint_file", path, "--device", "cpu",
                         "--config", os.path.join(REPO, "configs", "varbitrate.toml")])
        out[name] = load_wav(str(dst / "a_generated.wav"))[0]
    np.testing.assert_array_equal(out["weight"], out["plain.npz"])
    np.testing.assert_array_equal(out["weight_g"], out["folded.npz"])
    assert not np.array_equal(out["weight_g"], out["weight"])
