"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no source file of the port (nor chip_smoke.py) imports them."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bvsc_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "bvsc_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        if rel.startswith("bvsc_tpu_torch"):
            mod = rel[:-3].replace(os.sep, ".")
            mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return mods


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'bvsc_tpu'))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


TRAINING = ("bvsc_tpu_torch.data.augment", "bvsc_tpu_torch.data.dataset",
            "bvsc_tpu_torch.utils.logging", "bvsc_tpu_torch.ops.stft_loss",
            "bvsc_tpu_torch.models.discriminators", "bvsc_tpu_torch.models.losses",
            "bvsc_tpu_torch.train.optim", "bvsc_tpu_torch.train.bvrnn_train",
            "bvsc_tpu_torch.train.vocoder_train", "bvsc_tpu_torch.train.checkpoint",
            "bvsc_tpu_torch.cli.train_bvrnn", "bvsc_tpu_torch.cli.train_vocoder",
            "bvsc_tpu_torch.cli.export_bvrnn_npz")


@pytest.mark.parametrize("module", TRAINING)
def test_training_modules_are_checked(module):
    """The training path's modules are among those the two tests above
    import and read."""
    assert module in _port_modules()
