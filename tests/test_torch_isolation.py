"""The port stands alone: importing every module of triplegan_tpu_torch
pulls in no jax, no ml_collections, nothing of triplegan_tpu, no PIL
(sample grids are written without it) and no scikit-learn (the digits
data ships with the package), and it asks for the card unless told to use
the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import triplegan_tpu_torch  # noqa: E402
from triplegan_tpu_torch.utils.platform import resolve_device  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    names = ["triplegan_tpu_torch"]
    for info in pkgutil.walk_packages(triplegan_tpu_torch.__path__, "triplegan_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax_or_the_jax_package():
    modules = _all_modules()
    for m in ("ops.scale_bias_act", "ops.conv3x3", "train.step", "train.losses",
              "train.schedule", "train.state", "data.datasets", "cli", "train.loop",
              "ckpt.manager", "eval.metrics", "eval.sample", "data.pipeline", "utils.logging",
              "data.prepare", "data.download", "doctor", "utils.profiling", "utils.debug",
              "utils.cache", "ops.winograd", "tools.stats", "tools.campaign", "tools.seed_campaign",
              "tools.digits_experiment", "tools.parity", "tools.digits_quality", "tools.flagset_ab"):
        assert f"triplegan_tpu_torch.{m}" in modules
    # A fresh interpreter: this test process has imported jax already.
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ml_collections' or m.startswith('ml_collections.')\n"
        "             or m == 'triplegan_tpu' or m.startswith('triplegan_tpu.')\n"
        "             or m == 'PIL' or m.startswith('PIL.')\n"
        "             or m == 'sklearn' or m.startswith('sklearn.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _py_modules(package_dir):
    """The package's .py modules as paths relative to it."""
    out = set()
    for root, _, files in os.walk(package_dir):
        out |= {os.path.relpath(os.path.join(root, f), package_dir) for f in files if f.endswith(".py")}
    return out


def test_every_module_of_the_jax_package_has_its_counterpart():
    """The port does what the JAX package does: every module of it, but
    the Pallas kernels' (whose counterparts are the CUDA kernels of
    ops/csrc), has a module of the same path in the port."""
    jax_modules = {m for m in _py_modules(os.path.join(REPO, "triplegan_tpu"))
                   if not os.path.basename(m).startswith("pallas_")}
    assert sorted(jax_modules - _py_modules(os.path.join(REPO, "triplegan_tpu_torch"))) == []


def test_resolve_device_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("mps")


def test_resolve_device_pins_float32():
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


def test_sample_grid_module_imports_no_imaging_package():
    """eval.sample writes PNGs with zlib and struct: in a fresh interpreter
    it imports no PIL, whatever else is installed."""
    code = ("import sys, triplegan_tpu_torch.eval.sample, triplegan_tpu_torch.train.loop\n"
            "print(any(m == 'PIL' or m.startswith('PIL.') for m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_serving_defaults_to_the_card(tmp_path):
    """The CLI's default device is cuda: without a card it fails loudly
    instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import numpy as np

    from triplegan_tpu_torch.cli import main

    np.savez(tmp_path / "params.npz")  # empty: the device check fails before weights load
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--config", "mnist100", "--params", str(tmp_path / "params.npz")])
