"""The port's ``utils/debug.py`` (``checkify_step``), ``utils/cache.py``
(``enable_build_cache`` and the build directory of ``ops/build.py``) and
``utils/profiling.py`` (``trace``, ``step_timer``), on the CPU.

``checkify_step`` as the JAX package's ``tests/test_debug.py`` holds its
own: a clean step passes (and returns what the unchecked step returns,
bitwise), a poisoned ``z`` raises naming the operator; here also a NaN
that first appears in a gradient, and the refusal of a ``ScanChunk``."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.helpers import tiny_config  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from triplegan_tpu_torch.data.pipeline import BatchSampler  # noqa: E402
from triplegan_tpu_torch.ops import build  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402
from triplegan_tpu_torch.train.step import make_scan_device_train_step, make_train_step  # noqa: E402
from triplegan_tpu_torch.utils.cache import enable_build_cache  # noqa: E402
from triplegan_tpu_torch.utils.debug import NonFiniteError, checkify_step  # noqa: E402
from triplegan_tpu_torch.utils.profiling import step_timer, trace  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    save_config(tiny_config(), path)
    cfg = port_base.merge_saved(port_base.base_config(), path)
    nets, opts = port_base.make_networks(cfg), make_optimizers(cfg, 16)
    state = create_state(cfg, nets, opts, device="cpu")
    data = synthetic_dataset(cfg.image_size, cfg.channels, 10, n_train=64, n_test=16, num_labeled=20)
    batch = BatchSampler(data, cfg.batch_size, seed=0).next_triple(cfg.z_dim, cfg.num_classes)
    return cfg, nets, opts, state, batch


def _tensors(batch):
    return {k: {kk: torch.as_tensor(v) for kk, v in s.items()} for k, s in batch.items()}


def test_checkify_clean_step_passes_and_changes_nothing(tiny):
    cfg, nets, opts, state, batch = tiny
    step = make_train_step(cfg, nets, opts, 16)
    want_state, want = step(state, _tensors(batch))
    got_state, got = checkify_step(step)(state, _tensors(batch))
    assert got_state.step == want_state.step == 1
    for k in want:
        assert np.isfinite(float(got[k])) and torch.equal(got[k], want[k]), k
    for p in want_state.params:
        for layer, arrays in want_state.params[p].items():
            for name, t in arrays.items():
                assert torch.equal(got_state.params[p][layer][name], t), (p, layer, name)


def test_checkify_catches_poisoned_input(tiny):
    cfg, nets, opts, state, batch = tiny
    poisoned = {k: dict(v) for k, v in batch.items()}
    poisoned["d"]["z"] = np.full_like(batch["d"]["z"], np.nan)
    step = checkify_step(make_train_step(cfg, nets, opts, 16))
    with pytest.raises(NonFiniteError, match=r"NaN or Inf in the output of aten\.\S+ \(operator \d+ of \d+ "
                                             r"checked\), issued at .*nn/networks\.py:\d+"):
        step(state, _tensors(poisoned))


def test_checkify_catches_a_nan_that_first_appears_in_a_gradient():
    """sqrt is finite at 0, its derivative is not: the forward is clean and
    the first Inf is the backward's."""
    def step(state, batch):
        x = batch.clone().requires_grad_(True)
        y = (x.sqrt() * 2.0).sum()
        g, = torch.autograd.grad(y, x)
        return state, {"g": g.sum()}

    batch = torch.tensor([0.0, 1.0, 4.0])
    _, m = checkify_step(step)(None, batch + 1.0)
    assert float(m["g"]) > 0
    with pytest.raises(NonFiniteError, match=r"aten\.\S+ \(operator \d+ of \d+ checked, in the backward of "
                                             r"SqrtBackward0\), issued at .*test_torch_utils\.py:\d+ in step; "
                                             r"its forward at .*test_torch_utils\.py:\d+ in step"):
        checkify_step(step)(None, batch)


def test_checkify_names_the_first_failure_when_the_step_raises():
    def step(state, batch):
        y = batch.log()  # -inf at 0
        raise RuntimeError("a step that gives up after a non-finite value")

    with pytest.raises(NonFiniteError, match=r"aten\.log\.default") as e:
        checkify_step(step)(None, torch.tensor([0.0, 1.0]))
    assert isinstance(e.value.__cause__, RuntimeError)


def test_checkify_refuses_a_scan_chunk(tiny):
    cfg, nets, opts, _, _ = tiny
    chunk = make_scan_device_train_step(cfg, nets, opts, 16, 2, log=lambda *a, **k: None)
    with pytest.raises(TypeError, match="cannot check a ScanChunk: its steps replay as one CUDA graph"):
        checkify_step(chunk)


_CPP = 'extern "C" int answer() { return 42; }\n'


def test_enable_build_cache_resolution_order(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", None)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    src = tmp_path / "answer.cpp"
    src.write_text(_CPP)
    flags = ["g++", "-O1", "-shared", "-fPIC"]

    # 1. the path given, read by build_shared at call time
    chosen = enable_build_cache(str(tmp_path / "given"))
    assert chosen == str(tmp_path / "given") == build.build_dir()
    out = build.build_shared(str(src), "libanswer", flags)
    assert os.path.dirname(out) == chosen and os.path.exists(out)
    # 2. else the package's own _build/ where it can be written (a checkout)
    assert enable_build_cache() == build.PKG_BUILD_DIR == build.resolve_build_dir()
    # 3. else the user's cache: a read-only install simulated (as root every
    #    path is writable, so access() is told otherwise for the package)
    real_access = os.access
    pkg = os.path.dirname(build.PKG_BUILD_DIR)

    def access(path, mode):
        return False if str(path).startswith(pkg) else real_access(path, mode)

    monkeypatch.setattr(build.os, "access", access)
    home_cache = str(tmp_path / "home" / ".cache" / "triplegan_tpu_torch_build")
    assert enable_build_cache() == home_cache
    out = build.build_shared(str(src), "libanswer", flags)
    assert os.path.dirname(out) == home_cache and os.path.exists(out)
    assert not build._writable(build.PKG_BUILD_DIR)


def test_trace_writes_a_chrome_trace_and_step_timer_times(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "tb")) as path:
        (a @ a).sum()
    assert os.path.dirname(path) == str(tmp_path / "tb")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    result = {}
    with step_timer(result, "t"):
        (a @ a).sum()
    assert result["t"] > 0
