"""The port's digits campaign (``triplegan_tpu_torch/tools/``) and its data
(``data/prepare.py::prepare_digits``, from the package's own copy of the
digits file) against the JAX package's, on the CPU.

* the packaged file is scikit-learn's, byte for byte, and reads to the
  same arrays; the shards equal the JAX package's bitwise with
  scikit-learn blocked on the port's side; the labelled subset of each
  seed 1-10 is the JAX package's (so both packages' arms see the same
  labels);
* each statistic equals the JAX tool's function on the same inputs
  exactly (the sign test through ``tools/flagset_ab.py::run_ab``'s summary,
  where the JAX tools compute it inline);
* the supervised arm's loss and gradients on bridged weights (noise and
  dropout off) equal the JAX Classifier's within 1e-5 relative (the JAX
  side's batch-norm moments summed blocked: ``_BlockMeanJnp``), and its
  Adam update the optax update of the same gradients;
* the tools' ``--dry-run`` commands equal the JAX tools' but for the CLI
  module, ``--device`` and ``scan_steps``; the argument checks mirror
  ``tests/test_digits.py``'s;
* one tiny end-to-end run on the CPU: ``digits_experiment`` (seed 1, 20
  labels, 1 epoch, 3 baseline steps), ``digits_quality`` on its run,
  ``parity`` and ``flagset_ab --reuse-a`` on what it wrote.
"""

import hashlib
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from triplegan_tpu.data import datasets as jax_datasets  # noqa: E402
from triplegan_tpu.data import prepare as jax_prepare  # noqa: E402
from triplegan_tpu_torch.data import datasets, prepare  # noqa: E402
from triplegan_tpu_torch.tools import (campaign, digits_experiment, digits_quality, flagset_ab,  # noqa: E402
                                       parity, seed_campaign, stats)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(the port's data dir, the JAX package's): each package's digits
    shards, the port's written with scikit-learn unimportable."""
    pytest.importorskip("sklearn")
    root = tmp_path_factory.mktemp("digits")
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k == "sklearn" or k.startswith("sklearn.")}
    sys.modules["sklearn"] = None  # an import of it raises ImportError
    try:
        prepare.prepare("digits", "", str(root / "port"))
    finally:
        del sys.modules["sklearn"]
        sys.modules.update(saved)
    jax_prepare.prepare("digits", "", str(root / "jax"))
    return str(root / "port"), str(root / "jax")


def test_the_packaged_digits_file_is_scikit_learns():
    sklearn_datasets = pytest.importorskip("sklearn.datasets")
    theirs = os.path.join(os.path.dirname(sklearn_datasets.__file__), "data", "digits.csv.gz")
    with open(theirs, "rb") as a, open(prepare.DIGITS_FILE, "rb") as b:
        assert hashlib.sha256(a.read()).hexdigest() == hashlib.sha256(b.read()).hexdigest() == prepare.DIGITS_SHA256
    images, target = prepare.load_digits_file()
    d = sklearn_datasets.load_digits()
    assert images.dtype == d.images.dtype and np.array_equal(images, d.images)
    assert np.array_equal(target, d.target)


def test_a_damaged_digits_file_is_refused(tmp_path):
    raw = bytearray(open(prepare.DIGITS_FILE, "rb").read())
    raw[-1] ^= 1
    bad = tmp_path / "digits.csv.gz"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="sha256"):
        prepare.load_digits_file(str(bad))


def test_digits_shards_equal_the_jax_packages_bitwise_without_scikit_learn(shards):
    port, jax_dir = shards
    for split in ("train", "test"):
        got = _arrays(os.path.join(port, "digits", f"{split}.npz"))
        want = _arrays(os.path.join(jax_dir, "digits", f"{split}.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), (split, k)
    assert _arrays(os.path.join(port, "digits", "train.npz"))["images"].shape == (1297, 28, 28, 1)


def test_cli_prepare_digits_runs_without_scikit_learn(tmp_path):
    """``cli prepare --dataset digits`` in a fresh interpreter where an
    import of scikit-learn fails."""
    import subprocess

    code = ("import sys; sys.modules['sklearn'] = None\n"
            "from triplegan_tpu_torch.cli import main\n"
            f"main(['prepare', '--dataset', 'digits', '--data-dir', {str(tmp_path)!r}])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "prepared digits" in out.stdout
    assert _arrays(str(tmp_path / "digits" / "test.npz"))["labels"].shape == (500,)


def test_each_seeds_labelled_subset_is_the_jax_packages(shards):
    port, _ = shards
    for seed in range(1, 11):
        got = datasets.load_dataset(port, "digits", 100, 10, seed)
        want = jax_datasets.load_dataset(port, "digits", 100, 10, seed)
        assert np.array_equal(got.x_label, want.x_label) and np.array_equal(got.y_label, want.y_label), seed
        assert np.bincount(got.y_label).tolist() == [10] * 10


# --- statistics ---------------------------------------------------------------------------


def _samples(seed, n, shift=0.0):
    return list(np.round(np.random.RandomState(seed).normal(6.0 + shift, 1.5, n), 1))


@pytest.mark.parametrize("case", [([1.0, 2.0, 3.0], [0.0, 0.0, 0.0]), ([1.0, 2.0], [1.0, 2.0]), ([], []),
                                  ([3.0, 1.0, 2.0, 5.0], [2.5, 1.5, 1.0, 4.0]),
                                  (_samples(0, 10), _samples(1, 10))])
def test_paired_permutation_p_is_the_jax_tools(case):
    a, b = case
    assert stats.paired_permutation_p(a, b) == _tool("digits_experiment").paired_permutation_p(a, b)


@pytest.mark.parametrize("shift", [0.0, 1.0, 4.0])
def test_two_sample_tests_are_the_jax_tools(shift):
    tf = _tool("tf_parity_train")
    a, b = _samples(2, 10, shift), _samples(3, 20)
    assert stats.two_sample_perm_p(a, b) == tf.two_sample_perm_p(a, b)
    assert stats.equivalence_analysis(a, b) == tf.equivalence_analysis(a, b)
    assert stats.equivalence_analysis(a, b, margin_pct=0.5, seed=3) == tf.equivalence_analysis(
        a, b, margin_pct=0.5, seed=3)


@pytest.mark.parametrize("errors", [(_samples(4, 10), _samples(5, 10)), ([5.0] * 6, [5.0, 6.0, 4.0, 5.0, 7.0, 3.0]),
                                    (_samples(6, 8, 2.0), _samples(7, 8))])
def test_sign_test_is_the_jax_tools(tmp_path, errors):
    """The JAX tools compute the sign test inline: run ``run_ab`` with a
    runner that writes each arm's train log with its error, and compare
    with its summary's (rounded) p."""
    a, b = errors
    fab = _tool("flagset_ab")
    seeds = list(range(1, len(a) + 1))

    def runner(args, log_path=None, extra_env=None):
        if log_path:
            seed = int(next(t for t in args if t.startswith("seed=")).split("=")[1])
            err = (a if log_path.endswith("_a_train.log") else b)[seed - 1]
            with open(log_path, "w") as f:
                f.write(f"done: step=12 test_error={err:.2f}%\n")
        return ""

    path = str(tmp_path / "ab.json")
    fab.run_ab(workdir=str(tmp_path), data_dir=str(tmp_path), config="mnist100", dataset="synthetic",
               num_labeled=100, seeds=seeds, epochs=1, warmup_epochs=1,
               arms={"a": {"sets": []}, "b": {"sets": ["compute_dtype=bfloat16"]}}, artifact_path=path,
               runner=runner)
    with open(path) as f:
        got = json.load(f)
    a_f, b_f = [x / 100 for x in a], [x / 100 for x in b]
    assert round(stats.sign_test_p(a_f, b_f), 4) == got["sign_test_p"]
    assert round(stats.paired_permutation_p(a_f, b_f), 4) == got["perm_test_p"]


# --- the supervised arm against the JAX tool's -------------------------------------------


class _BlockMeanJnp:
    """``jax.numpy`` with one change: a mean over every axis but the last
    (the batch-norm moments) sums float32 in two levels, blocks of 256 and
    then their partial sums, as accurate as the port's. XLA:CPU sums the
    15,680 terms of a digits batch-norm moment (20 × 28 × 28) one after
    another: 6e-5 relative error against float64, where torch's sum has
    1.6e-7. That error moves the normalized values across leaky-ReLU kinks
    and the conv gradients below them by up to 2.5% of their largest;
    with the blocked mean the two packages agree within 7.3e-6 (measured on
    four initial weights)."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def mean(self, x, axis=None, **kwargs):
        axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        if axes != tuple(range(x.ndim - 1)):
            return self._jnp.mean(x, axis=axis, **kwargs)
        flat = x.reshape(-1, x.shape[-1])
        pad = (-flat.shape[0]) % 256
        blocks = self._jnp.concatenate([flat, self._jnp.zeros((pad, flat.shape[1]), flat.dtype)])
        return blocks.reshape(-1, 256, flat.shape[1]).sum(axis=1).sum(axis=0) / flat.shape[0]


def _assert_update(new, before, update, what):
    """``new`` is ``before`` moved by ``update`` within 1e-5 of the largest
    |update| plus the final float32 rounding of the sum (half an ulp of
    the parameter)."""
    want = before.double() + update.double()
    tol = 1e-5 * float(update.abs().max()) + 2.0**-24 * before.double().abs()
    assert bool(((new.double() - want).abs() <= tol).all()), what


@pytest.mark.parametrize("use_pallas", [False, True])
def test_supervised_arm_loss_grads_and_adam_update_match_jax(shards, monkeypatch, use_pallas):
    """mnist100's Classifier at its widths on 20 labelled digits, noise and
    dropout off, weights bridged from the JAX init. Both arms: the loss
    within 1e-5 relative of the JAX tool's (optax cross-entropy); the
    port's Adam on the JAX gradients equal to optax's update within 1e-5
    relative; the arm's own step the loss and Adam's first update of its
    own gradients. The plain arm also: every gradient within 1e-5 of its
    largest magnitude, the JAX side's batch-norm moments summed blocked
    (``_BlockMeanJnp``), and so its first update optax's wherever the
    gradient's sign is resolved. The kernel arm's
    twins round otherwise, and at these widths on these images one of its
    pre-activations lies within that rounding of a leaky-ReLU kink (b0c0's
    gradient then moves by 3.2% of its largest): its gradients are held to
    JAX's at a few channels (``tests/test_torch_networks_train.py``)."""
    import jax.numpy as jnp
    import optax

    from triplegan_tpu.configs import get_config as jax_get_config
    from triplegan_tpu.configs.base import make_networks as jax_make_networks
    from triplegan_tpu.nn import layers as jax_layers
    from triplegan_tpu_torch import bridge
    from triplegan_tpu_torch.train.schedule import Adam

    port_dir, _ = shards
    data = datasets.load_dataset(port_dir, "digits", 20, 10, seed=1)
    jcfg = jax_get_config("mnist100")
    jcfg.clf.input_noise, jcfg.clf.block_dropout = 0.0, 0.0
    _, _, jclf = jax_make_networks(jcfg)
    params, bn = jclf.init(jax.random.PRNGKey(3))
    x = jnp.asarray(data.x_label.astype(np.float32) / 127.5 - 1.0)
    y = jnp.asarray(data.y_label)

    def loss_fn(p):
        logits, new_bn = jclf.apply(p, bn, x, train=True, rng=jax.random.PRNGKey(0))
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), new_bn

    j_loss_plain = float(loss_fn(params)[0])
    monkeypatch.setattr(jax_layers, "jnp", _BlockMeanJnp(jnp))
    (j_loss, j_bn), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    opt = optax.adam(3e-4, b1=jcfg.adam_b1, b2=jcfg.adam_b2, eps=jcfg.adam_eps)
    updates, _ = opt.update(j_grads, opt.init(params), params)

    pcfg = digits_experiment.baseline_config(port_dir, 1, 20)
    pcfg.clf.input_noise, pcfg.clf.block_dropout = 0.0, 0.0
    pcfg.use_pallas = use_pallas
    p_params, p_bn = bridge.nested(bridge.from_jax({"clf": params}, {"clf": bn})["clf"])
    run = digits_experiment.SupervisedBaseline(pcfg, data.x_label, data.y_label, "cpu", params=p_params, bn=p_bn)
    loss, grads, new_bn = run.loss_and_grads()
    for want in (j_loss_plain, float(j_loss)):
        assert abs(float(loss) - want) <= 1e-5 * abs(want)

    def port_tree(tree):
        return bridge.nested(bridge.from_jax({"clf": tree}, {})["clf"])[0]

    want_grads, want_upd = port_tree(j_grads), port_tree(updates)
    want_bn = bridge.nested(bridge.from_jax({"clf": {}}, {"clf": j_bn})["clf"])[1]
    for layer, arrays in want_bn.items():
        for k, want in arrays.items():
            assert torch.allclose(new_bn[layer][k], want, rtol=1e-5, atol=1e-6), (layer, k)
    # the port's Adam on the JAX gradients: optax's update
    adam = Adam(lr=lambda c: 3e-4, b1=pcfg.adam_b1, b2=pcfg.adam_b2, eps=pcfg.adam_eps)
    new, _ = adam.update(run.params, want_grads, adam.init(run.params))
    for layer, arrays in want_upd.items():
        for k, upd in arrays.items():
            _assert_update(new[layer][k], run.params[layer][k], upd, ("optax", layer, k))
    # the arm's own step: the loss before it, Adam's first update of its own gradients
    before = {layer: {k: t.clone() for k, t in arrays.items()} for layer, arrays in run.params.items()}
    assert float(run.step()) == float(loss)
    for layer, arrays in grads.items():
        for k, g in arrays.items():
            g64 = g.double()
            _assert_update(run.params[layer][k], before[layer][k], -3e-4 * g64 / (g64.abs() + pcfg.adam_eps),
                           ("own step", layer, k))
    if use_pallas:
        return
    for layer, arrays in want_grads.items():
        for k, want in arrays.items():
            err = float((grads[layer][k] - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (layer, k, err)
            # Adam's first step is ±lr·g/(|g| + ε): its sign is decided only where
            # |g| is resolved (1e-3 of the largest, 100× the gradient tolerance);
            # elsewhere it is a step of at most lr either way
            resolved = want.abs() >= 1e-3 * want.abs().max()
            new_p, old_p = run.params[layer][k], before[layer][k]
            _assert_update(new_p[resolved], old_p[resolved], want_upd[layer][k][resolved],
                           ("first update", layer, k))
            step = (new_p.double() - old_p.double()).abs()
            assert bool((step <= 3e-4 * (1 + 1e-5) + 2.0**-24 * old_p.double().abs()).all()), (layer, k)


# --- the tools' commands and argument checks ----------------------------------------------


def test_supervised_step_runs_its_train_step_through_a_one_step_chunk():
    """The supervised arm's step is its ``train_step`` run as a one-step
    ``ScanChunk`` (a CUDA graph on the card, eager here): two steps of it
    equal two calls of the ``train_step`` from the same weights, bitwise,
    with noise and dropout drawn from ``_noise_seed(seed, step)``, and the
    state's tensors are updated in place."""
    from triplegan_tpu_torch.configs import get_config
    from triplegan_tpu_torch.train.step import _state_tensors

    cfg = get_config("mnist100")
    cfg.clf.conv_blocks, cfg.clf.tail, cfg.batch_size = ((4, 4), (8, 8)), (8, 8), 20
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (20, 28, 28, 1)).astype(np.uint8)
    y = np.arange(20) % 10
    chunked, eager = (digits_experiment.SupervisedBaseline(cfg, x, y, "cpu", noise_seed=7) for _ in range(2))
    assert chunked.train_step.seed_of(7, 3, 0) == digits_experiment._noise_seed(7, 3)
    tensors = list(_state_tensors(chunked.state))
    losses = [chunked.step() for _ in range(2)]
    want = []
    for _ in range(2):
        eager.state, m = eager.train_step(eager.state, eager.data)
        want.append(m["loss"])
    assert all(torch.equal(a, b) for a, b in zip(losses, want)) and not torch.equal(losses[0], losses[1])
    assert all(a is b for a, b in zip(_state_tensors(chunked.state), tensors))
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(chunked.state), _state_tensors(eager.state)))
    assert chunked.state.step == eager.state.step == 2 and chunked.state.opt["clf"].count == 2
    assert (chunked.chunk.captures, chunked.chunk.replays) == (0, 0)


def _port_to_jax_lines(out: str) -> list:
    """The port's dry-run lines with what the port adds taken out: the CLI
    module's name, ``--device X`` and ``--set scan_steps=K``."""
    lines = []
    for ln in out.splitlines():
        toks = ln.split(" ")
        keep = []
        i = 0
        while i < len(toks):
            if toks[i] == "--device" or (toks[i] == "--set" and toks[i + 1].startswith("scan_steps=")):
                i += 2
                continue
            keep.append("triplegan_tpu.cli" if toks[i] == campaign.CLI_MODULE else toks[i])
            i += 1
        lines.append(" ".join(keep))
    return lines


@pytest.mark.parametrize("tool,argv", [
    ("digits_experiment", ["--seeds", "1,2,3", "--num-labeled", "50", "--epochs", "20"]),
    ("seed_campaign", ["--seeds", "4,5", "--override", "compute_dtype=bfloat16"]),
    ("flagset_ab", ["--seeds", "1,2", "--name", "bf16", "--b-set", "compute_dtype=bfloat16",
                    "--eval-every-epochs", "100"]),
])
def test_dry_run_commands_are_the_jax_tools(tool, argv, tmp_path, capsys):
    common = ["--data-dir", str(tmp_path / "data"), "--workdir", str(tmp_path / "runs"), "--dry-run"]
    assert _tool(tool).main(common + argv) == 0
    want = capsys.readouterr().out.splitlines()
    port = {"digits_experiment": digits_experiment, "seed_campaign": seed_campaign, "flagset_ab": flagset_ab}[tool]
    assert port.main(common + argv) == 0
    out = capsys.readouterr().out
    assert "--device cuda" in out and f"--set scan_steps={campaign.SCAN_STEPS}" in out
    assert _port_to_jax_lines(out) == want
    assert port.main(common + argv + ["--device", "cpu", "--scan-steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "--device cuda" not in out and "--set scan_steps=6" in out


@pytest.mark.parametrize("tool,argv", [
    ("digits_experiment", ["--num-labeled", "55"]),
    ("digits_experiment", ["--seeds", "1,1"]),
    ("digits_experiment", ["--device", "tpu"]),
    ("seed_campaign", ["--seeds", "2,2"]),
    ("flagset_ab", ["--b-set", "compute_dtype=bfloat16", "--num-labeled", "55"]),
    ("flagset_ab", ["--b-set", "compute_dtype=bfloat16", "--seeds", "3,3"]),
    ("flagset_ab", []),  # the arms are identical
    ("flagset_ab", ["--b-set", "compute_dtype=bfloat16", "--reuse-a", "runs/digits_n100"]),  # no {seed}
])
def test_the_tools_refuse_bad_arguments(tool, argv, tmp_path):
    mod = {"digits_experiment": digits_experiment, "seed_campaign": seed_campaign, "flagset_ab": flagset_ab}[tool]
    with pytest.raises(SystemExit):
        mod.main(["--data-dir", str(tmp_path), "--workdir", str(tmp_path), "--dry-run", *argv])


def test_digits_quality_refuses_duplicate_runs_and_non_run_dirs(tmp_path):
    with pytest.raises(SystemExit):
        digits_quality.main(["--data-dir", str(tmp_path), "--workdir", str(tmp_path), "--runs", "a,a"])
    os.makedirs(tmp_path / "not_a_run")
    with pytest.raises(SystemExit, match="config.json"):
        digits_quality.main(["--data-dir", str(tmp_path), "--workdir", str(tmp_path), "--runs", "not_a_run",
                             "--device", "cpu"])


def test_nn_distances_matches_brute_force():
    rng = np.random.RandomState(0)
    a = rng.randn(7, 4, 4, 1).astype(np.float32)
    b = rng.randn(11, 4, 4, 1).astype(np.float32)
    got = digits_quality.nn_distances(a, b, chunk=3)
    want = np.sqrt(((a.reshape(7, 1, -1) - b.reshape(1, 11, -1)) ** 2).sum(-1)).min(axis=1)
    assert np.allclose(got, want, atol=1e-5)
    assert np.array_equal(got, _tool("digits_quality").nn_distances(a, b, chunk=3))


# --- parity's verdict ---------------------------------------------------------------------


def _write_summary(path, errors, baseline=None):
    s = {"num_labeled": 100, "seeds": list(range(1, len(errors) + 1)), "triplegan_errors_pct": errors}
    if baseline is not None:
        s["baseline_errors_pct"] = baseline
    with open(path, "w") as f:
        json.dump(s, f)


@pytest.mark.parametrize("shift,verdict", [(0.0, "AGREE"), (4.0, "DISAGREE")])
def test_parity_against_the_committed_jax_populations(tmp_path, shift, verdict):
    with open(os.path.join(REPO, "docs", "assets", "digits_summary_n100.json")) as f:
        jax_recipe = json.load(f)
    mine = [round(e + shift, 2) for e in jax_recipe["triplegan_errors_pct"]]
    _write_summary(tmp_path / "s.json", mine, jax_recipe["baseline_errors_pct"])
    assert parity.main(["--summary", str(tmp_path / "s.json")]) == 0
    with open(tmp_path / "torch_parity_digits_n100.json") as f:
        got = json.load(f)
    pool = got["comparisons"]["jax_pool"]
    assert got["verdict"] == pool["verdict"] == verdict
    assert pool["n_ref"] == 20 and got["margin_pct"] == 2.0
    tf = _tool("tf_parity_train")
    with open(os.path.join(REPO, "docs", "assets", "sharefwd_ab_digits_n100.json")) as f:
        ref = jax_recipe["triplegan_errors_pct"] + json.load(f)["off_errors_pct"]
    assert pool["perm_test_p"] == round(tf.two_sample_perm_p(mine, ref), 4)
    assert {k: pool[k] for k in ("mean_diff_pct", "diff_ci90_pct", "tost_equivalent")} == {
        k: v for k, v in tf.equivalence_analysis(mine, ref).items() if k != "equiv_margin_pct"}
    assert got["comparisons"]["baseline"]["verdict"] == "AGREE"  # the JAX arm against itself
    assert set(got["final_losses"]["jax_recipe"]) == {"loss_d", "loss_g", "c_sup"}


# --- one tiny run end to end on the CPU ---------------------------------------------------


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    # The CLI stages are subprocesses: one thread each, as this process has,
    # since the suite's other workers share the cores.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rc = digits_experiment.main([
            "--data-dir", str(root / "data"), "--workdir", str(root / "runs"), "--seeds", "1",
            "--num-labeled", "20", "--epochs", "1", "--warmup-epochs", "1", "--baseline-steps", "3",
            "--eval-every-epochs", "1", "--ckpt-every-epochs", "1", "--device", "cpu",
        ])
    return root, rc


def test_digits_experiment_end_to_end_on_the_cpu(tiny_run):
    root, rc = tiny_run
    assert rc in (0, 2)  # an untrained micro run promises no gain: the artifact and its honest verdict
    with open(root / "runs" / "digits_summary_n20.json") as f:
        s = json.load(f)
    assert s["seeds"] == [1] and s["num_labeled"] == 20 and s["device"] == "cpu"
    assert len(s["baseline_errors_pct"]) == len(s["triplegan_errors_pct"]) == 1
    assert (s["verdict"] == "PASS") == (s["gain_pct"] > 0) and s["seed_wins"].endswith("/1")
    # cli eval reproduced the error that train logged last
    assert s["timing"][0]["train_log_final_error_pct"] == s["triplegan_errors_pct"][0]
    assert s["timing"][0]["windows"] == 1 and s["timing"][0]["ms_per_step_median"] > 0
    assert all(np.isfinite(v) for v in s["final_metrics"][0].values())
    with open(root / "runs" / "digits_n20_s1" / "config.json") as f:
        assert json.load(f)["scan_steps"] == campaign.SCAN_STEPS


def test_digits_quality_and_parity_on_the_tiny_run(tiny_run):
    root, _ = tiny_run
    runs = root / "runs"
    assert digits_quality.main(["--data-dir", str(root / "data"), "--workdir", str(runs), "--runs", "digits_n20_s1",
                                "--n-samples", "100", "--device", "cpu"]) == 0
    with open(runs / "digits_quality.json") as f:
        q = json.load(f)
    refs = q["references"]
    assert refs["fid_ceiling_noise_vs_test"] > refs["fid_floor_trainpool_vs_test"]
    (row,) = q["runs"]
    assert row["run"] == "digits_n20_s1" and row["is_anchor_self_judged"] is True
    assert row["fid_vs_test"] >= 0.0 and 0.0 <= row["cond_fidelity_anchor"] <= 1.0
    assert row["nn_gen_to_trainpool_mean"] > 0.0

    # the committed populations are of 100 labels: parity reads them under that name
    assets = runs / "assets"
    os.makedirs(assets)
    for name in ("digits_summary", "sharefwd_ab_digits", "bf16_ab_digits", "tf_parity_summary"):
        shutil.copy(os.path.join(REPO, "docs", "assets", f"{name}_n100.json"), assets / f"{name}_n20.json")
    assert parity.main(["--summary", str(runs / "digits_summary_n20.json"), "--runs-dir", str(runs),
                        "--assets", str(assets)]) == 0
    with open(runs / "torch_parity_digits_n20.json") as f:
        p = json.load(f)
    assert p["verdict"] == "DISAGREE"  # an untrained run is far from the trained populations
    assert p["curves"]["port_mean"] == [] and p["curves"]["tf_mean"][0]["step"] == 600


def test_flagset_reuses_a_matching_run_and_refuses_another(tiny_run, tmp_path):
    root, _ = tiny_run
    calls = []

    def runner(args, log_path=None, extra_env=None):
        calls.append(args)
        if log_path:
            with open(log_path, "w") as f:
                f.write("step 12/12 [100 img/s] loss_d=1.3000 c_sup=0.5000\ndone: step=12 test_error=50.00%\n")
        return ""

    kw = dict(data_dir=str(root / "data"), config="mnist100", dataset="digits", num_labeled=20, seeds=[1],
              epochs=1, warmup_epochs=1, eval_every_epochs=1, ckpt_every_epochs=1, device="cpu",
              reuse_a=str(root / "runs" / "digits_n20_s{seed}"), runner=runner)
    arms = {"a": {"sets": []}, "b": {"sets": ["compute_dtype=bfloat16"]}}
    assert flagset_ab.run_ab(workdir=str(tmp_path / "ab"), arms=arms, artifact_path=str(tmp_path / "ab.json"),
                             **kw) == 0
    with open(tmp_path / "ab.json") as f:
        s = json.load(f)
    assert s["a_reused_from"] == {"1": "digits_n20_s1"}
    with open(root / "runs" / "digits_summary_n20.json") as f:
        assert s["a_errors_pct"] == json.load(f)["triplegan_errors_pct"]
    assert s["b_errors_pct"] == [50.0]
    assert [c[0] for c in calls] == ["prepare", "train"]  # arm a was not trained again
    with pytest.raises(SystemExit, match="differs from arm a in"):
        flagset_ab.run_ab(workdir=str(tmp_path / "ab2"), arms={"a": {"sets": ["alpha_p=0.2"]}, "b": arms["b"]},
                          **kw)
