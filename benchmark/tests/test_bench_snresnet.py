"""The ``cifar10_snresnet`` configuration and its cell's readers: the
configuration file against the program's registry entry, uncut; the step's
work (``work_snresnet.py``) against a count by hand; the ``sn_ms`` reader
on synthetic traces; and the cell end to end on the CPU at a tiny size
(the look for a card skipped): sound runs come out correct, and each of
the planted faults (``calibrate_snresnet.py``: D's u never advanced, every
row given class 0's γ and β) comes out not correct."""

import copy
import json
import os
import shutil
import types

import pytest

from tiny import BENCH, REPO, write  # first: it puts the benchmark's folder on sys.path
import calibrate_snresnet
import harness
import run
import traced
import work
import work_snresnet

SEED = 2_147_483_659  # more than 32 signed bits hold


def _conf():
    with open(os.path.join(BENCH, "configs", "cifar10_snresnet.json")) as f:
        return json.load(f)


def test_the_configuration_file_is_the_registry_entry_uncut():
    from triplegan_tpu_torch.configs import get_config

    conf = _conf()
    cfg = json.loads(json.dumps(get_config(conf["registry"]), default=list))
    for key, value in conf["config"].items():
        if isinstance(value, dict):
            assert value == {k: cfg[key][k] for k in value}, key
        else:
            assert cfg[key] == value, key
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entry = {c["name"]: c for c in json.load(f)["configs"]}["cifar10_snresnet"]
    assert entry["reduced"] == [] and entry["file"] == "benchmark/configs/cifar10_snresnet.json"


def test_the_steps_work_is_the_count_by_hand():
    sz = _conf()["config"]
    conv = lambda n, h, cin, cout, k: 2 * n * h * h * cin * cout * k * k  # noqa: E731
    # G a image: l1, then per up-block c1 and c2 (3×3) and c_sc (1×1) at 8, 16, 32, then c5
    g = 2 * 128 * 4096 + sum(2 * conv(1, h, 256, 256, 3) + conv(1, h, 256, 256, 1) for h in (8, 16, 32)) \
        + conv(1, 32, 256, 3, 3)
    # D an image: the optimised block at 32 (its 1×1 on the pooled 16), block 2 at 16, blocks 3 and 4 at 8, l5
    d = conv(1, 32, 3, 128, 3) + conv(1, 32, 128, 128, 3) + conv(1, 16, 3, 128, 1) \
        + 2 * conv(1, 16, 128, 128, 3) + conv(1, 16, 128, 128, 1) + 4 * conv(1, 8, 128, 128, 3) + 2 * 128
    assert g == 3_362_258_944 and d == 544_145_664
    # D's first conv and shortcut take no input gradient in D's own update; G's l1 none in G's
    d_first = conv(1, 32, 3, 128, 3) + conv(1, 16, 3, 128, 1)
    gen = 100 * g * (3 + 2) - 100 * 2 * 128 * 4096               # 3 forwards, G's backward, less l1's dgrad
    disc = 500 * d + 300 * (2 * d - d_first) + 100 * d            # D's update's backward; G's update's dgrad
    clf = sum(c.flops() for c in work.step_calls(sz) if c.layer in work.networks(sz)["clf"])
    zca = 2 * (7 * 100 + 100) * 3072 * 3072
    assert work_snresnet.step_flops(sz) == gen + disc + clf + zca
    assert round(work_snresnet.step_flops(sz) / 1e12, 2) == 3.81
    fwd, bwd = work_snresnet.cbn_calls(sz)
    assert len(fwd) == 18 and len(bwd) == 6 and max(fwd) == 100 * 32 * 32 * 256


MARK = ("tg_phase_sn", "tg_phase_d_grad", "tg_phase_g_grad")


def _trace(recs):
    lead = [(i, i + 1, "void spin_kernel(long)") for i in range(3)]
    tail = [(10 ** 6 + i, 10 ** 6 + i + 1, "void spin_kernel(long)") for i in range(3)]
    return traced.from_records(lead + recs + tail, [])


def _steps(n, drop=None):
    """``n`` steps from t = 100: the sn mark (1 ns), 40 ns of power
    iterations, the d_grad mark, 200 ns of D's update, the g_grad mark;
    ``drop`` names a (step, mark) left out."""
    recs, t = [], 100
    for i in range(n):
        for mark, work_ns in zip(MARK, (40, 200, 10)):
            if (i, mark) != drop:
                recs.append((t, t + 1, mark))
            recs.append((t + 1, t + 1 + work_ns, f"kernel_after_{mark}"))
            t += 2 + work_ns
    return recs


def _sn_ms(trace, steps):
    cell = harness.load_cell(REPO, "cifar10_snresnet.train")
    return harness.reader(cell, "sn_ms.train_snresnet")({"kind": "train", "trace": trace, "trace_steps": steps})


def test_the_sn_reader_reads_from_each_sn_mark_to_the_next_d_grad_mark():
    assert _sn_ms(_trace(_steps(4)), 4) == pytest.approx(41 / 1e6)
    assert _sn_ms(_trace([(100, 200, "kernel"), (200, 201, "tg_phase_d_grad")]), 2) is None
    assert _sn_ms(None, 2) is None


@pytest.mark.parametrize("recs, steps, match", [
    (_steps(2, drop=(1, "tg_phase_d_grad")), 2, "not followed by a tg_phase_d_grad mark"),
    (_steps(2, drop=(0, "tg_phase_sn")), 2, "1 tg_phase_sn marks for 2 steps"),
    (_steps(2)[:-4], 2, "not followed"),
], ids=["a d_grad mark missing", "an sn mark missing", "the window ends after an sn mark"])
def test_the_sn_reader_raises_on_marks_it_cannot_pair(recs, steps, match):
    with pytest.raises(RuntimeError, match=match):
        _sn_ms(_trace(recs), steps)


TINY = {**_conf()["config"], "image_size": 16, "z_dim": 8, "num_labeled": 40, "alpha_p_warmup_epochs": 2,
        "gen": {"widths": [8, 8, 8], "kernel": 3},
        "disc": {**_conf()["config"]["disc"], "widths": [8, 8, 8, 8]},
        "clf": {"conv_blocks": [[6, 6], [8]], "tail": [8, 6], "input_noise": 0.15, "block_dropout": 0.5},
        "batch_size": 8, "epochs": 10}
LIMITS = {"loss_d_step1": 1e-5, "loss": 1e-4, "adam_mu": 1e-3, "change": 1e-2, "flipped_disc": 1e-3}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout holding a tiny cell of the SN-ResNet configuration."""
    root = str(tmp_path_factory.mktemp("snroot"))
    b = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(b, "metrics"))
    conf = dict(_conf(), name="tiny_sn", config=TINY, data={"n_train": 600, "n_labeled": 40})
    write(os.path.join(b, "configs", "tiny_sn.json"), conf)
    write(os.path.join(b, "traffic", "tiny_sn.json"), {"kind": "train_snresnet", "scan_steps": 2, "trace_calls": 1,
                                                      "host_calls": 1})
    write(os.path.join(b, "limits", "tiny_sn.train.json"), {"limits": LIMITS})
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny_sn", "source": "test", "file": "benchmark/configs/tiny_sn.json",
                         "reduced": [], "why": "tiny"}]
    bench["workloads"] = [{"name": "tiny_sn.train", "config": "tiny_sn", "traffic": "tiny_sn", "chips": 1,
                           "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny_sn.train"] if "cifar10_snresnet.train" in m["workloads"] else []
    write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def test_a_sound_tiny_run_comes_out_correct(root):
    line, checks, out = run.run_cell(root, "tiny_sn.train", SEED, 0.5, False, "cpu")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_img_s", "setup_s"} and checks


@pytest.mark.parametrize("fault", sorted(calibrate_snresnet.FAULTS))
def test_a_planted_fault_comes_out_not_correct(root, fault):
    with calibrate_snresnet.FAULTS[fault]():
        line, _, _ = run.run_cell(root, "tiny_sn.train", SEED, 0.5, False, "cpu")
    assert not line["correct"], (fault, line["checks"])


def test_the_cells_readers_read_nothing_in_a_cell_of_other_networks():
    ctx = {"kind": "train", "sizes": {"compute_dtype": "float32"}, "trace": None, "trace_steps": 4,
           "steps": 4, "window_s": 1.0, "device_kind": "NVIDIA H100"}
    cell = types.SimpleNamespace(folder=lambda *p: os.path.join(BENCH, *p))
    for name in ("step_mfu.train_snresnet", "conv_roofline.train_snresnet", "cbn_roofline.train_snresnet",
                 "sn_ms.train_snresnet"):
        assert harness.reader(cell, name)(copy.deepcopy(ctx)) is None, name
