"""The ``cifar10_stylegan2`` configuration and its cell's readers: the
configuration file against the program's registry entry, uncut; the
benchmark's spec naming the cell and its metrics; the kind's first step,
which carries D's R1 update; the step's work (``work_stylegan2.py``)
against a count by hand at a tiny size, and its epilogue and modulation
calls against the calls a tiny step makes; the ``d_reg_ms`` reader on
synthetic traces; and the cell end to end on the CPU at a tiny size (the
look for a card skipped): sound runs come out correct, and each of the
planted faults (``calibrate_stylegan2.py``: R1 dropped, demodulation
skipped, the noise term left out, the stddev groups across the streams)
comes out not correct."""

import collections
import copy
import json
import os
import shutil
import types

import pytest

from tiny import BENCH, REPO, write  # first: it puts the benchmark's folder on sys.path
import calibrate_stylegan2
import harness
import program
import run
import traced
import work
import work_stylegan2

SEED = 2_147_483_659  # more than 32 signed bits hold
CELL = "cifar10_stylegan2.train"
METRICS = ("step_mfu.train_stylegan2", "conv_roofline.train_stylegan2", "modulation_roofline.train_stylegan2",
           "d_reg_ms.train_stylegan2", "epilogue_roofline.train_stylegan2")


def _conf():
    with open(os.path.join(BENCH, "configs", "cifar10_stylegan2.json")) as f:
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
    assert conf["config"]["gen"]["widths"] == [512] * 4 and conf["config"]["disc"]["widths"] == [512] * 4
    assert conf["config"]["batch_size"] == 64 and conf["config"]["disc"]["mbstd_group"] == 32


def test_the_spec_names_the_cell_its_configuration_and_metrics():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = {c["name"]: c for c in bench["configs"]}["cifar10_stylegan2"]
    assert entry["reduced"] == [] and entry["file"] == "benchmark/configs/cifar10_stylegan2.json"
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("cifar10_stylegan2", "train_stylegan2", 1)
    loaded = harness.load_cell(REPO, CELL)
    assert [m["name"] for m in loaded.end_to_end] == ["train_img_s", "setup_s"]
    names = {m["name"] for m in loaded.per_layer}
    assert set(METRICS) <= names
    assert {"d_grad_ms.train", "g_grad_ms.train", "c_grad_ms.train", "adam_ms.train", "call_host_ms.train",
            "call_self_ms.train", "device_idle.train"} <= names
    assert not names & {"step_mfu.train", "conv_roofline.train", "epilogue_roofline.train"}


def test_the_kinds_first_step_carries_r1():
    k = harness.load_module(os.path.join(BENCH, "kinds", "train_stylegan2.py"), "kind_sg2_test")
    cell = types.SimpleNamespace(sizes={"r1_interval": 16})
    k._make_inputs = lambda cell, seed, dev: types.SimpleNamespace(start=156_200)
    ins = k.make_inputs(cell, 0, "cpu")
    assert ins.start == 156_208 and ins.start % 16 == 0
    sz = _conf()["config"]
    assert sz["alpha_p_warmup_epochs"] * (50_000 // sz["batch_size"]) == 156_200


TINY_G = {"widths": [16, 16, 8], "kernel": 3, "w_dim": 8, "map_layers": 2, "map_lr_mult": 0.01, "w_avg_beta": 0.995,
          "conv_clamp": 256.0, "noise_init": 0.1, "ema_kimg": 500.0, "ema_rampup": 0.05}
TINY_D = {**_conf()["config"]["disc"], "widths": [8, 16, 16], "cmap_dim": 8, "map_layers": 2, "mbstd_group": 4}


def test_the_steps_work_is_the_count_by_hand():
    sz = {**_conf()["config"], "image_size": 16, "z_dim": 8, "gen": TINY_G, "disc": TINY_D,
          "clf": {"conv_blocks": [[6, 6], [8]], "tail": [8, 6], "input_noise": 0.15, "block_dropout": 0.5},
          "batch_size": 8}
    mm = lambda i, o: 2 * i * o  # noqa: E731
    conv = lambda h, cin, cout, k: 2 * h * h * cin * cout * k * k  # noqa: E731
    # G an image: embed, map0 (8 + 8 → 8), map1, 8 affines (w → each layer's input channels: 16 but for
    # b16_conv1's and b16_torgb's 8), convs at 4 (conv1), 8 and 16 (a transposed conv from the half size,
    # conv1), 3 ToRGBs
    g_dense = mm(10, 8) + mm(16, 8) + mm(8, 8) + mm(8, 16) * 6 + mm(8, 8) * 2
    g_conv = conv(4, 16, 16, 3) + 2 * 4 * 4 * 16 * 16 * 9 + conv(8, 16, 16, 3) + 2 * 8 * 8 * 16 * 8 * 9 \
        + conv(16, 8, 8, 3) + conv(4, 16, 3, 1) + conv(8, 16, 3, 1) + conv(16, 8, 3, 1)
    g = g_dense + g_conv
    # D an image: fromRGB at 16, blocks at 16 and 8 (a 3×3 conv, a stride-2 one), the 4×4 conv of 17 channels,
    # two dense layers; cmap: embed and 2 layers
    d = conv(16, 3, 8, 1) + conv(16, 8, 8, 3) + conv(8, 8, 16, 3) + conv(8, 16, 16, 3) + conv(4, 16, 16, 3) \
        + conv(4, 17, 16, 3) + mm(256, 16) + mm(16, 8)
    cm = mm(10, 8) + 2 * mm(8, 8)
    d_first, g_first, cm_first = conv(16, 3, 8, 1), mm(10, 8), mm(10, 8)
    b = 8
    gen = b * g * (3 + 2) - b * g_first                              # 3 forwards, G's backward less embed's dgrad
    disc = 3 * b * (3 * d - d_first) + b * 2 * d + b * d             # D's update, G's (its dgrad), C's forward
    cmap = 3 * b * (3 * cm - cm_first) + b * cm + b * cm             # a backward in D's update alone
    r1 = (b * 4 * d + b * (3 * cm - cm_first)) / 16                  # D fwd, dgrad, then a fwd and a wgrad a layer
    clf = sum(c.flops() for c in work.step_calls(sz) if c.layer in work.networks(sz)["clf"])
    zca = 2 * (7 * b + b) * 768 * 768
    assert work_stylegan2.step_flops(sz) == pytest.approx(gen + disc + cmap + r1 + clf + zca, rel=1e-12)
    fwd, bwd = work_stylegan2.modulation_calls(sz)
    # a G pass: at 4 conv1's epilogue and input scale, ToRGB's input scale; at 8 and 16 conv0's besides
    assert len(fwd) == 3 * 13 and len(bwd) == 13 and max(fwd) == b * 16 * 16 * 8


def test_the_published_steps_work():
    sz = _conf()["config"]
    g = [l for l in work_stylegan2.networks(sz)["gen"] if l.kind != "dense" and l.k == 3]
    assert round(sum(work.Call(l, "fwd", 1).flops() for l in g) / 1e9, 2) == 8.0
    assert 9.4e12 < work_stylegan2.step_flops(sz) < 10.2e12


def _trace(recs):
    lead = [(i, i + 1, "void spin_kernel(long)") for i in range(3)]
    tail = [(10 ** 6 + i, 10 ** 6 + i + 1, "void spin_kernel(long)") for i in range(3)]
    return traced.from_records(lead + recs + tail, [])


def _steps(n, interval=4, drop=None):
    """``n`` steps from t = 100, the first of every ``interval`` opening
    with the d_reg mark (1 ns) and 50 ns of R1; then the d_grad mark, 200
    ns of D's update, the g_grad mark; ``drop`` names a (step, mark) left
    out."""
    recs, t = [], 100
    for i in range(n):
        marks = (("tg_phase_d_reg", 50),) if i % interval == 0 else ()
        for mark, work_ns in marks + (("tg_phase_d_grad", 200), ("tg_phase_g_grad", 10)):
            if (i, mark) != drop:
                recs.append((t, t + 1, mark))
            recs.append((t + 1, t + 1 + work_ns, f"kernel_after_{mark}"))
            t += 2 + work_ns
    return recs


def _d_reg_ms(trace, steps, interval=4):
    cell = harness.load_cell(REPO, CELL)
    ctx = {"kind": "train", "trace": trace, "trace_steps": steps, "sizes": {"arch": "stylegan2",
                                                                            "r1_interval": interval}}
    return harness.reader(cell, "d_reg_ms.train_stylegan2")(ctx)


def test_the_d_reg_reader_reads_from_each_d_reg_mark_to_the_next_d_grad_mark():
    assert _d_reg_ms(_trace(_steps(8)), 8) == pytest.approx(2 * 51 / 8 / 1e6)
    assert _d_reg_ms(_trace([(100, 200, "kernel"), (200, 201, "tg_phase_d_grad")]), 4) is None
    assert _d_reg_ms(None, 4) is None


@pytest.mark.parametrize("recs, steps, match", [
    (_steps(8), 12, "2 tg_phase_d_reg marks for 12 steps"),
    (_steps(8, drop=(4, "tg_phase_d_reg")), 8, "1 tg_phase_d_reg marks for 8 steps"),
    (_steps(5)[:-4], 8, "not followed by a tg_phase_d_grad mark"),
], ids=["more steps than the marks' interval", "a d_reg mark missing", "the window ends after a d_reg mark"])
def test_the_d_reg_reader_raises_on_a_wrong_mark_count(recs, steps, match):
    with pytest.raises(RuntimeError, match=match):
        _d_reg_ms(_trace(recs), steps)


TINY = {**_conf()["config"], "image_size": 16, "z_dim": 8, "num_labeled": 40, "alpha_p_warmup_epochs": 2,
        "gen": TINY_G, "disc": TINY_D,
        "clf": {"conv_blocks": [[6, 6], [8]], "tail": [8, 6], "input_noise": 0.15, "block_dropout": 0.5},
        "batch_size": 8, "epochs": 10}
LIMITS = {"loss_d_step1": 1e-5, "loss": 1e-4, "adam_mu": 1e-3, "change": 1e-2, "flipped_disc": 1e-3}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout holding a tiny cell of the StyleGAN2 configuration."""
    root = str(tmp_path_factory.mktemp("sg2root"))
    b = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(b, "metrics"))
    conf = dict(_conf(), name="tiny_sg2", config=TINY, data={"n_train": 600, "n_labeled": 40})
    write(os.path.join(b, "configs", "tiny_sg2.json"), conf)
    write(os.path.join(b, "traffic", "tiny_sg2.json"), {"kind": "train_stylegan2", "scan_steps": 2, "trace_calls": 1,
                                                       "host_calls": 1})
    write(os.path.join(b, "limits", "tiny_sg2.train.json"), {"limits": LIMITS})
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny_sg2", "source": "test", "file": "benchmark/configs/tiny_sg2.json",
                         "reduced": [], "why": "tiny"}]
    bench["workloads"] = [{"name": "tiny_sg2.train", "config": "tiny_sg2", "traffic": "tiny_sg2", "chips": 1,
                           "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny_sg2.train"] if CELL in m["workloads"] else []
    write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def test_a_sound_tiny_run_comes_out_correct(root):
    line, checks, out = run.run_cell(root, "tiny_sg2.train", SEED, 0.5, False, "cpu")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_img_s", "setup_s"} and checks
    assert out.notes["steps"] >= 2


@pytest.mark.parametrize("fault", sorted(calibrate_stylegan2.FAULTS))
def test_a_planted_fault_comes_out_not_correct(root, fault):
    with calibrate_stylegan2.FAULTS[fault]():
        line, _, _ = run.run_cell(root, "tiny_sg2.train", SEED, 0.5, False, "cpu")
    assert not line["correct"], (fault, line["checks"])


def test_the_cells_readers_read_nothing_in_a_cell_of_other_networks():
    ctx = {"kind": "train", "sizes": {"compute_dtype": "float32"}, "trace": None, "trace_steps": 4,
           "steps": 4, "window_s": 1.0, "device_kind": "NVIDIA H100"}
    cell = types.SimpleNamespace(folder=lambda *p: os.path.join(BENCH, *p))
    for name in METRICS:
        assert harness.reader(cell, name)(copy.deepcopy(ctx)) is None, name


# the plain twins a kernel's call runs on the CPU, by the tally they count in
TWINS = {"reference_scale_bias_act": "epilogue_fwd", "reference_scale_bias_act_bwd": "epilogue_bwd",
         "reference_scale_bias_act_cond": "modulation_fwd", "reference_scale_bias_act_cond_bwd": "modulation_bwd",
         "reference_scale_bias_act_noise": "modulation_fwd", "reference_scale_bias_act_noise_bwd": "modulation_bwd"}


def test_the_epilogue_and_modulation_calls_are_those_a_tiny_step_makes(root, monkeypatch):
    """One step carrying R1 and one without, eager on the CPU with the
    kernels' wrappers (which call the plain twins here): the elements of
    each call, by tally, against ``work_stylegan2``'s lists."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data.datasets import synthetic_dataset
    from triplegan_tpu_torch.data.zca import fit_zca
    from triplegan_tpu_torch.ops import scale_bias_act as sba
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    tally = collections.defaultdict(collections.Counter)
    for name, what in TWINS.items():
        def counted(*a, _orig=getattr(sba, name), _what=what, **kw):
            tally[_what][a[0].numel()] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(sba, name, counted)
    torch.manual_seed(0)
    cfg = program.config(harness.load_cell(root, "tiny_sg2.train"))
    assert cfg.use_pallas and cfg.r1_interval == 16
    data = synthetic_dataset(16, 3, 10, n_train=64, n_test=8, num_labeled=16, seed=0)
    nets, opts = make_networks(cfg), make_optimizers(cfg, 100)
    step = S.make_device_train_step(cfg, nets, opts, 100, zca_stats=fit_zca(data.x_unlabel) if cfg.zca else None)
    state, dev_data = create_state(cfg, nets, opts, device="cpu", seed=3), S.upload_device_data(data, "cpu")
    per_step = []
    for _ in range(2):  # step 0 carries R1, step 1 does not
        tally.clear()
        state, _ = step(state, dev_data)
        per_step.append({k: collections.Counter(v) for k, v in tally.items()})
    r1, plain = per_step
    sz = TINY
    fwd, bwd = work_stylegan2.epilogue_calls(sz)
    assert (plain["epilogue_fwd"], plain["epilogue_bwd"]) == (collections.Counter(fwd), collections.Counter(bwd))
    r1_fwd, r1_bwd = work_stylegan2.r1_epilogue_calls(sz)
    assert (r1["epilogue_fwd"] - plain["epilogue_fwd"], r1["epilogue_bwd"] - plain["epilogue_bwd"]) == (
        collections.Counter(r1_fwd), collections.Counter(r1_bwd))
    fwd, bwd = work_stylegan2.modulation_calls(sz)
    for counts in (plain, r1):
        assert (counts["modulation_fwd"], counts["modulation_bwd"]) == (collections.Counter(fwd),
                                                                        collections.Counter(bwd))
