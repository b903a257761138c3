"""Cells run end to end on the CPU at a tiny size, with the look for a card
skipped: a configuration, a mix, a limit file and a metric added as new
files are found by name; sound runs come out correct; a run whose timed
path is broken underneath comes out not correct."""

import json
import os

import pytest

import tiny  # first: it puts the benchmark's folder on sys.path
import harness
import run
import traced

SEED = 2_147_483_659  # more than 32 signed bits hold


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(str(tmp_path))


def test_files_added_alone_are_found_by_name(root):
    # a new per-layer metric with a data file beside it, and a new pattern file
    b = os.path.join(root, "benchmark")
    os.makedirs(os.path.join(b, "metrics", "steps_seen.train"))
    with open(os.path.join(b, "metrics", "steps_seen.train.py"), "w") as f:
        f.write("import os\n\ndef read(ctx):\n    here = os.path.join(os.path.dirname(__file__), 'steps_seen.train')\n"
                "    return ctx['steps'] * len(os.listdir(here))\n")
    with open(os.path.join(b, "metrics", "steps_seen.train", "one.txt"), "w") as f:
        f.write("x\n")
    with open(os.path.join(b, "metrics", "conv_roofline.train", "another.txt"), "w") as f:
        f.write("# a kernel that took some of the work\nmy_new_conv_kernel\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train step", "moves": "train_img_s",
                               "workloads": ["tiny.train"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = harness.load_cell(root, "tiny.train")
    assert cell.config["name"] == "tiny" and cell.traffic["scan_steps"] == 2 and cell.limits["loss"] == 1e-4
    assert "steps_seen.train" in [m["name"] for m in cell.per_layer]
    assert harness.reader(cell, "steps_seen.train")({"steps": 6}) == 6
    pats = traced.patterns(os.path.join(b, "metrics", "conv_roofline.train"))
    assert "my_new_conv_kernel" in pats and any("fwd_kernel" in p for p in pats)


def test_sound_runs_come_out_correct(root):
    line, checks, _ = run.run_cell(root, "tiny.train", SEED, 1.0, False, "cpu")
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}
    assert list(line)[-1] == "checks" and checks


def _frozen(monkeypatch):
    from triplegan_tpu_torch.train import step

    orig = step.ScanChunk._chunk
    monkeypatch.setattr(step.ScanChunk, "_chunk", lambda self, state, *a: (state, orig(self, state, *a)[1]))


def _half_batch(monkeypatch):
    from triplegan_tpu_torch.train import step

    orig = step._make_batch_draw
    monkeypatch.setattr(step, "_make_batch_draw", lambda cfg, n_shards=1: orig(cfg, 2 * n_shards))


@pytest.mark.parametrize("fault", [_frozen, _half_batch])
def test_a_broken_timed_path_comes_out_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    line, _, _ = run.run_cell(root, "tiny.train", SEED, 1.0, False, "cpu")
    assert not line["correct"], line["checks"]


def _records(work, lead=3, trail=3):
    mark = [(i, i + 1, "void spin_kernel(long)") for i in range(lead)]
    tail = [(1000 + i, 1001 + i, "void spin_kernel(long)") for i in range(trail)]
    return mark + work + tail


def test_a_trace_reads_busy_idle_and_rooflines(tmp_path):
    work = [(10, 20, "void (anonymous namespace)::fwd_kernel<float>(...)"), (15, 30, "memcpy"),
            (40, 50, "void (anonymous namespace)::sba_fwd_rows<float>(...)")]
    t = traced.from_records(_records(work), [(30, 40, "cudaGraphLaunch")])
    assert t.window == (3, 1000) and t.busy_s() == 30e-9
    assert t.idle_gaps()[0][0] == "host: no recorded op" and ["cudaGraphLaunch", 10e-9] in t.idle_gaps()
    folder = tmp_path / "pats"
    folder.mkdir()
    (folder / "a.txt").write_text("# conv\n\\(anonymous namespace\\)::fwd_kernel<\n")
    assert traced.roofline(t, str(folder), 5e-9, 1, "x") == pytest.approx(50.0)
    (folder / "a.txt").write_text("no_such_kernel\n")
    with pytest.raises(RuntimeError, match="match no device record"):
        traced.roofline(t, str(folder), 5e-9, 1, "x")


def test_a_trace_that_lost_its_markers_raises():
    work = [(10, 20, "k")]
    with pytest.raises(RuntimeError, match="marker"):
        traced.from_records(_records(work, lead=0), [])
