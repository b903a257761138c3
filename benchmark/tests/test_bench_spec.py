"""BENCHMARK.json against the benchmark's contract, and the frozen work
count against the counts the card runs have checked."""

import collections
import json
import os
import re

import pytest

from tiny import BENCH, REPO  # first: it puts the benchmark's folder on sys.path
import work

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_keys_follow_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(REPO, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits", w["name"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and LINE.match(m["layer"])
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            moved = m.get("moves")
            if moved:  # the cell reports the end-to-end metric this one moves
                e = next(x for x in b["end_to_end"] if x["name"] == moved)
                assert cell in e.get("workloads", cells)
    for cell in cells:  # each cell: setup_s, one more end-to-end metric, one per-layer metric
        assert sum(cell in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", ["cifar10_4k"])
def test_configuration_files_are_the_registry_entries_uncut(name):
    from triplegan_tpu_torch.configs import get_config

    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        conf = json.load(f)
    cfg = json.loads(json.dumps(get_config(conf["registry"]), default=list))
    for key, value in conf["config"].items():
        if isinstance(value, dict):
            for k, v in value.items():
                assert cfg[key][k] == v, (key, k)
        else:
            assert cfg[key] == value, key


@pytest.mark.parametrize("name, want", [
    ("cifar10_4k", {"conv_fwd": 72, "conv_wgrad": 27, "epilogue_fwd": 66, "epilogue_bwd": 43}),
    ("mnist100", {"conv_fwd": 49, "conv_wgrad": 19, "epilogue_fwd": 45, "epilogue_bwd": 29}),
])
def test_frozen_count_gives_the_launches_the_card_runs_checked(name, want):
    import chip_smoke
    from triplegan_tpu_torch.configs import get_config

    sz = json.loads(json.dumps(get_config(name), default=list))  # the registry entry: no cell runs mnist100
    assert work.launches(sz) == want

    convs, _, epi, epi_bwd = chip_smoke.step_launches(get_config(name), env={})
    kinds = collections.Counter()
    for key, n in convs.items():
        kinds["conv_wgrad" if key[0] == "wgrad" else "conv_fwd"] += n
    assert dict(kinds, epilogue_fwd=epi, epilogue_bwd=epi_bwd) == want


def test_frozen_count_of_a_conv_layer():
    layer = work.Layer("conv", "c", 3, 1, 32, 32, 128, 128, True, True)
    call = work.Call(layer, "fwd", 100)
    assert call.flops() == 2 * 100 * 32 * 32 * 128 * 9 * 128
    assert call.bytes(4) == 4 * (2 * 100 * 32 * 32 * 128 + 9 * 128 * 128)
    dec = work.Layer("deconv", "d", 5, 2, 4, 8, 512, 256, True, False)
    assert work.Call(dec, "fwd", 1).flops() == 2 * 4 * 4 * 512 * 256 * 25
