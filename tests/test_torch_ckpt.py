"""The port's checkpoints (``triplegan_tpu_torch/ckpt/manager.py``): the
whole TrainState round-trips bit for bit, only the newest ``max_to_keep``
stay, a missing ``--step`` names the steps there are, a torn save is
ignored by readers and removed only by a writer, and a template that does
not fit the checkpoint is refused by name. Saves are asynchronous, as the
JAX manager's orbax saves: ``save`` returns before the file is published
(a ``torch.save`` held on an event shows it), a state changed in place
right after ``save`` still restores as saved, a failing write raises at
``wait``, and keep-N and the one-save-a-step rule count the save in
flight. All on the CPU at the tiny test config (mirrored from the JAX
package's config through ``config.json``)."""

import os
import threading

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.helpers import tiny_config  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu_torch.ckpt.manager import CheckpointManager  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.train.schedule import AdamState, make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import TrainState, create_state  # noqa: E402

torch.set_num_threads(1)


def _cfg(tmp_path, **overrides):
    path = str(tmp_path / "jax_config.json")
    save_config(tiny_config(**overrides), path)
    return port_base.merge_saved(port_base.base_config(), path)


def _state(cfg, seed=0):
    return create_state(cfg, port_base.make_networks(cfg), make_optimizers(cfg, 16), seed=seed,
                        device="cpu")


def _advanced(state, step):
    """``state`` as if trained: every tensor changed, Adam counts and step
    moved on."""
    gen = torch.Generator().manual_seed(step)

    def bump(tree):
        return {layer: {k: t + torch.randn(t.shape, generator=gen) for k, t in arrays.items()}
                for layer, arrays in tree.items()}

    return TrainState(
        params={p: bump(t) for p, t in state.params.items()},
        bn={p: bump(t) for p, t in state.bn.items()},
        opt={p: AdamState(step, bump(s.mu), bump(s.nu)) for p, s in state.opt.items()},
        step=step, seed=state.seed + 7)


def _assert_equal_states(a: TrainState, b: TrainState):
    assert (a.step, a.seed) == (b.step, b.seed)
    for p in a.params:
        for tree_a, tree_b in ((a.params[p], b.params[p]), (a.bn[p], b.bn[p]),
                               (a.opt[p].mu, b.opt[p].mu), (a.opt[p].nu, b.opt[p].nu)):
            assert tree_a.keys() == tree_b.keys()
            for layer in tree_a:
                for k in tree_a[layer]:
                    assert torch.equal(tree_a[layer][k], tree_b[layer][k]), (p, layer, k)
        assert isinstance(b.opt[p], AdamState) and a.opt[p].count == b.opt[p].count


def test_round_trip_is_exact(tmp_path):
    cfg = _cfg(tmp_path)
    saved = _advanced(_state(cfg), 5)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.restore(_state(cfg)) is None  # an empty directory
    assert mgr.save(5, saved)
    mgr.wait()
    assert os.listdir(tmp_path / "ckpt") == ["5"]
    got = CheckpointManager(str(tmp_path / "ckpt"), write=False).restore(_state(cfg, seed=3))
    _assert_equal_states(saved, got)
    assert all(t.device.type == "cpu" for arrays in got.params["gen"].values() for t in arrays.values())


def test_keeps_the_newest_and_saves_a_step_once(tmp_path):
    cfg = _cfg(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    state = _state(cfg)
    for step in (2, 4, 6, 8):
        assert mgr.save(step, _advanced(state, step))
    mgr.wait()
    assert mgr.all_steps() == [6, 8] and mgr.latest_step() == 8
    assert not mgr.save(8, _advanced(state, 9))  # not again, and not replaced
    assert not mgr.save(7, _advanced(state, 7))
    assert mgr.restore(state).opt["gen"].count == 8
    _assert_equal_states(_advanced(state, 6), mgr.restore(state, step=6))


def test_missing_step_names_the_steps_there_are(tmp_path):
    cfg = _cfg(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, _advanced(_state(cfg), 3))
    mgr.save(4, _advanced(_state(cfg), 4))
    with pytest.raises(FileNotFoundError, match=r"no checkpoint for step 99 \(available: \[3, 4\]\)"):
        mgr.restore(_state(cfg), step=99)


def test_torn_save_is_ignored_and_only_a_writer_removes_it(tmp_path):
    cfg = _cfg(tmp_path)
    d = tmp_path / "ckpt"
    writer = CheckpointManager(str(d))
    writer.save(4, _advanced(_state(cfg), 4))
    writer.close()
    torn = d / "6.tmp-12345"
    torn.write_bytes(b"half a checkpoint")
    reader = CheckpointManager(str(d), write=False)
    assert reader.all_steps() == [4] and torn.exists()
    assert reader.restore(_state(cfg)).step == 4
    assert torn.exists()  # a reader never deletes: the writer may still be at it
    CheckpointManager(str(d))
    assert not torn.exists() and sorted(os.listdir(d)) == ["4"]


def test_a_template_that_does_not_fit_is_refused_by_name(tmp_path):
    cfg = _cfg(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(4, _advanced(_state(cfg), 4))
    wider = _cfg(tmp_path, z_dim=24)  # the Generator's dense kernel grows
    with pytest.raises(ValueError, match=r"'opt/gen/mu/dense/w' has shape \(26, 512\), the template \(34, 512\)"):
        mgr.restore(_state(wider))
    other = _cfg(tmp_path)
    other.clf.tail = (16,)  # one NiN layer fewer
    with pytest.raises(ValueError, match="checkpoint has 'bn/clf/"):
        mgr.restore(_state(other))
    template = _state(cfg)
    template.params["disc"]["head"]["v"] = template.params["disc"]["head"]["v"].double()
    with pytest.raises(ValueError, match=r"'params/disc/head/v' has dtype torch.float32, the template torch.float64"):
        mgr.restore(template)


def test_a_state_changed_in_place_after_save_restores_as_saved(tmp_path):
    """``save`` copies the state to the host before it returns: a chunk
    that writes into the state's own tensors right after cannot reach the
    file."""
    cfg = _cfg(tmp_path)
    state = _advanced(_state(cfg), 5)
    kept = _advanced(_state(cfg), 5)  # the same values, other tensors
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(5, state)
    for p in state.params:
        for tree in (state.params[p], state.bn[p], state.opt[p].mu, state.opt[p].nu):
            for arrays in tree.values():
                for t in arrays.values():
                    t.add_(1.0)
    mgr.wait()
    _assert_equal_states(kept, CheckpointManager(str(tmp_path / "ckpt"), write=False).restore(_state(cfg)))


def test_save_returns_before_the_file_is_published(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path)
    release, started = threading.Event(), threading.Event()
    real_save = torch.save

    def held(obj, f):
        started.set()
        assert release.wait(timeout=60)
        real_save(obj, f)

    monkeypatch.setattr(torch, "save", held)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(3, _advanced(_state(cfg), 3))
    assert started.wait(timeout=60)
    assert mgr.all_steps() == []  # returned, and nothing is published yet
    assert not CheckpointManager(str(tmp_path / "ckpt"), write=False).all_steps()
    release.set()
    mgr.wait()
    assert mgr.all_steps() == [3]
    assert not [n for n in os.listdir(tmp_path / "ckpt") if n != "3"]  # the tmp file was renamed


def test_a_failing_write_raises_at_wait(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path)

    def broken(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(2, _advanced(_state(cfg), 2))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert os.listdir(tmp_path / "ckpt") == []  # neither the step nor its tmp file
    mgr.wait()  # raised once


def test_keep_n_and_one_save_a_step_hold_with_a_save_in_flight(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path)
    release = threading.Event()
    real_save = torch.save

    def held(obj, f):
        assert release.wait(timeout=60)
        real_save(obj, f)

    monkeypatch.setattr(torch, "save", held)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    state = _state(cfg)
    for step in (2, 4):
        release.set()
        assert mgr.save(step, _advanced(state, step))
    # 4 is published before the event is cleared: a writer that had not yet
    # reached release.wait would otherwise block there, and save(6) with it
    mgr.join()
    assert mgr.all_steps() == [2, 4]
    release.clear()
    assert mgr.save(6, _advanced(state, 6))  # 6 is held in flight
    assert mgr.all_steps() == [2, 4]
    assert not mgr.save(6, _advanced(state, 7))  # the step in flight counts
    assert not mgr.save(5, _advanced(state, 5))
    release.set()
    mgr.wait()
    assert mgr.all_steps() == [4, 6]
    _assert_equal_states(_advanced(state, 6), mgr.restore(state))


def test_rapid_saves_under_fast_thread_switching_publish_every_step_in_order(tmp_path):
    """Twenty saves back to back, the interpreter switching threads every
    microsecond: each save waits for the one in flight, so every step is
    published, in order, and the kept two are the last two, each exactly
    the state saved under its number."""
    import sys

    cfg = _cfg(tmp_path)
    state = _state(cfg)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    published = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(1, 21):
            assert mgr.save(step, _advanced(state, step))
            published.append(mgr.latest_step())
        mgr.wait()
    finally:
        sys.setswitchinterval(interval)
    # once save(k) returns, k - 1 is published (save waited for it); k may be too
    assert all(latest in ((None, 1) if step == 1 else (step - 1, step))
               for step, latest in zip(range(1, 21), published)), published
    assert mgr.all_steps() == [19, 20]
    for step in (19, 20):
        _assert_equal_states(_advanced(state, step), mgr.restore(state, step=step))
