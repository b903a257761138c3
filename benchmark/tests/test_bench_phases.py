"""The readers of the program's own marks and spans (``phases.py``) on
synthetic traces: device records are attributed to the phase of the last
mark before them and summed; a missing mark, a count of steps that is not
the traced one, or work outside the phases raises; the call's self time
leaves out the replay it holds; a capture in the window raises; a window
with none of the program's marks and spans reads nothing, and one with
some of them but not those a reader needs raises."""

import types

import pytest

import tiny  # first: it puts the benchmark's folder on sys.path
import harness
import phases
import traced

ORDER = [p for _, p in phases.names()["marks"]]
MARK = dict((p, m) for m, p in phases.names()["marks"])
WORK = {"d_grad": 300, "d_adam": 20, "g_grad": 100, "g_adam": 10, "c_grad": 900, "c_adam": 30}


def _steps(n, draw=2, drop=None):
    """``n`` steps' device records from t = 100 on: each phase's 1 ns mark
    and its work, the end mark, then ``draw`` ns of work in no phase;
    ``drop`` names a (step, phase) whose mark is left out."""
    recs, t = [], 100
    for i in range(n):
        for p in ORDER:
            if (i, p) != drop:
                recs.append((t, t + 1, MARK[p]))
            t += 1
            if p in WORK:
                recs.append((t, t + WORK[p], f"kernel_{p}"))
                t += WORK[p]
        recs.append((t, t + draw, "gather"))
        t += draw + 5
    return recs


def _trace(recs, host=()):
    lead = [(i, i + 1, "void spin_kernel(long)") for i in range(3)]
    tail = [(10 ** 7 + i, 10 ** 7 + i + 1, "void spin_kernel(long)") for i in range(3)]
    return traced.from_records(lead + recs + tail, sorted(host))


def _ctx(trace, steps, calls=2):
    cell = types.SimpleNamespace(traffic={"trace_calls": calls})
    return {"kind": "train", "trace": trace, "trace_steps": steps, "cell": cell}


def test_records_go_to_the_phase_of_the_last_mark_and_are_summed():
    got = phases.phase_ns(_trace(_steps(4)), 4)
    assert got == {p: 4 * (1 + w) for p, w in WORK.items()}  # each phase's mark counts in it
    ctx = _ctx(_trace(_steps(4)), 4)
    assert phases.phase_ms(ctx, "d_grad") == pytest.approx(301 / 1e6)
    assert phases.phase_ms(ctx, "d_adam", "g_adam", "c_adam") == pytest.approx(63 / 1e6)


def test_the_cells_readers_read_the_marks(tmp_path):
    cell = harness.load_cell(tiny.make_root(str(tmp_path)), "tiny.train")
    ctx = _ctx(_trace(_steps(2)), 2)
    want = {"d_grad_ms.train": 301, "g_grad_ms.train": 101, "c_grad_ms.train": 901, "adam_ms.train": 63}
    for name, ns in want.items():
        assert harness.reader(cell, name)(ctx) == pytest.approx(ns / 1e6), name


@pytest.mark.parametrize("recs, host, steps, match", [
    (_steps(2, drop=(1, "g_adam")), (), 2, "out of order or some are missing"),
    (_steps(2, drop=(1, "d_grad")), (), 2, "1 d_grad marks for 2 steps"),
    (_steps(3), (), 2, "3 d_grad marks for 2 steps"),
    (_steps(2, draw=200), (), 2, "under 97%"),
    ([(100, 200, "kernel")], [(90, 210, "tg::chunk.call")], 2, "no phase mark"),
], ids=["a mark missing", "a step's first mark missing", "more steps than traced", "work between steps",
        "no mark"])
def test_a_trace_the_phases_cannot_account_for_raises(recs, host, steps, match):
    with pytest.raises(RuntimeError, match=match):
        phases.phase_ns(_trace(recs, host=host), steps)


def test_a_window_without_the_programs_marks_or_spans_reads_nothing():
    ctx = _ctx(_trace([(100, 200, "kernel")], host=[(90, 210, "cudaGraphLaunch")]), 2)
    assert phases.phase_ms(ctx, "d_grad") is None and phases.call_self_ms(ctx) is None


CALLS = [(0, 100, "tg::chunk.call"), (200, 300, "tg::chunk.call")]
REPLAYS = [(20, 90, "tg::chunk.replay"), (210, 250, "tg::chunk.replay"), (215, 240, "cudaGraphLaunch")]


def test_the_calls_self_time_leaves_out_the_replay_it_holds():
    ctx = _ctx(_trace(_steps(8), host=CALLS + REPLAYS), 8)
    assert phases.call_self_ms(ctx) == pytest.approx((30 + 60) / 1e6 / 8)


@pytest.mark.parametrize("host, match", [
    (CALLS + REPLAYS + [(5, 15, "tg::chunk.capture")], "captured its graph anew"),
    (CALLS[:1] + REPLAYS, "1 tg::chunk.call spans for 2 calls"),
    (REPLAYS, "no tg::chunk.call span"),
    ((), "no tg::chunk.call span"),
], ids=["a capture in the window", "a call missing", "no call", "marks and no span"])
def test_a_window_the_call_spans_cannot_account_for_raises(host, match):
    with pytest.raises(RuntimeError, match=match):
        phases.call_self_ms(_ctx(_trace(_steps(8), host=host), 8))
