"""`benchmark/program_spans.py` on a chrome trace built by hand, checked
exactly: launches, device and idle time by the main thread's innermost
`eodt.` span, a span taken whole and as its self part, launches made on a
second thread inside the main thread's backward span, idle gaps split
across two spans and outside every span, and the readers' None for a
program without spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import common, program_spans

MAIN, AUTOGRAD, STREAM = 11, 12, 7


def _range(name, ts, end, tid=MAIN, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "tid": tid, "pid": 1}


def _launch(corr, ts, tid=MAIN, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel",
            "ts": ts, "dur": 0.5, "tid": tid, "pid": 1,
            "args": {"correlation": corr}}


def _device(corr, ts, end, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "ts": ts,
            "dur": end - ts, "tid": STREAM, "pid": 0,
            "args": {"correlation": corr}}


def _trace(with_spans=True):
    """A training step in [0, 100] us: forward [10, 40] with the trunk
    [12, 25] inside it, backward [45, 80], optimizer [82, 95]."""
    events = [_range("bench.unit", 0, 100)]
    if with_spans:
        events += [
            _range("eodt.train.forward", 10, 40),
            _range("eodt.trunk", 12, 25),
            _range("eodt.train.backward", 45, 80),
            _range("eodt.train.optimizer", 82, 95),
            # not the main thread's, and not a span: both ignored
            _range("eodt.trunk", 48, 75, tid=AUTOGRAD),
            _range("eodt::memory_read", 31, 33, cat="cpu_op"),
        ]
    events += [
        _launch(6, 4), _device(6, 5, 8),                 # under no span
        _launch(1, 13), _device(1, 14, 20),              # trunk
        _launch(2, 30), _device(2, 30, 35),              # forward's self
        _launch(7, 31, cat="cuda_driver"), _device(7, 35, 36),
        # the backward, launched from autograd's thread
        _launch(3, 50, AUTOGRAD), _device(3, 50, 60),
        _launch(4, 62, AUTOGRAD), _device(4, 62, 70),
        _launch(5, 84), _device(5, 85, 88, "gpu_memcpy"),  # optimizer
        _device(9, 96, 97),                              # no launch event
        _device(8, 120, 130),                            # after the window
    ]
    return common.Trace(events)


def _view(trace, frames=40, steps=1):
    lo, hi = trace.window()
    return SimpleNamespace(trace=trace, lo=lo, hi=hi, frames=frames,
                           steps=steps)


def test_segments_are_the_innermost_stacks():
    got = program_spans.segments([(10, 40, "a"), (12, 25, "b"),
                                  (20, 30, "c"), (45, 80, "d")])
    # c outlasts its parent b (rounded timestamps) and is cut at b's end
    assert got == [(10, 12, ("a",)), (12, 20, ("a", "b")),
                   (20, 25, ("a", "b", "c")), (25, 40, ("a",)),
                   (45, 80, ("d",))]


def test_spans_by_launch_and_idle_split():
    trace = _trace()
    got = program_spans.read_spans(trace, *trace.window())
    T = program_spans.Totals
    us = 1e-6
    # idle: [0,5] [8,14] [20,30] [36,50] [60,62] [70,85] [88,96] [97,100]
    assert got.idle_s == pytest.approx(63 * us)
    assert got.whole["eodt.trunk"] == T(1, pytest.approx(6 * us),
                                        pytest.approx(7 * us))
    assert got.own["eodt.trunk"] == got.whole["eodt.trunk"]
    # a kernel launched through the CUDA driver API counts as any other
    assert got.own["eodt.train.forward"] == T(
        2, pytest.approx(6 * us), pytest.approx(11 * us))
    assert got.whole["eodt.train.forward"] == T(
        3, pytest.approx(12 * us), pytest.approx(18 * us))
    # two launches from the second thread, inside the main thread's span
    assert got.whole["eodt.train.backward"] == T(
        2, pytest.approx(18 * us), pytest.approx(17 * us))
    # a copy is device time, not a launch; the idle [88, 96] is split at
    # the span's end
    assert got.whole["eodt.train.optimizer"] == T(
        0, pytest.approx(3 * us), pytest.approx(10 * us))
    # under no span: the kernel at 5, the op without a launch event, and
    # the idle [0,5], [8,10], [40,45], [80,82], [95,96], [97,100]
    assert got.outside == T(2, pytest.approx(4 * us), pytest.approx(
        18 * us))
    assert got.outside_kernels == [("op6", 1), ("op9", 1)]
    assert got.unlaunched == 1
    assert sorted(got.whole) == ["eodt.train.backward", "eodt.train.forward",
                                 "eodt.train.optimizer", "eodt.trunk"]
    parts = [got.own[n].idle_s for n in got.own] + [got.outside.idle_s]
    assert sum(parts) == pytest.approx(got.idle_s)


@pytest.mark.parametrize("name, want", [
    ("forward_launches_per_step.train", 3),
    ("forward_device_ms_per_step.train", 12e-3),
    ("forward_idle_ms_per_step.train", 18e-3),
    ("backward_launches_per_step.train", 2),
    ("backward_device_ms_per_step.train", 18e-3),
    ("backward_idle_ms_per_step.train", 17e-3),
    ("optimizer_launches_per_step.train", 0),
    ("optimizer_device_ms_per_step.train", 3e-3),
    ("optimizer_idle_ms_per_step.train", 10e-3),
])
def test_train_readers(name, want, capsys):
    view = _view(_trace())
    assert common.metric_reader(name)(view) == pytest.approx(want)
    assert "lie under no eodt. span" in capsys.readouterr().err
    # a program without the spans: no reading, and no error
    assert common.metric_reader(name)(_view(_trace(False))) is None


def test_eval_readers_take_the_carry_as_a_self_part():
    events = [_range("bench.unit", 0, 100)]
    for k, t0 in enumerate((0, 50)):
        events += [_range("eodt.stream_step", t0 + 2, t0 + 48),
                   _range("eodt.frame", t0 + 10, t0 + 40),
                   _range("eodt.frame.cascade", t0 + 20, t0 + 30),
                   _launch(10 * k + 1, t0 + 5), _device(10 * k + 1, t0 + 5,
                                                        t0 + 6),
                   _launch(10 * k + 2, t0 + 22), _device(10 * k + 2, t0 + 22,
                                                         t0 + 26),
                   _launch(10 * k + 3, t0 + 45), _device(10 * k + 3, t0 + 45,
                                                         t0 + 47)]
    view = _view(common.Trace(events), frames=2)
    read = common.metric_reader
    assert read("carry_launches_per_frame.eval")(view) == 2
    assert read("carry_device_ms_per_frame.eval")(view) == pytest.approx(
        3e-3)
    # the carry's idle: [2,5] [6,10] [40,45] [47,48] of each frame
    assert read("carry_idle_ms_per_frame.eval")(view) == pytest.approx(
        13e-3)
    assert read("cascade_launches_per_frame.eval")(view) == 1
    assert read("cascade_device_ms_per_frame.eval")(view) == pytest.approx(
        4e-3)
    assert read("cascade_idle_ms_per_frame.eval")(view) == pytest.approx(
        6e-3)
    # a stage the program did not run: no reading
    assert read("fpn_launches_per_frame.eval")(view) is None
