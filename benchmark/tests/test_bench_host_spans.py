"""The readers of the port's host ranges against a Chrome trace written
by hand: known range durations on two threads, and None where the
ranges are absent."""

import json
import types

import pytest

from benchmark import metrics


def _event(name, tid, ts_us, dur_us, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts_us, "dur": dur_us}


#: Trainer thread 1, producer threads 2 and 3, over 3 windows of 2 steps.
TRACE = [
    _event("ddl.window_wait", 1, 0, 90_000),
    _event("ddl.ring_wait", 1, 10, 1_000),
    _event("ddl.ring_wait", 1, 100_000, 3_000),
    _event("ddl.ring_wait", 1, 200_000, 2_000),
    _event("ddl.integrity_verify", 1, 2_000, 60_000),
    _event("ddl.integrity_verify", 1, 110_000, 66_000),
    _event("ddl.integrity_verify", 1, 210_000, 54_000),
    _event("ddl.step_dispatch", 1, 70_000, 4_000),
    _event("ddl.step_dispatch", 1, 180_000, 5_000),
    _event("ddl.step_dispatch", 1, 280_000, 3_000),
    _event("producer.fill", 2, 0, 30_000),
    _event("producer.stamp", 2, 31_000, 70_000),
    _event("producer.fill", 3, 5_000, 34_000),
    _event("producer.stamp", 3, 40_000, 66_000),
    _event("producer.fill", 2, 110_000, 32_000),
    # A producer range cut off by the trace's end: filled, never stamped.
    _event("producer.fill", 3, 120_000, 30_000),
    _event("producer.stamp", 2, 150_000, 64_000),
    # The SpanLog's lanes (another category) are not the port's ranges.
    _event("producer.fill", 9, 0, 1e9, cat="ddl"),
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
     "args": {"name": "trainer"}},
    {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7,
     "ts": 0, "dur": 100},
]


def _run(tmp_path, events, traced_windows=3, steps_per_window=2,
         name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events,
                                "baseTimeNanoseconds": 1}))
    prog = types.SimpleNamespace(trace_path=str(path),
                                 traced_windows=traced_windows)
    return metrics.RunView(
        config={}, traffic={"steps_per_window": steps_per_window},
        item_unit="images", items_per_step=1, step_flops=0.0, attention={},
        peaks=None, prog=prog, trace=None)


def _read(name, run):
    return metrics.reader(name).read(run)


def test_readers_sum_the_ranges_over_the_traced_steps(tmp_path):
    run = _run(tmp_path, TRACE)
    assert _read("verify_ms.images", run) == pytest.approx(180.0 / 6)
    assert _read("ring_wait_ms.images", run) == pytest.approx(6.0 / 6)
    assert _read("dispatch_ms.images", run) == pytest.approx(12.0 / 6)
    assert _read("dispatch_ms.tokens", run) == pytest.approx(12.0 / 6)
    # Fill and stamp over both producer threads, over the 3 stamped windows.
    assert _read("producer_ms.images", run) == pytest.approx(
        (30 + 34 + 32 + 30 + 70 + 66 + 64) / 3)


@pytest.mark.parametrize("metric", ["verify_ms.images", "ring_wait_ms.images",
                                    "producer_ms.images", "dispatch_ms.tokens",
                                    "dispatch_ms.images"])
def test_none_without_the_ranges(tmp_path, metric):
    # A program that opens only the ranges it had before them.
    older = [e for e in TRACE if not e["name"].startswith(
        ("ddl.ring", "ddl.integrity", "ddl.step", "producer."))]
    assert _read(metric, _run(tmp_path, older)) is None
    untraced = _run(tmp_path, TRACE, name="other.json")
    untraced.prog.trace_path = None
    assert _read(metric, untraced) is None


def test_producer_ms_needs_a_stamped_window(tmp_path):
    fills = [e for e in TRACE if e["name"] == "producer.fill"]
    assert _read("producer_ms.images", _run(tmp_path, fills)) is None


def test_no_traced_steps_reads_none(tmp_path):
    assert _read("verify_ms.images", _run(tmp_path, TRACE,
                                          traced_windows=0)) is None


def test_the_trace_is_read_again_once_rewritten(tmp_path):
    run = _run(tmp_path, TRACE)
    assert _read("verify_ms.images", run) == pytest.approx(30.0)
    fewer = [e for e in TRACE if not (e["name"] == "ddl.integrity_verify"
                                      and e["dur"] == 54_000)]
    run = _run(tmp_path, fewer)
    assert _read("verify_ms.images", run) == pytest.approx(126.0 / 6)
