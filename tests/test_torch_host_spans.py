"""The port's host ranges and their timers (``ddl_tpu_torch.profiling``).

- A window-streamed ``Trainer.fit`` under ``profiling.trace`` opens
  ``ddl.ring_wait``, ``ddl.integrity_verify``, ``ddl.step_dispatch``,
  ``ddl.loss_readback`` and ``ddl.window_hook`` once a window, every
  ``ddl.`` range on the thread that holds ``ddl.window_wait``; THREAD
  producers open one ``producer.fill`` and one ``producer.stamp`` a
  window they commit; these ranges feed no timer, the window wait and
  acquire keep theirs.
- A staging worker's ranges drop the ``ddl.`` prefix
  (``staging.transfer``, ``ingest.put_window``); the consumer's steal and
  wait keep it.
- With no profiler running, ``annotate`` opens no ``record_function`` and
  still feeds its timer.
- ``profiling.trace`` lays an armed ``SpanLog``'s events on the
  profiler's clock, a process per source pid.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from ddl_tpu_torch import profiling
from ddl_tpu_torch.obs import spans as obs_spans
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics

#: The trainer-thread ranges opened once a served window.
PER_WINDOW = ("ddl.ring_wait", "ddl.integrity_verify", "ddl.step_dispatch",
              "ddl.loss_readback", "ddl.window_hook")
#: Names the ranges above and the producers' would have had as timers:
#: the ranges feed none.
NO_TIMERS = ("consumer.ring_wait", "integrity.verify", "trainer.dispatch",
             "trainer.loss_readback", "trainer.window_hook",
             "trainer.boundary", "producer.fill", "producer.stamp")
N_WINDOWS = 4
N_PRODUCERS = 2


def _ranges(path):
    """The trace's host ranges: ``[(name, tid, ts_us, dur_us)]``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e.get("tid"), float(e["ts"]), float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tokens.bin")
    np.random.default_rng(8).integers(0, 64, 20_000,
                                      dtype=np.int32).tofile(path)
    return path


def _fit(token_file, metrics, fused, mode="thread", n_producers=N_PRODUCERS):
    from ddl_tpu_torch.models import llama as tllama
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    cfg = tllama.LlamaConfig(vocab=64, d_model=32, n_layers=1, n_heads=4,
                             n_kv_heads=2, d_ff=64, max_seq=16,
                             dtype=torch.float32)
    trainer = Trainer(
        loss_fn=lambda p, b: tllama.next_token_loss(p, b[0], cfg),
        optimizer=adamw(3e-3),
        init_params=tllama.init_params(cfg, seed=1, device="cpu"),
        device="cpu", metrics=metrics)
    return trainer.fit(TokenStreamProducer(token_file, 16, 8, seed=2),
                       batch_size=4, n_epochs=N_WINDOWS,
                       n_producers=n_producers, mode=mode,
                       window_stream=True, window_hook=lambda w: w,
                       fused=fused)


def _producer_windows():
    """THREAD producers record into the process-default registry."""
    return default_metrics().counter("producer.windows")


def _spans_pid(event):
    """Is ``event`` on a ``ddl spans`` process?  (The profiler's own pids
    may be strings.)"""
    pid = event.get("pid")
    return isinstance(pid, int) and pid >= profiling.SPANS_PID


def _timer_keys(snap):
    return {k[:-len(".count")] for k in snap if k.endswith(".count")}


@pytest.mark.parametrize("inplace", ["1", "0"], ids=["inplace", "copy"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "sync"])
def test_fit_ranges_once_a_window_on_the_trainer_thread(
        token_file, tmp_path, monkeypatch, fused, inplace):
    monkeypatch.setenv("DDL_TORCH_INPLACE", inplace)
    m = Metrics()
    before = _producer_windows()
    with profiling.trace(str(tmp_path)) as prof:
        res = _fit(token_file, m, fused)
    committed = _producer_windows() - before
    assert len(res.losses) == N_WINDOWS
    ranges = _ranges(prof.trace_path)
    trainer_tids = {t for n, t, _, _ in ranges if n == "ddl.window_wait"}
    assert len(trainer_tids) == 1
    for name in PER_WINDOW:
        tids = [t for n, t, _, _ in ranges if n == name]
        assert len(tids) == N_WINDOWS, name
        assert set(tids) == trainer_tids, name
    # No ddl. range off the trainer's thread, none of a producer's on it.
    assert {t for n, t, _, _ in ranges if n.startswith("ddl.")} == trainer_tids
    assert committed >= N_WINDOWS
    stamps = [t for n, t, _, _ in ranges if n == "producer.stamp"]
    fills = [t for n, t, _, _ in ranges if n == "producer.fill"]
    assert len(stamps) == committed
    # A refill the shutdown cut off before its free slot stamps nothing.
    assert committed <= len(fills) <= committed + N_PRODUCERS
    assert len(set(stamps)) == N_PRODUCERS
    assert not (set(stamps) | set(fills)) & trainer_tids
    # The ranges feed no timer; the window acquire and wait feed theirs.
    assert not _timer_keys(m.snapshot()) & set(NO_TIMERS)
    assert not _timer_keys(default_metrics().snapshot()) & set(NO_TIMERS)
    assert m.timer("consumer.wait").count == N_WINDOWS
    assert m.timer("trainer.window_wait").count == N_WINDOWS + 1


def test_fit_timers_without_a_profiler(token_file):
    """The window acquire and wait timers count alike with no profiler
    running, and the range-only stages add no timer."""
    m = Metrics()
    before = _producer_windows()
    _fit(token_file, m, fused=True)
    assert m.timer("consumer.wait").count == N_WINDOWS
    assert m.timer("trainer.window_wait").count == N_WINDOWS + 1
    assert m.timer("consumer.wait").total_s > 0.0
    assert _producer_windows() - before >= N_WINDOWS
    assert not _timer_keys(m.snapshot()) & set(NO_TIMERS)


def test_process_producers_ship_their_timers(token_file):
    """A PROCESS producer's registry reaches the consumer's under
    ``producer.<idx>.``; its fill and stamp ranges add no timer to it."""
    m = Metrics()
    _fit(token_file, m, fused=True, mode="process", n_producers=1)
    snap = m.snapshot()
    assert snap["producer.0.producer.windows"] >= N_WINDOWS
    assert "producer.windows" not in snap
    shipped = {k[len("producer.0."):] for k in snap
               if k.startswith("producer.0.")}
    assert not _timer_keys(shipped) & set(NO_TIMERS)


def test_staging_worker_ranges_drop_the_prefix(tmp_path):
    from ddl_tpu_torch.ingest import DeviceIngestor
    from ddl_tpu_torch.staging import StagingPool, TransferExecutor

    m = Metrics()
    ex = TransferExecutor(StagingPool(metrics=m), metrics=m, max_queue=4)
    ingestor = DeviceIngestor(device="cpu", metrics=m)

    def transfer(buf):
        t = ingestor.put_window(buf, defer_metrics=True)
        return t, t

    with profiling.trace(str(tmp_path)) as prof:
        oldest = ex.submit(np.zeros((64,), np.float32), transfer)
        newest = ex.submit(np.ones((64,), np.float32), transfer)
        # At two queued jobs the worker takes the newest.
        assert newest.ready.wait(10.0)
        assert newest.worker_executed
        for h in (oldest, newest):
            ex.complete(h, timeout_s=10.0)
    ex.close()
    ranges = _ranges(prof.trace_path)
    by = {}
    for n, t, _, _ in ranges:
        by.setdefault(n, set()).add(t)
    worker = by["staging.transfer"]
    assert len(worker) == 1
    assert by["ingest.put_window"] == worker
    assert by["ddl.staging_transfer"] == by["ddl.ingest_put_window"]
    assert by["ddl.staging_wait"] == by["ddl.staging_transfer"]
    assert not by["ddl.staging_transfer"] & worker
    assert not {t for n, t, _, _ in ranges if n.startswith("ddl.")} & worker
    assert m.timer("ingest.stall").count == 1


def test_annotate_worker_name_on_a_worker_thread():
    names = {}

    def work():
        profiling.mark_worker_thread()
        names["worker"] = profiling.annotate("ddl.x", worker="x.y").name

    t = threading.Thread(target=work)
    t.start()
    t.join(10.0)
    assert not t.is_alive()
    names["main"] = profiling.annotate("ddl.x", worker="x.y").name
    assert names == {"worker": "x.y", "main": "ddl.x"}


def test_annotate_off_opens_no_record_function(monkeypatch, tmp_path):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    m = Metrics()
    with profiling.annotate("ddl.a", m, timer="t.a"):
        time.sleep(0.002)
    with profiling.annotate("ddl.b", m):
        pass
    with profiling.annotate("ddl.c"):
        pass
    assert opened == []
    assert m.timer("t.a").count == 1 and m.timer("t.a").total_s >= 0.002
    assert m.timer("ddl.b").count == 1
    assert m.timer("ddl.a").count == 0
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("ddl.d", m, timer="t.a"):
            pass
    assert opened == ["ddl.d"]
    assert m.timer("t.a").count == 2


def test_spanlog_lands_on_the_profiler_clock(tmp_path):
    """A SpanLog span and an ``annotate`` range around one 20 ms sleep
    land within 1 ms of each other in ``profiling.trace``'s file, the
    span on this process's ``ddl spans`` process, ``trainer.consume``
    lane."""
    with obs_spans.tracing() as slog:
        obs_spans.record("trainer.consume", 1, 0, time.perf_counter() - 60)
        with profiling.trace(str(tmp_path)) as prof:
            t0 = obs_spans.t0()
            with profiling.annotate("ddl.sleep"):
                time.sleep(0.02)
            obs_spans.record("trainer.consume", 1, 1, t0)
            obs_spans.mark("consumer.yield", 1, 1)
    assert len(slog.events()) == 3
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    rng = [e for e in events
           if e.get("name") == "ddl.sleep" and e.get("ph") == "X"]
    span = [e for e in events if e.get("pid") == profiling.SPANS_PID
            and e.get("name") == "trainer.consume"]
    assert len(rng) == 1
    # The span recorded before the trace began is left out.
    assert len(span) == 1 and span[0]["args"]["seq"] == 1
    assert abs(span[0]["ts"] - rng[0]["ts"]) < 1000.0
    assert abs(span[0]["ts"] + span[0]["dur"]
               - rng[0]["ts"] - rng[0]["dur"]) < 1000.0
    meta = {(e["name"], e["tid"]): e["args"]["name"] for e in events
            if e.get("pid") == profiling.SPANS_PID
            and e.get("name") in ("process_name", "thread_name")}
    lane = obs_spans.STAGES.index("trainer.consume")
    assert meta[("process_name", 0)] == f"ddl spans {os.getpid()}"
    assert meta[("thread_name", lane)] == "trainer.consume"
    assert any(e.get("name") == "consumer.yield" and e.get("ph") == "i"
               for e in events if e.get("pid") == profiling.SPANS_PID)


def test_trace_without_a_spanlog_adds_no_lanes(tmp_path):
    assert obs_spans.log() is None
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("ddl.x"):
            pass
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert not [e for e in events if _spans_pid(e)]
    assert [e for e in events if e.get("name") == "ddl.x"]


def test_spanlog_pids_get_a_process_each(tmp_path):
    """Two producer processes' spans land on two ``ddl spans`` processes
    (their fills overlap in time, so one lane could not nest them), this
    process's first; a window's flow arrow runs from its producer's
    process to this one."""
    me = os.getpid()
    p1, p2 = me + 101, me + 202
    with obs_spans.tracing() as slog:
        with profiling.trace(str(tmp_path)) as prof:
            t = time.perf_counter()
            obs_spans.record("trainer.consume", 9, 0, t)
            slog.record_many([
                (t, t + 0.010, "producer.fill", 1, 0, p1),
                (t + 0.002, t + 0.012, "producer.fill", 2, 0, p2),
                (t + 0.012, t + 0.013, "producer.commit", 1, 0, p1),
            ])
            obs_spans.record("consumer.acquire", 1, 0,
                             time.perf_counter())
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if _spans_pid(e)]
    names = {e["pid"]: e["args"]["name"] for e in ours
             if e["name"] == "process_name"}
    assert names[profiling.SPANS_PID] == f"ddl spans {me}"
    assert sorted(names.values()) == sorted(
        f"ddl spans {p}" for p in (me, p1, p2))
    by_name = {v: k for k, v in names.items()}
    fills = [e for e in ours if e["name"] == "producer.fill"
             and e["ph"] == "X"]
    assert {e["pid"] for e in fills} == {by_name[f"ddl spans {p1}"],
                                          by_name[f"ddl spans {p2}"]}
    flows = {e["ph"]: e["pid"] for e in ours if e.get("cat") == "ddl.window"}
    assert flows == {"s": by_name[f"ddl spans {p1}"],
                     "f": profiling.SPANS_PID}
