"""The port's observability (``ddl_tpu_torch/obs``, ``observability``,
``profiling``) held to the JAX package's ``ddl_tpu.obs`` — the twin of
``tests/test_obs.py``, class for class.

Each class feeds the same inputs, made from a numpy seed, through both
packages:

- histograms: equal bucket bounds, quantiles equal to 1e-12 relative,
  states that cross between the packages;
- gauge companions: equal ``snapshot()`` keys and values;
- span logs: the same cursor, ring and totals; the same event list gives
  the same Chrome trace JSON;
- flight records: a dump from either package loads in both ``python -m
  <package>.obs dump`` tools, which print the same text;
- report merging: the same ObsReport sequence gives the same merged
  snapshot and fences;
- the THREAD and PROCESS streams: keyed lifecycle spans, stitched
  producer lanes, and arming that never changes a byte (the streams
  equal the JAX package's).  The THREAD span test holds every served
  window's ``producer.commit`` span, which the JAX package records only
  after publishing the slot (its twin races; this one must not);
- the seeded-corruption flight record names the same window as the JAX
  package's; the preemption notice dumps at poll, not in notify;
- admission waits: ``north_star_report``'s p99s equal the JAX
  package's on the same waits and agree with numpy's, and a bound
  admission gate's waits land in ``consumer.admission_wait``;
- ``north_star_report``: the same keys, and the same values on
  registries fed the same events.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
import zlib
from collections import defaultdict

import numpy as np
import pytest

from ddl_tpu import obs as jobs
from ddl_tpu import observability as jobsv
from ddl_tpu.obs import recorder as jrec
from ddl_tpu.obs import spans as jspans
from ddl_tpu_torch import obs as tobs
from ddl_tpu_torch import observability as tobsv
from ddl_tpu_torch.obs import recorder as trec
from ddl_tpu_torch.obs import spans as tspans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: north_star_report keys computed from the elapsed clock or read from
#: the process-default registry (which other tests in a worker feed).
CLOCK_KEYS = ("samples_per_sec", "stall_fraction", "ingest_bytes_per_sec",
              "elapsed_s")
DEFAULT_REGISTRY_KEYS = ("pp_bubble", "pp_chunks",
                         "opt_state_bytes_per_replica",
                         "opt_state_bytes_total", "opt_grad_comm_bytes_raw",
                         "opt_grad_comm_bytes_quantized")


def _no_clock(snap):
    return {k: v for k, v in snap.items() if k != "elapsed_s"}


# -- histograms ---------------------------------------------------------------


class TestHistogram:
    def test_bounds_equal(self):
        assert tobsv.hist_bounds() == jobsv.hist_bounds()
        assert (tobsv.HIST_MIN, tobsv.HIST_MAX, tobsv.HIST_BUCKETS_PER_DECADE) \
            == (jobsv.HIST_MIN, jobsv.HIST_MAX, jobsv.HIST_BUCKETS_PER_DECADE)

    @pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
    def test_quantiles_equal_the_reference(self, q):
        rng = np.random.default_rng(0)
        vals = rng.lognormal(-4.0, 1.5, 4000)
        th, jh = tobsv.Histogram(), jobsv.Histogram()
        for v in vals:
            th.observe(v)
            jh.observe(v)
        assert th.counts == jh.counts
        np.testing.assert_allclose(th.quantile(q), jh.quantile(q), rtol=1e-12)
        # And within one log-spaced bucket (x1.47) of numpy.
        ref = float(np.quantile(vals, q))
        assert ref / 1.5 <= th.quantile(q) <= ref * 1.5

    def test_bounded_by_construction(self):
        h = tobsv.Histogram()
        for v in (-1.0, 0.0, tobsv.HIST_MIN / 10, tobsv.HIST_MAX,
                  tobsv.HIST_MAX * 100):
            h.observe(v)
        assert h.count == 5 and len(h.counts) == len(tobsv.hist_bounds()) + 2
        assert h.counts[0] == 3 and h.counts[-1] == 2

    def test_clamps_and_empty(self):
        h = tobsv.Histogram()
        assert h.quantile(0.99) == 0.0
        assert tobsv.Metrics().quantile("never.observed", 0.5) == 0.0
        h.observe(0.5)
        assert h.quantile(0.0) == h.quantile(1.0) == 0.5

    def test_states_cross_between_the_packages(self):
        rng = np.random.default_rng(1)
        jh = jobsv.Histogram()
        for v in rng.lognormal(-3.0, 2.0, 500):
            jh.observe(v)
        th = tobs.convert(jh.state())
        assert isinstance(th, tobsv.Histogram)
        assert th.state() == jh.state()
        back = jobsv.Histogram.from_state(th.state())
        for q in (0.5, 0.9, 0.99):
            assert back.quantile(q) == jh.quantile(q) == th.quantile(q)

    def test_snapshot_percentile_keys_and_reset(self):
        snaps = []
        for pkg in (tobsv, jobsv):
            m = pkg.Metrics()
            for v in (0.01, 0.02, 3.0):
                m.observe("lat", v)
            snaps.append(_no_clock(m.snapshot()))
            m.reset()
            assert m.quantile("lat", 0.5) == 0.0
            assert "lat.p50" not in m.snapshot()
        assert snaps[0] == snaps[1]


# -- gauge companions ---------------------------------------------------------


class TestGaugeCompanions:
    def _drive(self, m):
        m.set_gauge("q.depth", 9.0)
        m.set_gauge("q.depth", 1.0)
        m.set_gauge("serve.stall.a", 0.25)
        m.incr("c.n", 3)
        m.add_time("t.x", 0.5)
        out = [_no_clock(m.snapshot())]
        m.clear_gauge("q.depth")
        out.append(_no_clock(m.snapshot()))
        m.reset()
        m.set_gauge("q.depth", 2.0)
        out.append(_no_clock(m.snapshot()))
        out.append(m.prefixed("serve."))
        return out

    def test_snapshot_keys_and_values_equal(self):
        got = self._drive(tobsv.Metrics())
        want = self._drive(jobsv.Metrics())
        assert got == want
        assert got[0]["q.depth.max"] == 9.0
        assert "q.depth" not in got[1] and "q.depth.max" not in got[1]
        assert got[2]["q.depth.max"] == 2.0


# -- span logs ------------------------------------------------------------------


class TestSpanLog:
    def test_disarmed_is_a_noop(self):
        assert tspans.log() is None
        assert tspans.t0() == 0.0
        tspans.record("x", 1, 2, 0.0)
        tspans.mark("x", 1, 2)
        tspans.set_window(1, 2)
        assert tspans.current_window() == (None, None)

    def test_ring_and_cursor_equal_the_reference(self):
        got = []
        for pkg in (tspans, jspans):
            slog = pkg.SpanLog(capacity=4)
            for i in range(10):
                slog.record("s", 1, i, float(i), float(i) + 0.5)
            a = [e[:5] for e in slog.events()]
            cur = pkg.SpanLog(capacity=16)
            cur.record("s", 1, 0, 0.0, 1.0)
            b = [len(cur.drain_new()), len(cur.drain_new())]
            cur.record("s", 1, 1, 0.0, 1.0)
            cur.record("s", 1, 2, 0.0, 1.0)
            b.append([e[4] for e in cur.drain_new()])
            got.append((a, slog.appended, b))
        assert got[0] == got[1]
        assert [e[4] for e in got[0][0]] == [6, 7, 8, 9]

    def test_tracing_ctx_arms_exports_and_restores(self):
        assert not tspans.armed()
        with tspans.tracing(export=True) as slog:
            assert tspans.armed() and tspans.log() is slog
            assert os.environ.get("DDL_TORCH_TRACE")
            t = tspans.t0()
            assert t > 0.0
            tspans.record("stage", 3, 7, t)
        assert not tspans.armed()
        assert "DDL_TORCH_TRACE" not in os.environ
        (ev,) = slog.events()
        assert ev[2:5] == ("stage", 3, 7)

    def test_stage_totals_equal_the_reference(self):
        rng = np.random.default_rng(2)
        totals = []
        for pkg in (tspans, jspans):
            slog = pkg.SpanLog()
            r = np.random.default_rng(2)
            for _ in range(50):
                t0 = float(r.uniform(0, 10))
                dur = None if r.random() < 0.2 else float(r.uniform(0, 1))
                slog.record(str(r.choice(tspans.STAGES)), 1, 0, t0,
                            None if dur is None else t0 + dur)
            totals.append(slog.stage_totals())
        assert totals[0] == totals[1] and rng is not None


class TestChromeTrace:
    def _events(self, seed):
        rng = np.random.default_rng(seed)
        evs = []
        for _ in range(60):
            t0 = float(rng.uniform(0, 5))
            t1 = None if rng.random() < 0.25 else t0 + float(rng.uniform(0, .2))
            pidx = None if rng.random() < 0.1 else int(rng.integers(1, 3))
            seq = None if pidx is None else int(rng.integers(0, 6))
            stage = str(rng.choice(list(tspans.STAGES) + ["custom.stage"]))
            evs.append((t0, t1, stage, pidx, seq, int(rng.choice([100, 200]))))
        return evs

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_events_same_json(self, seed):
        evs = self._events(seed)
        got = json.dumps(tobs.chrome_trace(evs), sort_keys=True)
        assert got == json.dumps(jobs.chrome_trace(evs), sort_keys=True)
        flows = [e for e in json.loads(got)["traceEvents"] if e["ph"] in "sf"]
        assert flows  # two pids: some windows cross

    def test_flow_stitch_only_for_cross_pid_windows(self, tmp_path):
        evs = [
            (0.0, 0.1, "producer.fill", 1, 5, 100),
            (0.1, 0.2, "producer.commit", 1, 5, 100),
            (0.25, 0.3, "consumer.acquire", 1, 5, 200),
            (0.31, None, "consumer.yield", 1, 5, 200),
            (0.0, 0.1, "consumer.acquire", 2, 0, 200),
        ]
        tr = tobs.chrome_trace(evs)
        flows = [e for e in tr["traceEvents"] if e["ph"] in ("s", "f")]
        s, f = sorted(flows, key=lambda e: e["ph"], reverse=True)
        assert (s["pid"], f["pid"]) == (100, 200)
        assert s["id"] == f["id"] == (1 << 32) | 5
        path = str(tmp_path / "trace.json")
        tobs.write_chrome_trace(evs, path)
        with open(path) as fh:
            assert json.load(fh) == json.loads(json.dumps(tr))


# -- flight recorder -----------------------------------------------------------


def _cli(main, path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["dump", path])
    return rc, buf.getvalue()


class TestFlightRecorder:
    def test_ring_is_bounded(self):
        rec = trec.FlightRecorder(capacity=8)
        for i in range(100):
            rec.note("counter", "x", float(i))
        assert len(rec.events()) == 8 and rec.noted == 100

    def test_metric_tap_feeds_ring(self, tmp_path):
        with trec.armed(directory=str(tmp_path)) as rec:
            m = tobsv.Metrics()
            m.incr("a.b")
            m.set_gauge("c.d", 2.0)
            m.observe("e.f", 0.5)
            m.add_time("g.h", 0.1)
        assert {e[1] for e in rec.events()} == {"counter", "gauge", "observe",
                                               "timer"}
        m.incr("a.b")  # disarmed: the tap is gone
        assert len(rec.events()) == 4

    def test_dump_budget_and_disarmed(self, tmp_path):
        rec = trec.FlightRecorder(directory=str(tmp_path))
        paths = [rec.dump("r", metrics=tobsv.Metrics())
                 for _ in range(trec.MAX_DUMPS + 3)]
        assert sum(p is not None for p in paths) == trec.MAX_DUMPS
        assert trec.flight_dump("x") is None

    def _dump(self, pkg_rec, pkg_obsv, directory):
        with pkg_rec.armed(directory=directory) as rec:
            rec.note("span", "consumer.acquire", 0.012, producer_idx=1, seq=4)
            rec.note("span", "producer.commit", 0.003, producer_idx=1, seq=4)
            rec.note("counter", "integrity.replays", 1.0)
            m = pkg_obsv.Metrics()
            m.incr("integrity.corrupt_windows")
            return pkg_rec.flight_dump(
                "integrity.corrupt_window", producer_idx=1, seq=4,
                metrics=m, extra={"note": "hi"})

    def test_dumps_load_in_both_tools(self, tmp_path):
        from ddl_tpu.obs.__main__ import main as jmain
        from ddl_tpu_torch.obs.__main__ import main as tmain

        tpath = self._dump(trec, tobsv, str(tmp_path / "t"))
        jpath = self._dump(jrec, jobsv, str(tmp_path / "j"))
        with open(tpath) as fh:
            trecord = json.load(fh)
        with open(jpath) as fh:
            jrecord = json.load(fh)
        assert trecord["version"] == jrecord["version"] == trec.DUMP_VERSION
        assert set(trecord) == set(jrecord)
        assert trecord["window"] == jrecord["window"] == {"producer_idx": 1,
                                                          "seq": 4}
        assert tobs.convert(jrecord) == jrecord
        for path in (tpath, jpath):
            (rc_t, out_t), (rc_j, out_j) = _cli(tmain, path), _cli(jmain, path)
            assert rc_t == rc_j == 0
            assert out_t == out_j
            assert "producer_idx=1 seq=4" in out_t
            assert "consumer.acquire" in out_t

    def test_cli_refuses_newer_version(self, tmp_path):
        from ddl_tpu_torch.obs.__main__ import main as tmain

        p = tmp_path / "future.json"
        p.write_text(json.dumps({"version": 999, "events": []}))
        with pytest.raises(SystemExit):
            tmain(["dump", str(p)])
        with pytest.raises(ValueError):
            tobs.convert({"version": 999, "events": []})

    def test_module_cli_and_trace(self, tmp_path):
        """``python -m ddl_tpu_torch.obs dump`` exits 0 on a dump; ``trace``
        re-exports its spans as a Chrome trace."""
        path = self._dump(trec, tobsv, str(tmp_path))
        env = dict(os.environ, PYTHONPATH=REPO)
        out = subprocess.run(
            [sys.executable, "-m", "ddl_tpu_torch.obs", "dump", path],
            capture_output=True, text=True, env=env, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "integrity.corrupt_window" in out.stdout
        from ddl_tpu_torch.obs.__main__ import main as tmain

        trace = str(tmp_path / "t.json")
        with contextlib.redirect_stdout(io.StringIO()):
            assert tmain(["trace", path, "-o", trace]) == 0
        with open(trace) as fh:
            assert any(e.get("name") == "consumer.acquire"
                       for e in json.load(fh)["traceEvents"])

    def test_spawned_process_arms_from_env(self, tmp_path):
        env = dict(os.environ, PYTHONPATH=REPO, DDL_TORCH_FLIGHT="64",
                   DDL_TORCH_FLIGHT_DIR=str(tmp_path), DDL_TORCH_TRACE="128")
        code = ("from ddl_tpu_torch.obs import recorder, spans; "
                "r = recorder.armed_recorder(); "
                "print(r.capacity, r.directory, spans.log().capacity)")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, env=env, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["64", str(tmp_path), "128"]

    def test_lock_order_inversion_dumps(self, tmp_path):
        from ddl_tpu_torch import concurrency

        with trec.armed(directory=str(tmp_path)) as rec:
            with concurrency.sanitized() as san:
                outer = concurrency.named_lock("staging.pool")
                inner = concurrency.named_lock("transport.connection")
                with outer, inner:
                    pass
        assert san.violations
        assert rec.dumps == 1
        with open(rec.dumped_paths[0]) as fh:
            assert json.load(fh)["reason"] == (
                "lockorder.inversion.staging.pool->transport.connection")

    def test_watchdog_failure_dumps(self, tmp_path):
        from ddl_tpu_torch.watchdog import Watchdog

        class Dead:
            def is_alive(self):
                return False

        class Workers:
            threads = [Dead()]
            processes = []

            class connection:
                rings = []

        failed = threading.Event()
        with trec.armed(directory=str(tmp_path)) as rec:
            wd = Watchdog(Workers(), poll_interval_s=0.01,
                          on_failure=lambda r: failed.set(),
                          metrics=tobsv.Metrics())
            with wd:
                assert failed.wait(10)
        with open(rec.dumped_paths[0]) as fh:
            record = json.load(fh)
        assert record["reason"] == "watchdog.failure"
        assert record["window"]["producer_idx"] == 1


# -- report merging -----------------------------------------------------------


class TestReportMerger:
    def _reports(self, seed):
        """(producer_idx, report_idx, pid, counters, hist values), a
        sequence with stale repeats and a respawned incarnation."""
        rng = np.random.default_rng(seed)
        seq = []
        for step in range(12):
            idx = int(rng.integers(0, 2))
            rep = int(rng.integers(1, 6))
            pid = 111 if step < 9 else 222
            counters = {"producer.windows": float(rng.integers(1, 50)),
                        "producer.bytes": float(rng.integers(1, 1 << 20))}
            seq.append((idx, rep, pid, counters,
                        rng.lognormal(-5, 1, 20).tolist()))
        return seq

    def _merge(self, pkg_obsv, merger_cls, reports, convert=None):
        m = pkg_obsv.Metrics()
        merger = merger_cls(m)
        for r in reports:
            merger.apply(convert(r) if convert else r)
        return (_no_clock(m.snapshot()), merger.fence_state(),
                m.adopted_prefixes(),
                m.quantile("producer.0.producer.fill_s", 0.99))

    @pytest.mark.parametrize("seed", [0, 3])
    def test_same_sequence_same_merge(self, seed):
        from ddl_tpu import types as jtypes
        from ddl_tpu_torch import types as ttypes

        reports = []
        for idx, rep, pid, counters, vals in self._reports(seed):
            src = jobsv.Metrics()
            for k, v in counters.items():
                src.incr(k, v)
            for v in vals:
                src.observe("producer.fill_s", v)
            reports.append(jtypes.ObsReport(
                producer_idx=idx, report_idx=rep, pid=pid,
                snapshot=src.snapshot(), hists=src.hist_state(), spans=[]))
        got = self._merge(tobsv, tobs.ReportMerger, reports,
                          convert=tobs.convert)
        want = self._merge(jobsv, jobs.ReportMerger, reports)
        assert got == want
        assert got[2] == ["producer.0.", "producer.1."]
        assert isinstance(tobs.convert(reports[0]), ttypes.ObsReport)

    def test_adopt_and_fence(self):
        from ddl_tpu_torch.types import ObsReport

        def rep(idx, report_idx, counters, pid=1):
            m = tobsv.Metrics()
            for k, v in counters.items():
                m.incr(k, v)
            return ObsReport(producer_idx=idx, report_idx=report_idx, pid=pid,
                             snapshot=m.snapshot(), hists=m.hist_state())

        m = tobsv.Metrics()
        merger = tobs.ReportMerger(m)
        assert merger.apply(rep(0, 1, {"producer.windows": 4}))
        assert merger.apply(rep(0, 2, {"producer.windows": 9}))
        assert not merger.apply(rep(0, 1, {"producer.windows": 4}))
        assert m.counter("producer.0.producer.windows") == 9
        assert m.counter("obs.reports_stale") == 1
        assert merger.apply(rep(0, 1, {"producer.windows": 2}, pid=2))
        assert m.counter("producer.0.producer.windows") == 2
        assert m.prefixed("producer.0.")["producer.windows"] == 2


def test_control_router_hands_reports_to_the_loader_and_keeps_acks():
    """The ack router keeps every ObsReport for the loader, and taking the
    reports never takes an ack."""
    from ddl_tpu_torch.transport.connection import ConsumerConnection, ThreadChannel
    from ddl_tpu_torch.types import ControlAck, ObsReport

    cons, prod = ThreadChannel.pair()
    conn = ConsumerConnection([cons])
    seen = []
    conn.note_ack = lambda ack: seen.append(ack) or True
    for i in range(3):
        prod.send(ObsReport(0, i + 1, 7, {"n": float(i)}))
        prod.send(ControlAck(seq=i, incarnation=0, producer_idx=1))
    assert conn.take_obs_reports() == []
    assert conn.drain_acks() == 3
    assert [a.seq for a in seen] == [0, 1, 2]
    got = conn.take_obs_reports()
    assert [r.report_idx for r in got] == [1, 2, 3]
    assert conn.take_obs_reports() == []


# -- the streams ----------------------------------------------------------------


DATA = np.arange(64 * 6, dtype=np.float32).reshape(64, 6)


def _torch_stream(metrics, n_epochs=4, crcs=None, mode="thread", keys=None,
                  admission=None):
    from ddl_tpu_torch import DistributedDataLoader, Marker, distributed_dataloader
    from ddl_tpu_torch.readers import ArrayProducer

    @distributed_dataloader(n_producers=2, mode=mode, pin_memory=False)
    def main(env):
        loader = DistributedDataLoader(
            ArrayProducer(DATA, window_size=8, splits=(5, 1)), batch_size=2,
            connection=env.connection, n_epochs=n_epochs, output="device",
            device="cpu", metrics=metrics)
        if admission is not None:
            loader.bind_admission(admission)
        for win in loader.windows():
            if crcs is not None:
                crcs.append(zlib.crc32(win.numpy().tobytes()))
            if keys is not None:
                keys.append(loader.last_window_key())
            loader.mark(Marker.END_OF_EPOCH)
        loader.drain_obs_reports(timeout_s=5.0 if mode == "process" else 0.0,
                                 wait_for_all=mode == "process")
        loader.shutdown()

    main()


def _jax_stream(metrics, n_epochs=4, crcs=None, admission=None):
    from ddl_tpu import DistributedDataLoader, Marker, distributed_dataloader
    from ddl_tpu.readers import ArrayProducer

    @distributed_dataloader(n_producers=2, mode="thread")
    def main(env):
        loader = DistributedDataLoader(
            ArrayProducer(DATA, window_size=8, splits=(5, 1)), batch_size=2,
            connection=env.connection, n_epochs=n_epochs, output="jax",
            metrics=metrics)
        if admission is not None:
            loader.bind_admission(admission)
        for win in loader.windows():
            if crcs is not None:
                crcs.append(zlib.crc32(np.asarray(win).tobytes()))
            loader.mark(Marker.END_OF_EPOCH)
        loader.shutdown()

    main()


LIFECYCLE = ("producer.fill", "producer.commit", "consumer.acquire",
             "ingest.transfer", "consumer.yield", "consumer.release")


class TestThreadE2E:
    @pytest.mark.parametrize("run", range(3))
    def test_armed_stream_records_keyed_lifecycle_spans(self, run):
        keys = []
        with tspans.tracing() as slog:
            _torch_stream(tobsv.Metrics(), keys=keys)
        by_key = defaultdict(set)
        for e in slog.events():
            by_key[(e[3], e[4])].add(e[2])
        assert keys == [(1, 0), (2, 0), (1, 1), (2, 1)]
        # Every served window has every stage, its commit span included:
        # the commit span is recorded before the slot is published.
        for key in keys:
            assert set(LIFECYCLE) <= by_key[key], (key, by_key[key])

    def test_arming_never_changes_bytes(self, tmp_path):
        armed, plain, ref = [], [], []
        with tspans.tracing(), trec.armed(directory=str(tmp_path)):
            _torch_stream(tobsv.Metrics(), crcs=armed)
        _torch_stream(tobsv.Metrics(), crcs=plain)
        _jax_stream(jobsv.Metrics(), crcs=ref)
        assert armed and armed == plain == ref

    def test_window_latency_histogram_feeds_report(self):
        from ddl_tpu_torch.ingest import north_star_report

        m = tobsv.Metrics()
        with tspans.tracing():
            _torch_stream(m)
            r = north_star_report(m)
        assert r["window_latency_p99"] >= r["window_latency_p50"] > 0.0
        assert r["stage_breakdown"]["acquire_wait"] >= 0.0
        assert r["stage_breakdown"]["span.consumer.acquire"] > 0.0


class TestProcessStitched:
    def test_process_spans_stitch_and_registries_merge(self, monkeypatch,
                                                       tmp_path):
        monkeypatch.setenv("DDL_TORCH_OBS_SHIP_EVERY", "2")
        m, crcs, plain = tobsv.Metrics(), [], []
        with tspans.tracing(export=True) as slog:
            _torch_stream(m, n_epochs=8, mode="process", crcs=crcs)
        _torch_stream(tobsv.Metrics(), n_epochs=8, crcs=plain)
        assert crcs == plain  # arming in PROCESS mode changes no byte
        evs = slog.events()
        assert len({e[5] for e in evs}) >= 3  # the consumer and 2 producers
        by_window, stages = defaultdict(set), defaultdict(set)
        for e in evs:
            if e[3] is not None:
                by_window[(e[3], e[4])].add(e[5])
                stages[(e[3], e[4])].add(e[2])
        crossing = [k for k, v in by_window.items() if len(v) >= 2]
        assert crossing
        for k in crossing:
            assert {"producer.commit", "consumer.acquire"} <= stages[k]
        path = str(tmp_path / "stitched.json")
        tobs.write_chrome_trace(evs, path)
        with open(path) as fh:
            trace = json.load(fh)["traceEvents"]
        starts = {e["id"] for e in trace if e["ph"] == "s"}
        finishes = {e["id"] for e in trace if e["ph"] == "f"}
        assert starts and starts == finishes
        assert m.counter("obs.reports_applied") >= 2
        assert m.adopted_prefixes() == ["producer.0.", "producer.1."]
        for idx in (0, 1):
            assert m.counter(f"producer.{idx}.producer.windows") > 0
        assert m.prefixed("producer.0.")["producer.bytes"] > 0


# -- chaos: a corrupt window leaves a named flight record -------------------------


class TestChaosFlightRecord:
    def _named(self, rec):
        named = []
        for path in rec.dumped_paths:
            with open(path) as fh:
                record = json.load(fh)
            if record["window"]["seq"] is not None:
                named.append(record)
        return named

    def test_seeded_corruption_dumps_the_references_window(self, tmp_path):
        from ddl_tpu import faults as jfaults
        from ddl_tpu_torch import faults as tfaults

        out = {}
        for name, faults, rec_mod, obsv, stream in (
                ("torch", tfaults, trec, tobsv, _torch_stream),
                ("jax", jfaults, jrec, jobsv, _jax_stream)):
            m, crcs = obsv.Metrics(), []
            # Producer 1's second commit: one window, whichever producer
            # thread commits first.
            plan = faults.FaultPlan([faults.FaultSpec(
                "producer.commit", faults.FaultKind.RING_CORRUPTION, at=2,
                param=8, producer_idx=1)], seed=3)
            with rec_mod.armed(directory=str(tmp_path / name)) as rec:
                with faults.armed(plan):
                    stream(m, n_epochs=4, crcs=crcs)
            assert plan.fired
            assert m.counter("integrity.corrupt_windows") >= 1
            named = self._named(rec)
            assert len(named) == 1, [r["reason"] for r in named]
            record = named[0]
            assert record["reason"] == "integrity.corrupt_window"
            assert record["metrics"]["integrity.corrupt_windows"] >= 1.0
            reasons = [json.load(open(p))["reason"] for p in rec.dumped_paths]
            assert "fault.producer.commit.ring_corruption" in reasons
            out[name] = (record["window"], crcs)
        assert out["torch"][0] == out["jax"][0] == {"producer_idx": 1,
                                                     "seq": 1}
        clean = []
        _torch_stream(tobsv.Metrics(), crcs=clean)
        assert out["torch"][1] == clean == out["jax"][1]

    def test_preemption_notice_dumps_at_poll_not_in_notify(self, tmp_path):
        from ddl_tpu_torch.resilience import PreemptionGuard

        with trec.armed(directory=str(tmp_path)) as rec:
            guard = PreemptionGuard(deadline_s=5.0, metrics=tobsv.Metrics())
            guard.notify("unit")
            assert rec.dumps == 0
            assert guard.poll() is True
            assert rec.dumps == 1
            guard.poll()
            assert rec.dumps == 1
        with open(rec.dumped_paths[0]) as fh:
            record = json.load(fh)
        assert record["reason"] == "resilience.preemption_notice"
        assert record["extra"]["grace_s"] == 5.0


# -- admission waits ---------------------------------------------------------------


class _Gate:
    """An admission gate whose grants take a seeded 1-6 ms each; a
    non-blocking probe is refused like a window not committed yet."""

    def __init__(self, stall_error, seed=0):
        self._stall = stall_error
        self._rng = np.random.default_rng(seed)
        self.waits, self.served = [], []

    def admit(self, timeout_s):
        if timeout_s <= 0:
            raise self._stall("probe")
        t0 = time.monotonic()
        time.sleep(float(self._rng.uniform(1e-3, 6e-3)))
        self.waits.append(time.monotonic() - t0)

    def note_served(self, nbytes):
        self.served.append(nbytes)


class TestAdmissionP99Agreement:
    def test_report_p99s_equal_the_reference(self):
        from ddl_tpu.ingest import north_star_report as jreport
        from ddl_tpu_torch.ingest import north_star_report as treport

        waits = np.random.default_rng(4).lognormal(-4.5, 0.6, 200)
        reports = []
        for pkg, report in ((tobsv, treport), (jobsv, jreport)):
            m = pkg.Metrics()
            for w in waits:
                m.observe("serve.admission_wait", float(w))
                m.observe("ingest.t0.admission_wait", float(w))
            reports.append(report(m))
        p99 = float(np.percentile(waits, 99))
        t, j = reports
        assert t["admission_wait_p99"] == j["admission_wait_p99"]
        assert t["serve_tenant_admission_p99"] == j["serve_tenant_admission_p99"]
        assert p99 / 1.8 <= t["admission_wait_p99"] <= p99 * 1.8
        assert p99 / 1.8 <= t["serve_tenant_admission_p99"]["t0"] <= p99 * 1.8

    def test_bound_gate_feeds_admission_histogram_and_spans(self):
        from ddl_tpu.exceptions import StallTimeoutError as JStall
        from ddl_tpu_torch.exceptions import StallTimeoutError as TStall

        m, gate, keys = tobsv.Metrics(), _Gate(TStall), []
        with tspans.tracing() as slog:
            _torch_stream(m, admission=gate, keys=keys, n_epochs=6)
        jm, jgate = jobsv.Metrics(), _Gate(JStall)
        _jax_stream(jm, admission=jgate, n_epochs=6)
        # One grant per served window, on both packages.
        assert len(gate.waits) == len(jgate.waits) == 6
        assert gate.served == jgate.served
        h = m.histogram("consumer.admission_wait")
        assert h.count == 6
        p99 = float(np.percentile(gate.waits, 99))
        assert p99 / 1.8 <= m.quantile("consumer.admission_wait", 0.99) \
            <= p99 * 1.8
        admitted = {(e[3], e[4]) for e in slog.events()
                    if e[2] == "consumer.admission"}
        assert set(keys) == admitted


# -- north_star_report ---------------------------------------------------------------


def _feed(m, seed):
    rng = np.random.default_rng(seed)
    names = ["consumer.windows", "consumer.samples", "ingest.bytes",
             "staging.pool_hits", "integrity.replays", "cache.hits",
             "ici.windows", "wire.decoded_windows", "obs.flight_dumps",
             "trainer.fused_windows", "tune.cost_source.measured"]
    timers = ["ingest.stage_copy", "ingest.transfer", "consumer.wait",
              "trainer.window_wait", "ici.fanout", "resilience.drain"]
    gauges = ["staging.queue_depth", "cache.resident_bytes", "serve.tenants",
              "serve.stall.a", "ici.slots_in_flight"]
    for _ in range(200):
        kind = rng.integers(0, 4)
        if kind == 0:
            m.incr(str(rng.choice(names)), float(rng.integers(1, 100)))
        elif kind == 1:
            m.add_time(str(rng.choice(timers)), float(rng.uniform(0, 0.1)))
        elif kind == 2:
            m.set_gauge(str(rng.choice(gauges)), float(rng.uniform(0, 10)))
        else:
            m.observe(str(rng.choice(["consumer.window_latency",
                                      "serve.admission_wait",
                                      "ingest.b.admission_wait"])),
                      float(rng.lognormal(-5, 1)))


@pytest.mark.parametrize("seed", [0, 1])
def test_north_star_report_equals_the_references(seed):
    from ddl_tpu.ingest import north_star_report as jreport
    from ddl_tpu_torch.ingest import north_star_report as treport

    tm, jm = tobsv.Metrics(), jobsv.Metrics()
    _feed(tm, seed)
    _feed(jm, seed)
    t, j = treport(tm, link_bytes_per_sec=1e9), jreport(jm, link_bytes_per_sec=1e9)
    assert set(t) == set(j)
    skip = CLOCK_KEYS + DEFAULT_REGISTRY_KEYS + ("bandwidth_utilization",)
    for key in t:
        if key not in skip:
            assert t[key] == j[key], key
    assert t["window_latency_p99"] > 0.0
