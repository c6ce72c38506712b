"""The cases of ``tests/test_tune.py`` written against a package root
(``ROOT``, set by ``tests/torch_twins.load``): ``tests/test_torch_tune.py``
runs each against the JAX package and the port and holds what they saw
equal.  Cases return their observables (``Decision`` records field by
field, overlays, knob values, served bytes).

Where the packages differ by design: env knobs are ``DDL_TPU_*`` in the
JAX package and ``DDL_TORCH_*`` in the port (``PFX``); the port's
``PrefetchIterator`` takes its ``put`` first (``_prefetch_iter``); and
the port carries the distribution decision to the caller's
``distribute=`` (``TunedConfig.distribute``) where the JAX package
exports ``DDL_TPU_DISTRIBUTE`` — the decision record is the same."""

import importlib
import os

import numpy as np
import pytest

ROOT = globals().get("ROOT", "ddl_tpu_torch")
TORCH = ROOT == "ddl_tpu_torch"
#: The package's env-knob prefix.
PFX = "DDL_TORCH_" if TORCH else "DDL_TPU_"
_pkg = importlib.import_module(ROOT)
DataProducerOnInitReturn = _pkg.DataProducerOnInitReturn
DistributedDataLoader = _pkg.DistributedDataLoader
Marker = _pkg.Marker
ProducerFunctionSkeleton = _pkg.ProducerFunctionSkeleton
distributed_dataloader = _pkg.distributed_dataloader
envspec = importlib.import_module(f"{ROOT}.envspec")
wire = importlib.import_module(f"{ROOT}.wire")
_cl = importlib.import_module(f"{ROOT}.cluster")
ClusterView, HostInfo, LinkCosts = _cl.ClusterView, _cl.HostInfo, \
    _cl.LinkCosts
_placement = importlib.import_module(f"{ROOT}.cluster.placement")
costs_drift, replan_on_drift = _placement.costs_drift, \
    _placement.replan_on_drift
LoaderConfig = importlib.import_module(f"{ROOT}.config").LoaderConfig
_env = importlib.import_module(f"{ROOT}.env")
_export_tune_knobs = (_env.export_tune_knobs if TORCH
                      else _env._export_tune_knobs)
DDLError = importlib.import_module(f"{ROOT}.exceptions").DDLError
_ingest = importlib.import_module(f"{ROOT}.ingest")
DeviceIngestor, PrefetchIterator, north_star_report = (
    _ingest.DeviceIngestor, _ingest.PrefetchIterator,
    _ingest.north_star_report)
_rec = importlib.import_module(f"{ROOT}.obs.recorder")
FlightRecorder, armed = _rec.FlightRecorder, _rec.armed
Metrics = importlib.import_module(f"{ROOT}.observability").Metrics
_staging = importlib.import_module(f"{ROOT}.staging")
StagingPool, TransferExecutor = _staging.StagingPool, \
    _staging.TransferExecutor
_tune = importlib.import_module(f"{ROOT}.tune")
Calibrator = _tune.Calibrator
ControllerPolicy = _tune.ControllerPolicy
KnobController = _tune.KnobController
TunableKnob = _tune.TunableKnob
env_knob = _tune.env_knob
prefetch_knob = _tune.prefetch_knob
staging_pool_knob = _tune.staging_pool_knob
staging_queue_knob = _tune.staging_queue_knob
wire_dtype_knob = _tune.wire_dtype_knob


def _prefetch_iter(it, depth=None):
    """A PrefetchIterator over an inline put onto the package's default
    device (the CPU in the port)."""
    if not TORCH:
        return PrefetchIterator(it, DeviceIngestor(), depth=depth)
    ing = DeviceIngestor(device="cpu")
    return PrefetchIterator(it, lambda b: ing.hand_off(ing.put_window(b)),
                            depth=depth, ingestor=ing)


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------


class _Clock:
    """A hand-advanced monotonic clock (the controller's fake time)."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _state_knob(state, name="prefetch_depth", lo=1, hi=16):
    return TunableKnob(
        name=name,
        getter=lambda: state["v"],
        setter=lambda v: state.__setitem__("v", v),
        lo=lo, hi=hi,
    )


def _make_controller(state=None, policy=None, **kw):
    """Controller on a fake clock with injectable signal/work feeds.

    Returns (controller, clock, sig, work, state): drive a test by
    setting ``sig["v"]`` / bumping ``work["v"]`` / advancing ``clock.t``
    and calling ``ctrl.step()``.
    """
    state = state if state is not None else {"v": 2}
    clock = _Clock()
    sig = {"v": 0.0}
    work = {"v": 0.0}
    ctrl = KnobController(
        [_state_knob(state)],
        policy=policy or ControllerPolicy(
            up_stall_fraction=0.25, down_stall_fraction=0.05,
            sustain_s=1.0, cooldown_s=2.0, revert_tol=0.05,
        ),
        metrics=Metrics(),
        clock=clock,
        signal=lambda: {
            "stall_fraction": sig["v"], "window_latency_p99": 0.0,
        },
        work=lambda: work["v"],
        **kw,
    )
    return ctrl, clock, sig, work, state


def _decisions(decisions):
    """Decision records without their signals (the measured wire stats'
    break-even rates are timings); the reasons name the link's rate,
    which the cases declare."""
    return [(d.knob, d.old, d.new, d.cost_source, d.reason)
            for d in decisions]


def _drive(ctrl, clock, work, times, rate=200.0):
    """Step at each time, advancing work at a CONSTANT ``rate`` so the
    never-worse guard sees steady throughput regardless of how the
    steps are spaced; returns the action list."""
    out = []
    for t in times:
        dt = max(0.0, t - clock.t)
        work["v"] += rate * dt
        clock.t = t
        out.append(ctrl.step())
    return out


STATS = {
    "int8": {
        "ratio": 0.25,
        "encode_bytes_per_s": 1e9,
        "decode_bytes_per_s": 1e9,
    },
    "bf16": {
        "ratio": 0.5,
        "encode_bytes_per_s": 4e9,
        "decode_bytes_per_s": 4e9,
    },
}


def island_view():
    """test_cluster's placement fixture: islands pair roles across the
    naive round-robin so reordering wins under the cost model."""
    hosts = [HostInfo(h, loader_ranks=(h + 1,)) for h in (0, 1, 2, 3)] + [
        HostInfo(h, trainer_ranks=(h - 4,)) for h in (4, 5, 6, 7)
    ]
    return ClusterView.bootstrap(hosts, n_shards=8)


def island_costs(intra=8e9, cross=1e9):
    return LinkCosts.islands([[0, 5], [1, 4], [2, 7], [3, 6]], intra, cross)


# ---------------------------------------------------------------------------
# Units: break-even economics (the Calibrator/probe_wire shared core)
# ---------------------------------------------------------------------------


class TestBreakEven:
    def test_threshold_math(self):
        # (1 - ratio) / (1/enc + 1/dec): the link speed below which
        # paying the codec CPU beats moving raw bytes.
        be = wire.break_even_table(STATS)
        assert be["int8"] == pytest.approx(0.75 / 2e-9)
        assert be["bf16"] == pytest.approx(0.5 / 5e-10)

    def test_hopeless_and_shard_entries_skipped(self):
        stats = dict(STATS)
        stats["gzip"] = {
            "ratio": 1.2, "encode_bytes_per_s": 1e9,
            "decode_bytes_per_s": 1e9,
        }
        stats["shard"] = "0/256x1024"  # probe_wire passthrough entry
        be = wire.break_even_table(stats)
        assert set(be) == {"int8", "bf16"}

    def test_link_filter_drops_already_won_links(self):
        # At 1e9 B/s the link beats every threshold: nothing worth
        # flipping on.  At 1e8 both formats still pay.
        assert wire.break_even_table(STATS, link_bytes_per_s=1e9) == {}
        assert set(
            wire.break_even_table(STATS, link_bytes_per_s=1e8)
        ) == {"int8", "bf16"}

    def test_pick_slow_link_prefers_deepest_compression(self):
        assert wire.pick_wire_format(STATS, 1e7) == "int8"

    def test_pick_fast_link_keeps_raw(self):
        assert wire.pick_wire_format(STATS, 1e11) == "raw"

    def test_measure_stats_expired_deadline_is_empty(self):
        import time as _time

        sample = np.zeros((16, 16), np.float32)
        stats = wire.measure_wire_stats(
            sample, deadline=_time.monotonic() - 1.0
        )
        assert stats == {}

    def test_measure_stats_shape(self):
        rng = np.random.default_rng(0)
        sample = rng.integers(0, 32, (64, 64)).astype(np.float32)
        stats = wire.measure_wire_stats(sample)
        assert set(stats) == {"bf16", "int8"}
        for st in stats.values():
            assert 0.0 < st["ratio"] < 1.0
            assert st["encode_bytes_per_s"] > 0
            assert st["decode_bytes_per_s"] > 0
        assert "max_rel_drift" in stats["int8"]


# ---------------------------------------------------------------------------
# Units: Calibrator (deadline budget + provenance)
# ---------------------------------------------------------------------------


class TestCalibrator:
    def test_zero_budget_decides_everything_default(self):
        m = Metrics()
        cal = Calibrator(
            deadline_s=0.0,
            hosts=[0, 1],
            transfer=lambda a, b, p: None,
            distribute_probe=lambda: {"ici": 2e9},
            metrics=m,
            clock=_Clock(),
        )
        tuned = cal.calibrate(LoaderConfig())
        assert tuned.deadline_hit
        assert tuned.overlay == {}
        assert tuned.env == {}
        # Every knob still judged — absence of evidence is auditable.
        assert {d.knob for d in tuned.decisions} == {
            "wire_dtype", "distribute", "prefetch_depth", "staging_queue",
        }
        assert all(d.cost_source == "default" for d in tuned.decisions)
        srcs = tuned.cost_sources()
        assert srcs["default"] == len(tuned.decisions)
        assert srcs["measured"] == srcs["declared"] == 0
        assert m.counter("tune.cost_source.default") == len(tuned.decisions)
        return _decisions(tuned.decisions)

    def test_declared_slow_link_flips_wire(self):
        cal = Calibrator(
            deadline_s=30.0,
            link_costs=LinkCosts({(0, 1): 8e6}, source="declared"),
            metrics=Metrics(),
        )
        tuned = cal.calibrate(LoaderConfig(wire_dtype="raw"))
        d = next(d for d in tuned.decisions if d.knob == "wire_dtype")
        assert d.cost_source == "declared"
        assert d.new == "int8"
        assert tuned.overlay["wire_dtype"] == "int8"
        # The evidence rides the decision: the measured break-even
        # table vs the declared bottleneck link.
        assert d.signals["link_bytes_per_s"] == pytest.approx(8e6)
        assert any(k.startswith("break_even.") for k in d.signals)
        assert not tuned.deadline_hit
        return _decisions(tuned.decisions), tuned.overlay

    def test_measured_probe_on_fast_link_keeps_raw(self):
        m = Metrics()
        cal = Calibrator(
            deadline_s=30.0,
            hosts=[0, 1],
            transfer=lambda a, b, payload: None,  # "instant" fabric
            metrics=m,
        )
        tuned = cal.calibrate(LoaderConfig(wire_dtype="raw"))
        d = next(d for d in tuned.decisions if d.knob == "wire_dtype")
        assert d.cost_source == "measured"
        assert d.new == "raw"
        assert "wire_dtype" not in tuned.overlay
        assert m.counter("tune.cost_source.measured") >= 1
        return (d.knob, d.old, d.new, d.cost_source), tuned.overlay

    def test_distribute_probe_measured_pick_and_export(self, monkeypatch):
        if not TORCH:
            monkeypatch.setenv(PFX + "DISTRIBUTE", "auto")
        cal = Calibrator(
            deadline_s=30.0,
            distribute_probe=lambda: {"ici": 2e9, "xla": 1e9},
            metrics=Metrics(),
        )
        tuned = cal.calibrate(LoaderConfig())
        d = next(d for d in tuned.decisions if d.knob == "distribute")
        assert d.cost_source == "measured"
        assert d.new == "ici"
        if TORCH:
            # The port's route is the caller's distribute= argument.
            assert tuned.env == {} and tuned.distribute == "ici"
        else:
            assert tuned.env == {PFX + "DISTRIBUTE": "ici"}
            tuned.export()
            assert os.environ[PFX + "DISTRIBUTE"] == "ici"
            assert envspec.get(PFX + "DISTRIBUTE") == "ici"
        return d

    def test_distribute_probe_failure_keeps_default(self):
        def boom():
            raise ValueError("dead mesh")

        cal = Calibrator(
            deadline_s=30.0, distribute_probe=boom, metrics=Metrics()
        )
        tuned = cal.calibrate(LoaderConfig())
        d = next(d for d in tuned.decisions if d.knob == "distribute")
        assert d.cost_source == "default"
        assert "ValueError" in d.reason
        assert PFX + "DISTRIBUTE" not in tuned.env
        assert getattr(tuned, "distribute", None) is None
        return d

    def test_starved_depth_floored_at_shipped_default(self):
        cal = Calibrator(deadline_s=30.0, metrics=Metrics())
        tuned = cal.calibrate(LoaderConfig(prefetch_depth=1))
        d = next(d for d in tuned.decisions if d.knob == "prefetch_depth")
        assert d.cost_source == "default"
        assert (d.old, d.new) == (1, 2)
        assert tuned.overlay["prefetch_depth"] == 2
        return d

    def test_operator_increase_left_alone(self):
        cal = Calibrator(deadline_s=30.0, metrics=Metrics())
        tuned = cal.calibrate(LoaderConfig(prefetch_depth=8))
        d = next(d for d in tuned.decisions if d.knob == "prefetch_depth")
        assert (d.old, d.new) == (8, 8)
        assert "prefetch_depth" not in tuned.overlay
        return d

    def test_apply_overlays_without_mutating(self):
        cal = Calibrator(
            deadline_s=30.0,
            link_costs=LinkCosts({(0, 1): 8e6}, source="declared"),
            metrics=Metrics(),
        )
        seed = LoaderConfig(wire_dtype="raw", prefetch_depth=1)
        tuned = cal.calibrate(seed)
        out = tuned.apply(seed)
        assert (out.wire_dtype, out.prefetch_depth) == ("int8", 2)
        assert (seed.wire_dtype, seed.prefetch_depth) == ("raw", 1)
        # Overlay keys the config doesn't know are skipped, not fatal.
        tuned.overlay["no_such_field"] = 1
        assert tuned.apply(seed).wire_dtype == "int8"
        return tuned.overlay

    def test_decisions_flight_recorded_and_reported(self):
        rec = FlightRecorder(capacity=256)
        with armed(rec):
            cal = Calibrator(
                deadline_s=30.0,
                link_costs=LinkCosts({(0, 1): 8e6}, source="declared"),
                metrics=Metrics(),
            )
            tuned = cal.calibrate(LoaderConfig())
        tune_events = [e for e in rec.events() if e[1] == "tune"]
        assert len(tune_events) == len(tuned.decisions)
        assert any(e[2] == "calibrate.wire_dtype" for e in tune_events)
        rep = tuned.as_report()
        for key in ("decisions", "overlay", "env", "cost_sources",
                    "budget_s", "elapsed_s", "deadline_hit"):
            assert key in rep
        assert rep["decisions"][0]["cost_source"] in (
            "measured", "declared", "default"
        )

    def test_counters_surface_in_north_star_report(self):
        m = Metrics()
        cal = Calibrator(
            deadline_s=30.0,
            link_costs=LinkCosts({(0, 1): 8e6}, source="declared"),
            metrics=m,
        )
        tuned = cal.calibrate(LoaderConfig())
        report = north_star_report(m)
        assert report["tune_decisions"] == len(tuned.decisions)
        assert report["tune_reverts"] == 0
        assert report["tune_cost_source"]["declared"] >= 1
        return (report["tune_decisions"], report["tune_reverts"],
                report["tune_cost_source"])


# ---------------------------------------------------------------------------
# Units: KnobController hysteresis / pacing / never-worse
# ---------------------------------------------------------------------------


class TestControllerUnit:
    def test_dead_band_never_acts(self):
        ctrl, clock, sig, work, state = _make_controller()
        sig["v"] = 0.15  # inside (down=0.05, up=0.25): the dead band
        actions = _drive(ctrl, clock, work, [float(t) for t in range(10)])
        assert actions == [None] * 10
        assert state["v"] == 2
        assert ctrl.decisions == []
        return actions

    def test_sustain_gates_growth(self):
        ctrl, clock, sig, work, state = _make_controller()
        sig["v"] = 0.5
        actions = _drive(ctrl, clock, work, [0.0, 0.5, 1.0])
        assert actions == [None, None, "grow"]
        assert state["v"] == 4
        d = ctrl.decisions[-1]
        assert (d.knob, d.old, d.new) == ("prefetch_depth", 2, 4)
        assert d.cost_source == "measured"
        assert d.signals["stall_fraction"] == pytest.approx(0.5)
        return actions, ctrl.decisions

    def test_dead_band_resets_sustain_timer(self):
        ctrl, clock, sig, work, state = _make_controller()
        sig["v"] = 0.5
        assert _drive(ctrl, clock, work, [0.0]) == [None]
        sig["v"] = 0.15  # dip into the dead band: the timer must reset
        assert _drive(ctrl, clock, work, [0.6]) == [None]
        sig["v"] = 0.5
        # A full sustain_s must elapse from the re-entry, not from t=0.
        assert _drive(ctrl, clock, work, [1.2, 1.8, 2.2]) == [
            None, None, "grow",
        ]
        assert state["v"] == 4

    def test_cooldown_spaces_consecutive_actions(self):
        ctrl, clock, sig, work, state = _make_controller()
        sig["v"] = 0.5  # demand never lets up; work keeps rising
        actions = _drive(
            ctrl, clock, work, [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
        )
        # Grow at t=1.0 (sustain met), then nothing until the pending
        # change is judged AND the cooldown elapses at t=3.0.
        assert actions == [None, None, "grow", None, None, None, "grow"]
        assert state["v"] == 8
        assert ctrl.metrics.counter("tune.reverts") == 0
        return actions, ctrl.decisions

    def test_never_worse_reverts_regression(self):
        ctrl, clock, sig, work, state = _make_controller()
        sig["v"] = 0.5
        assert _drive(ctrl, clock, work, [0.0, 0.5, 1.0])[-1] == "grow"
        assert state["v"] == 4
        # Throughput collapses after the change: work stops moving.
        clock.t = 3.5
        assert ctrl.step() == "revert"
        assert state["v"] == 2  # the old value is restored
        assert ctrl.metrics.counter("tune.reverts") == 1
        d = ctrl.decisions[-1]
        assert (d.old, d.new) == (4, 2)
        assert d.reason.startswith("never-worse")
        # A revert opens a fresh cooldown before the next experiment.
        assert _drive(ctrl, clock, work, [4.5]) == [None]
        assert _drive(ctrl, clock, work, [5.5]) == ["grow"]
        return ctrl.decisions

    def test_accepted_change_stands(self):
        ctrl, clock, sig, work, state = _make_controller()
        sig["v"] = 0.5
        _drive(ctrl, clock, work, [0.0, 0.5, 1.0])
        # Post-change window matches the pre-change rate: work keeps
        # rising at the same slope through the judgement.
        sig["v"] = 0.15
        assert _drive(ctrl, clock, work, [3.5])[0] is None
        assert state["v"] == 4
        assert ctrl.metrics.counter("tune.reverts") == 0
        return ctrl.decisions

    def test_idle_shrinks_newest_grown_back_to_baseline(self):
        ctrl, clock, sig, work, state = _make_controller()
        sig["v"] = 0.5
        actions = _drive(
            ctrl, clock, work, [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
        )
        assert actions.count("grow") == 2 and state["v"] == 8
        sig["v"] = 0.01  # below down_stall_fraction: idle
        actions = _drive(
            ctrl, clock, work,
            [5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0, 12.0],
        )
        shrinks = [a for a in actions if a is not None]
        assert shrinks == ["shrink", "shrink"]
        assert state["v"] == 2  # back at baseline, never below
        # Fully reclaimed: further idleness is free (no more actions).
        assert _drive(ctrl, clock, work, [15.0, 16.0, 17.0]) == [
            None, None, None,
        ]
        return ctrl.decisions

    def test_grow_stops_at_ceiling(self):
        state = {"v": 4}
        ctrl, clock, sig, work, _ = _make_controller(state=state)
        ctrl.knobs[0].hi = 4  # already at the top of its legal range
        sig["v"] = 0.9
        actions = _drive(ctrl, clock, work, [0.0, 1.0, 2.0, 3.0])
        assert actions == [None] * 4  # demand without supply
        assert state["v"] == 4
        assert ctrl.decisions == []

    def test_parity_flip_ignores_cooldown_and_is_one_way(self):
        wire_state = {"v": "int8"}
        drift = {"v": 0.0}
        ctrl, clock, sig, work, state = _make_controller(
            parity=lambda: drift["v"] or None,
            parity_tol=1e-2,
            wire_knob=TunableKnob(
                name="wire_dtype",
                getter=lambda: wire_state["v"],
                setter=lambda v: wire_state.__setitem__("v", v),
            ),
        )
        # Healthy drift: no flip (budget = 0.5 x tol = 5e-3).
        drift["v"] = 1e-3
        assert _drive(ctrl, clock, work, [0.0])[0] is None
        assert wire_state["v"] == "int8"
        # Open a cooldown window with a grow, then shrink the headroom:
        # safety outranks pacing — the flip lands inside the cooldown.
        sig["v"] = 0.5
        assert _drive(ctrl, clock, work, [0.5, 1.5])[-1] == "grow"
        drift["v"] = 6e-3
        assert _drive(ctrl, clock, work, [1.7])[0] == "wire_raw"
        assert wire_state["v"] == "raw"
        assert ctrl.report()["wire_flipped"] is True
        d = ctrl.decisions[-1]
        assert (d.knob, d.new) == ("wire_dtype", "raw")
        assert d.signals["max_rel_drift"] == pytest.approx(6e-3)
        # One-way: even if something re-enables the lossy wire, the
        # controller never flips it again (re-arming is a human call).
        wire_state["v"] = "int8"
        n = len(ctrl.decisions)
        _drive(ctrl, clock, work, [1.9, 2.1])
        assert wire_state["v"] == "int8"
        assert all(
            d.knob != "wire_dtype" for d in ctrl.decisions[n:]
        )
        return ctrl.decisions

    def test_policy_validation(self):
        with pytest.raises(DDLError):
            ControllerPolicy(up_stall_fraction=0.2, down_stall_fraction=0.5)
        with pytest.raises(DDLError):
            ControllerPolicy(sustain_s=-1.0)
        with pytest.raises(DDLError):
            ControllerPolicy(revert_tol=1.0)
        with pytest.raises(DDLError):
            ControllerPolicy(parity_headroom=0.0)

    def test_policy_from_env(self, monkeypatch):
        monkeypatch.setenv(PFX + "TUNE_SUSTAIN_S", "3.5")
        monkeypatch.setenv(PFX + "TUNE_COOLDOWN_S", "9.0")
        monkeypatch.setenv(PFX + "TUNE_REVERT_TOL", "0.1")
        pol = ControllerPolicy.from_env()
        assert pol.sustain_s == 3.5
        assert pol.cooldown_s == 9.0
        assert pol.revert_tol == 0.1
        return pol.sustain_s, pol.cooldown_s, pol.revert_tol, \
            pol.parity_headroom

    def test_report_shape(self):
        ctrl, clock, sig, work, _ = _make_controller()
        sig["v"] = 0.5
        _drive(ctrl, clock, work, [0.0, 0.5, 1.0])
        rep = ctrl.report()
        assert rep["reverts"] == 0 and rep["replans"] == 0
        assert rep["wire_flipped"] is False
        assert rep["decisions"][0]["knob"] == "prefetch_depth"
        return rep


# ---------------------------------------------------------------------------
# Units: cost drift -> placement replan
# ---------------------------------------------------------------------------


class TestDriftReplan:
    def test_costs_drift_zero_for_identical_tables(self):
        assert costs_drift(island_costs(), island_costs()) == 0.0

    def test_costs_drift_tracks_worst_link(self):
        old = LinkCosts({(0, 1): 1e9})
        new = LinkCosts({(0, 1): 2e9})
        assert costs_drift(old, new) == pytest.approx(1.0)

    def test_appeared_link_registers_as_drift(self):
        # Host 2 is new: its links price at the default in `old`, so a
        # fast measured link there is drift, not a silent skip.
        old = LinkCosts({(0, 1): 1e9}, default_bytes_per_s=1e9)
        new = LinkCosts({(0, 1): 1e9, (0, 2): 8e9})
        assert costs_drift(old, new) == pytest.approx(7.0)

    def test_replan_only_beyond_tolerance(self):
        view = island_view()
        base = island_costs()
        drifted = island_costs(intra=8e9 * 1.1)  # 10% < 25% tol
        assert replan_on_drift(view, base, drifted) is None
        flipped = LinkCosts.islands(
            [[0, 4], [1, 5], [2, 6], [3, 7]], 8e9, 1e9
        )
        plan = replan_on_drift(view, base, flipped)
        assert plan is not None
        assert plan.assignment == ((0, 4), (1, 5), (2, 6), (3, 7))
        return plan.assignment

    def test_controller_drift_leg_replans_once(self):
        clock = _Clock()
        m = Metrics()
        ctrl = KnobController(
            [],
            policy=ControllerPolicy(sustain_s=1.0, cooldown_s=2.0),
            metrics=m,
            clock=clock,
            signal=lambda: {
                "stall_fraction": 0.0, "window_latency_p99": 0.0,
            },
            work=lambda: 0.0,
            view=island_view(),
            base_costs=LinkCosts({}, default_bytes_per_s=1e9),
            costs_probe=island_costs,
        )
        assert ctrl.step() == "replan"
        assert ctrl.last_placement is not None
        assert ctrl.last_placement.reordered
        assert m.counter("tune.replans") == 1
        assert ctrl.decisions[-1].knob == "placement"
        # The fresh costs become the new baseline: no re-replan churn.
        clock.t = 10.0
        assert ctrl.step() is None
        assert m.counter("tune.replans") == 1
        return ctrl.decisions, list(ctrl.last_placement.assignment)


# ---------------------------------------------------------------------------
# Units: the knob seams (real pipeline objects)
# ---------------------------------------------------------------------------


class TestKnobSeams:
    def test_prefetch_knob_binds_live_depth(self):
        it = _prefetch_iter(iter([]), depth=4)
        knob = prefetch_knob(it)
        assert knob.read() == 4
        knob.write(9)
        assert it._depth == 9
        assert knob.write(100) == 16  # clamped to the legal ceiling
        assert knob.write(0) == 1     # and the floor
        assert it._depth == 1

    def test_prefetch_depth_env_seam(self, monkeypatch):
        monkeypatch.setenv(PFX + "PREFETCH_DEPTH", "3")
        it = _prefetch_iter(iter([]))
        assert it._depth == 3

    def test_staging_queue_knob_reclamps_worker_min_depth(self):
        ex = TransferExecutor(StagingPool(metrics=Metrics()),
                              metrics=Metrics(), max_queue=4)
        try:
            knob = staging_queue_knob(ex)
            assert knob.read() == 4
            knob.write(1)
            assert ex._max_queue == 1
            # The deadlock guard must track a shrunk bound...
            assert ex.worker_min_depth <= 1
            guard = ex.worker_min_depth
            knob.write(8)
            assert ex._max_queue == 8
            # ...and growing never silently re-raises it.
            assert ex.worker_min_depth == guard
        finally:
            ex.close()

    def test_staging_pool_knob_trims_free_lists(self):
        pool = StagingPool(metrics=Metrics(), max_per_key=8)
        bufs = [pool.acquire((4, 4), np.float32) for _ in range(3)]
        for b in bufs:
            pool.release(b)
        key = ((4, 4), np.dtype(np.float32))
        assert len(pool._free[key]) == 3
        staging_pool_knob(pool).write(1)
        assert pool.max_per_key == 1
        # Shrinking returns memory now, not on organic churn.
        assert len(pool._free[key]) == 1

    def test_wire_dtype_knob(self):
        import types

        sh = types.SimpleNamespace(wire_dtype="int8")
        knob = wire_dtype_knob(sh)
        assert knob.read() == "int8"
        knob.write("raw")
        assert sh.wire_dtype == "raw"
        sh.wire_dtype = None
        assert knob.read() == "raw"  # normalized, never None

    def test_env_knob_requires_registered_var(self):
        with pytest.raises(envspec.UnknownKnobError):
            env_knob(PFX + "PERFETCH_DEPTH")  # typo guard

    def test_env_knob_round_trip(self, monkeypatch):
        monkeypatch.setenv(PFX + "PREFETCH_DEPTH", "2")
        knob = env_knob(PFX + "PREFETCH_DEPTH", lo=1, hi=16)
        assert knob.live is False  # boot-time only by default
        assert knob.read() == 2
        knob.write(5)
        assert os.environ[PFX + "PREFETCH_DEPTH"] == "5"
        assert knob.read() == 5

    def test_export_tune_knobs_mirrors_config(self, monkeypatch):
        monkeypatch.delenv(PFX + "PREFETCH_DEPTH", raising=False)
        _export_tune_knobs(LoaderConfig(prefetch_depth=5))
        assert os.environ[PFX + "PREFETCH_DEPTH"] == "5"
        # A default-valued config states no opinion: the process's own
        # prior export is cleared, the seam falls back to the registry.
        _export_tune_knobs(LoaderConfig(prefetch_depth=2))
        assert PFX + "PREFETCH_DEPTH" not in os.environ


# ---------------------------------------------------------------------------
# E2E: a mis-tuned loader converges, byte-identically
# ---------------------------------------------------------------------------


class SeqProducer(ProducerFunctionSkeleton):
    def on_init(self, producer_idx=0, **kw):
        return DataProducerOnInitReturn(
            nData=32, nValues=4, shape=(32, 4), splits=(3, 1)
        )

    def post_init(self, my_ary, **kw):
        my_ary[:, -1] = np.arange(32)


class TestSelfTuningE2E:
    #: The knob set a correctly tuned slow-link geometry lands on.
    KNOWN_GOOD = {"wire_dtype": "int8", "prefetch_depth": 2}

    def test_calibration_converges_to_known_good_overlay(self):
        seed = LoaderConfig(wire_dtype="raw", prefetch_depth=1)
        cal = Calibrator(
            deadline_s=30.0,
            link_costs=LinkCosts({(0, 1): 8e6}, source="declared"),
            metrics=Metrics(),
        )
        tuned = cal.calibrate(seed)
        assert tuned.overlay == self.KNOWN_GOOD
        cfg = tuned.apply(seed)
        assert (cfg.wire_dtype, cfg.prefetch_depth) == ("int8", 2)

    def test_tuned_loader_stream_is_byte_identical(self):
        """A THREAD loader driven at the calibrated depth must emit
        exactly the stream the known-good reference emits — retuning a
        pacing knob may never change WHAT the consumer sees."""
        seed = LoaderConfig(wire_dtype="raw", prefetch_depth=1)
        cal = Calibrator(
            deadline_s=30.0,
            link_costs=LinkCosts({(0, 1): 8e6}, source="declared"),
            metrics=Metrics(),
        )
        tuned_depth = cal.calibrate(seed).apply(seed).prefetch_depth
        ref_depth = self.KNOWN_GOOD["prefetch_depth"]

        @distributed_dataloader(n_producers=2, mode="thread")
        def main(env):
            loader = DistributedDataLoader(
                SeqProducer(), batch_size=8, connection=env.connection,
                n_epochs=2,
                **({"output": "device", "device": "cpu"} if TORCH
                   else {"output": "jax"}),
            )
            epochs = []
            for depth in (ref_depth, tuned_depth):
                got = [
                    np.asarray(y).tobytes()
                    for _, y in loader.prefetch(depth)
                ]
                epochs.append(got)
                for _ in got:
                    loader.mark(Marker.END_OF_BATCH)
                loader.mark(Marker.END_OF_EPOCH)
            return epochs

        ref, tuned_stream = main()
        assert len(ref) == 4
        assert ref == tuned_stream
        return ref

    def test_controller_retune_never_corrupts_the_stream(self):
        """Live depth retunes mid-iteration: the controller grows a
        starved PrefetchIterator while it streams, and the output still
        matches an untouched reference run bit for bit."""
        batches = [
            np.full((8,), i, dtype=np.float32) for i in range(16)
        ]
        ref = [
            np.asarray(b).tobytes()
            for b in _prefetch_iter(iter(batches), depth=2)
        ]
        it = _prefetch_iter(iter(batches), depth=1)
        clock = _Clock()
        ctrl = KnobController(
            [prefetch_knob(it)],
            policy=ControllerPolicy(
                up_stall_fraction=0.25, down_stall_fraction=0.05,
                sustain_s=0.0, cooldown_s=0.0,
            ),
            metrics=Metrics(),
            clock=clock,
            signal=lambda: {
                "stall_fraction": 1.0, "window_latency_p99": 0.0,
            },
            work=lambda: 0.0,
        )
        out = []
        for b in it:
            out.append(np.asarray(b).tobytes())
            clock.t += 1.0
            ctrl.step()
        assert out == ref
        # The starved depth converged up to (at least) the known-good
        # floor, through the audited seam.
        assert it._depth >= self.KNOWN_GOOD["prefetch_depth"]
        assert any(d.knob == "prefetch_depth" for d in ctrl.decisions)
        return out, [(d.knob, d.old, d.new) for d in ctrl.decisions]
