"""Boot-time calibration: measured costs in, a tuned overlay out (port of
``ddl_tpu/tune/calibrate.py``).

The :class:`Calibrator` runs the economics of the operator probes — the
wire break-even table (:func:`ddl_tpu_torch.wire.break_even_table`) and
``probe_link_costs``'s pairwise bandwidth (pluggable ``transfer``, as
the placement engine consumes it) — and turns them into a
:class:`TunedConfig`: an overlay of ``LoaderConfig`` fields, env exports
for registry knobs with no config field, and the ``distribute=`` route
for :class:`~ddl_tpu_torch.ingest.DeviceIngestor` (the port has no env
knob for it; the JAX package writes ``DDL_TPU_DISTRIBUTE``).

- **Provenance.**  Every :class:`Decision` carries ``cost_source``:
  ``measured`` (a probe ran and drove the pick), ``declared`` (the caller
  supplied costs), or ``default`` (budget exhausted or no probe; the
  shipped default stands).
- **Deadline budget.**  The whole pass runs against ONE monotonic
  deadline (``DDL_TORCH_TUNE_DEADLINE_S``); each probe checks the
  remaining budget first, and the wire microbenchmark checks it between
  formats.  A probe that would overrun is skipped and its knob decided
  ``default``.
- **Audit.**  Each decision increments ``tune.decisions`` and
  ``tune.cost_source.<src>`` and lands in the flight-recorder ring
  (``("tune", "calibrate.<knob>", value)``) when armed.
"""


from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ddl_tpu_torch import envspec, wire
from ddl_tpu_torch.cluster.topology import LinkCosts, probe_link_costs
from ddl_tpu_torch.exceptions import ShutdownRequested
from ddl_tpu_torch.obs.recorder import flight_note
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics

logger = logging.getLogger("ddl_tpu_torch")

#: Provenance labels (the LinkCosts.source pattern, made universal).
COST_MEASURED = "measured"
COST_DECLARED = "declared"
COST_DEFAULT = "default"

#: Wire-stat sample geometry: small enough to measure in milliseconds,
#: token-valued floats.
_SAMPLE_SHAPE = (256, 1024)


def _numeric(value: Any) -> float:
    """A float for the flight ring: wire dtypes map through their
    stable on-the-wire codes, other strings to 0.0."""
    if isinstance(value, str):
        return float(wire.WIRE_CODES.get(value, 0.0))
    try:
        return float(value)
    except (TypeError, ValueError):
        return 0.0


@dataclasses.dataclass(frozen=True)
class Decision:
    """One audited knob decision: what changed, on what evidence."""

    knob: str
    old: Any
    new: Any
    #: measured | declared | default (module doc).
    cost_source: str
    #: Human-readable trigger ("break-even 38.2 MiB/s > link 12.0").
    reason: str
    #: The signal values that drove it (empty for default decisions).
    signals: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "knob": self.knob,
            "old": self.old,
            "new": self.new,
            "cost_source": self.cost_source,
            "reason": self.reason,
            "signals": dict(self.signals),
        }


@dataclasses.dataclass
class TunedConfig:
    """The Calibrator's output: a provenance-stamped config overlay.

    ``overlay`` holds ``LoaderConfig`` field values (:meth:`apply`
    produces the overlaid config); ``env`` holds registry knobs with no
    config field (:meth:`export` publishes them for envspec readers and
    spawned workers).  ``decisions`` records EVERY knob the pass judged
    — including ones left at their defaults — so absence of evidence is
    itself auditable.
    """

    decisions: List[Decision] = dataclasses.field(default_factory=list)
    overlay: Dict[str, Any] = dataclasses.field(default_factory=dict)
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    budget_s: float = 0.0
    elapsed_s: float = 0.0
    #: True when any probe was skipped for budget (its knob went
    #: ``default``) — the artifact's "calibration was partial" flag.
    deadline_hit: bool = False
    #: The distribution route the calibration picked, for the caller's
    #: ``DeviceIngestor(distribute=...)`` / loader ``distribute=``; None
    #: keeps the caller's own.  (The JAX package exports it as the
    #: ``DDL_TPU_DISTRIBUTE`` env knob, which the port does not have.)
    distribute: Optional[str] = None

    def apply(self, config: Any) -> Any:
        """``config`` with the overlay fields replaced (a new dataclass
        instance; the input is not mutated)."""
        fields = {
            k: v for k, v in self.overlay.items()
            if hasattr(config, k)
        }
        return dataclasses.replace(config, **fields)

    def export(self) -> None:
        """Publish the non-config knobs into the environment (the
        envspec seam loader construction and worker spawn read)."""
        import os

        for var, value in self.env.items():
            os.environ[var] = str(value)

    def cost_sources(self) -> Dict[str, int]:
        out = {COST_MEASURED: 0, COST_DECLARED: 0, COST_DEFAULT: 0}
        for d in self.decisions:
            out[d.cost_source] = out.get(d.cost_source, 0) + 1
        return out

    def as_report(self) -> dict:
        """The report block body."""
        return {
            "decisions": [d.as_dict() for d in self.decisions],
            "overlay": dict(self.overlay),
            "env": dict(self.env),
            "distribute": self.distribute,
            "cost_sources": self.cost_sources(),
            "budget_s": round(self.budget_s, 3),
            "elapsed_s": round(self.elapsed_s, 4),
            "deadline_hit": self.deadline_hit,
        }


class Calibrator:
    """Boot-time knob calibration under a deadline budget (module doc).

    ``link_costs`` supplies DECLARED link speeds (no probe runs for
    them); ``hosts`` + ``transfer`` instead requests a MEASURED
    ``probe_link_costs`` pass (``transfer`` pluggable exactly as the
    placement probe's: a deployment wires a send/recv pair between
    hosts, the card run a pinned host-to-card copy).
    ``sample`` overrides the wire microbenchmark's input (e.g. a real
    shard slice); ``distribute_probe`` is a zero-arg callable returning
    ``{"ici": bytes_per_s, "xla": bytes_per_s}`` measured on the actual
    mesh — absent, the distribution decision keeps ``distribute``, the
    route the caller passes to ``DeviceIngestor``.
    """

    def __init__(
        self,
        deadline_s: Optional[float] = None,
        link_costs: Optional[LinkCosts] = None,
        hosts: Optional[List[int]] = None,
        transfer: Optional[Callable[[int, int, np.ndarray], None]] = None,
        sample: Optional[np.ndarray] = None,
        distribute_probe: Optional[Callable[[], Dict[str, float]]] = None,
        distribute: str = "auto",
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.deadline_s = (
            envspec.get("DDL_TORCH_TUNE_DEADLINE_S")
            if deadline_s is None
            else float(deadline_s)
        )
        self.link_costs = link_costs
        self.hosts = list(hosts) if hosts else []
        self.transfer = transfer
        self.sample = sample
        self.distribute_probe = distribute_probe
        #: The route the caller passes to ``DeviceIngestor`` now (its
        #: default, ``"auto"``, is the JAX package's env default): the
        #: old value of the distribution decision.
        self.distribute = distribute
        self.metrics = metrics or default_metrics()
        self._clock = clock

    # -- decision plumbing -------------------------------------------------

    def _decide(
        self,
        tuned: TunedConfig,
        knob: str,
        old: Any,
        new: Any,
        cost_source: str,
        reason: str,
        signals: Optional[Dict[str, float]] = None,
    ) -> None:
        d = Decision(
            knob=knob, old=old, new=new, cost_source=cost_source,
            reason=reason, signals=signals or {},
        )
        tuned.decisions.append(d)
        self.metrics.incr("tune.decisions")
        self.metrics.incr(f"tune.cost_source.{cost_source}")
        flight_note("tune", f"calibrate.{knob}", _numeric(new))
        logger.info(
            "tune: calibrate %s %r -> %r (%s: %s)",
            knob, old, new, cost_source, reason,
        )

    # -- the pass ----------------------------------------------------------

    def calibrate(self, config: Any = None) -> TunedConfig:
        """Run every probe the budget allows; return the overlay.

        ``config`` (a ``LoaderConfig`` or None) supplies the OLD values
        decisions are recorded against; the returned overlay is applied
        with :meth:`TunedConfig.apply` / :meth:`TunedConfig.export` by
        the caller — calibration computes, the caller commits.
        """
        t0 = self._clock()
        deadline = t0 + max(0.0, self.deadline_s)
        tuned = TunedConfig(budget_s=self.deadline_s)

        costs, link_source = self._link_costs(deadline, tuned)
        self._calibrate_wire(config, tuned, deadline, costs, link_source)
        self._calibrate_distribute(tuned, deadline)
        self._calibrate_depths(config, tuned)

        tuned.elapsed_s = self._clock() - t0
        return tuned

    def _remaining(self, deadline: float) -> float:
        return deadline - self._clock()

    def _link_costs(
        self, deadline: float, tuned: TunedConfig
    ) -> tuple:
        """(LinkCosts, provenance): declared wins, then a measured
        probe inside the remaining budget, then defaults."""
        if self.link_costs is not None:
            return self.link_costs, COST_DECLARED
        remaining = self._remaining(deadline)
        if self.hosts and len(self.hosts) > 1 and remaining > 0:
            costs = probe_link_costs(
                self.hosts, self.transfer, timeout_s=remaining
            )
            if costs.n_links:
                return costs, COST_MEASURED
        else:
            tuned.deadline_hit = tuned.deadline_hit or remaining <= 0
        return LinkCosts({}, source="default"), COST_DEFAULT

    def _link_bottleneck(self, costs: LinkCosts) -> float:
        """The slowest known hop — the link every wire byte must be
        priced against (unknown fabrics price at the default floor)."""
        hosts = costs.hosts()
        if len(hosts) < 2:
            return costs.default_bytes_per_s
        return min(
            costs.bytes_per_s(a, b)
            for i, a in enumerate(hosts)
            for b in hosts[i + 1:]
        )

    def _calibrate_wire(
        self,
        config: Any,
        tuned: TunedConfig,
        deadline: float,
        costs: LinkCosts,
        link_source: str,
    ) -> None:
        old = getattr(config, "wire_dtype", "") or "raw"
        if self._remaining(deadline) <= 0:
            tuned.deadline_hit = True
            self._decide(
                tuned, "wire_dtype", old, old, COST_DEFAULT,
                "calibration budget exhausted before the wire probe",
            )
            return
        sample = self.sample
        if sample is None:
            rng = np.random.default_rng(0)
            sample = rng.integers(0, 32, _SAMPLE_SHAPE).astype(np.float32)
        stats = wire.measure_wire_stats(
            np.asarray(sample), deadline=deadline
        )
        if not stats:
            tuned.deadline_hit = True
            self._decide(
                tuned, "wire_dtype", old, old, COST_DEFAULT,
                "wire microbenchmark skipped (budget/dtype)",
            )
            return
        link = self._link_bottleneck(costs)
        pick = wire.pick_wire_format(stats, link)
        if pick not in wire.WIRE_DTYPES:
            # A codec won the economics; the wire_dtype knob only
            # carries the lossy tier — leave it raw and let the codec
            # knob (operator-set) cover the lossless tier.
            pick = "raw"
        # The decision's evidence is the break-even table vs the link.
        be = wire.break_even_table(stats)
        signals = {"link_bytes_per_s": round(link, 1)}
        signals.update(
            {f"break_even.{f}": round(v, 1) for f, v in be.items()}
        )
        src = COST_MEASURED if link_source == COST_MEASURED else link_source
        self._decide(
            tuned, "wire_dtype", old, pick, src,
            f"pick_wire_format at link {link:.3e} B/s "
            f"({link_source} link, measured wire stats)",
            signals,
        )
        if pick != old:
            tuned.overlay["wire_dtype"] = pick

    def _calibrate_distribute(
        self, tuned: TunedConfig, deadline: float
    ) -> None:
        old = self.distribute
        if self.distribute_probe is None:
            self._decide(
                tuned, "distribute", old, old, COST_DEFAULT,
                "no distribution probe supplied (auto resolves per "
                "platform at ingest)",
            )
            return
        if self._remaining(deadline) <= 0:
            tuned.deadline_hit = True
            self._decide(
                tuned, "distribute", old, old, COST_DEFAULT,
                "calibration budget exhausted before the "
                "distribution probe",
            )
            return
        try:
            rates = dict(self.distribute_probe())
        except (ShutdownRequested, KeyboardInterrupt):
            raise
        except Exception as e:  # noqa: BLE001 - a dead probe keeps defaults
            logger.warning("tune: distribution probe failed: %s", e)
            self._decide(
                tuned, "distribute", old, old, COST_DEFAULT,
                f"distribution probe failed ({type(e).__name__})",
            )
            return
        if not rates:
            self._decide(
                tuned, "distribute", old, old, COST_DEFAULT,
                "distribution probe returned no rates",
            )
            return
        pick = max(sorted(rates), key=lambda k: rates[k])
        self._decide(
            tuned, "distribute", old, pick, COST_MEASURED,
            "fastest measured distribution tier",
            {f"bytes_per_s.{k}": round(v, 1) for k, v in rates.items()},
        )
        if pick != old:
            tuned.distribute = pick

    def _calibrate_depths(self, config: Any, tuned: TunedConfig) -> None:
        """Floor starved pipeline depths at their shipped defaults.

        Boot offers no compute profile to price depth against — the
        steady-state controller owns refinement — but a depth BELOW the
        shipped default is a known-starved configuration (no overlap at
        depth 1), so calibration restores the floor with ``default``
        provenance and leaves operator increases alone.
        """
        for knob, var, current in (
            ("prefetch_depth", "DDL_TORCH_PREFETCH_DEPTH",
             getattr(config, "prefetch_depth", None)),
            ("staging_queue", "DDL_TORCH_STAGING_QUEUE", None),
        ):
            spec = envspec.require(var)
            if current is None:
                current = envspec.get(var)
            floor = int(spec.default)
            if int(current) < floor:
                self._decide(
                    tuned, knob, int(current), floor, COST_DEFAULT,
                    f"depth {current} below the shipped default "
                    f"{floor}: no-overlap starvation at boot",
                )
                if knob == "prefetch_depth":
                    tuned.overlay["prefetch_depth"] = floor
                else:
                    tuned.env[var] = str(floor)
            else:
                self._decide(
                    tuned, knob, int(current), int(current), COST_DEFAULT,
                    "at/above the shipped default; steady-state "
                    "controller owns refinement",
                )
