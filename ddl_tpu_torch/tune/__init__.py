"""ddl_tpu_torch.tune — the self-tuning data plane: boot-time calibration
and closed-loop knob control (port of ``ddl_tpu/tune/``).  Framework-free
Python.

- :class:`~ddl_tpu_torch.tune.calibrate.Calibrator` — at boot: the wire
  break-even table against *measured* link speeds (the pluggable
  ``probe_link_costs``), an optional distribution probe, and the depth
  floors, emitting a :class:`~ddl_tpu_torch.tune.calibrate.TunedConfig`
  overlay onto ``LoaderConfig``.  Every decision carries ``cost_source``
  provenance (measured / declared / default) and the pass runs under one
  deadline (``DDL_TORCH_TUNE_DEADLINE_S``), so calibration never stalls
  training start.
- :class:`~ddl_tpu_torch.tune.controller.KnobController` — in steady
  state: a deadline loop watching the windowed stall fraction and the
  window-latency p99, retuning prefetch depth and staging capacity under
  hysteresis (the Autoscaler's mechanics), re-running placement on
  measured-cost drift, and flipping a lossy wire off when the
  ``loss_parity`` headroom shrinks.  A change whose next window is slower
  is reverted.

Audit trail: ``tune.decisions`` / ``tune.reverts`` /
``tune.cost_source.*`` counters (``north_star_report``'s
``tune_decisions`` / ``tune_reverts`` / ``tune_cost_source``), and every
decision in the flight-recorder ring (kind ``tune``).
"""


from ddl_tpu_torch.tune.calibrate import (  # noqa: F401
    COST_DECLARED,
    COST_DEFAULT,
    COST_MEASURED,
    Calibrator,
    Decision,
    TunedConfig,
)
from ddl_tpu_torch.tune.controller import (  # noqa: F401
    ControllerPolicy,
    KnobController,
)
from ddl_tpu_torch.tune.knobs import (  # noqa: F401
    TunableKnob,
    env_knob,
    prefetch_knob,
    staging_pool_knob,
    staging_queue_knob,
    wire_dtype_knob,
)

__all__ = [
    "COST_DECLARED",
    "COST_DEFAULT",
    "COST_MEASURED",
    "Calibrator",
    "ControllerPolicy",
    "Decision",
    "KnobController",
    "TunableKnob",
    "TunedConfig",
    "env_knob",
    "prefetch_knob",
    "staging_pool_knob",
    "staging_queue_knob",
    "wire_dtype_knob",
]
