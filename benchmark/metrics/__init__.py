"""The metric readers: ``<prefix>.py`` reads every metric named
``<prefix>`` or ``<prefix>.<cell kind>`` (one quantity, split by the
end-to-end metric it moves), with ``read(run) -> float | None`` over a
:class:`RunView`.  A reader that
finds nothing to read returns None, and the harness leaves the metric
out."""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Any, Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class RunView:
    """One run as the readers see it."""

    config: Dict[str, Any]
    traffic: Dict[str, Any]
    #: "tokens" or "images", and how many a step trains
    item_unit: str
    items_per_step: int
    step_flops: float
    #: one step's attention calls (shape, count), from the family
    attention: Dict[str, Any]
    #: the card's published peaks (``benchmark.peaks``), or None
    peaks: Optional[Dict[str, float]]
    #: the program's run (``benchmark.program.ProgramRun``)
    prog: Any
    #: the traced window (``benchmark.trace.Summary``), or None
    trace: Any

    @property
    def steps_per_window(self) -> int:
        return int(self.traffic["steps_per_window"])

    @property
    def measured_steps(self) -> int:
        return self.prog.measured_windows * self.steps_per_window

    @property
    def traced_steps(self) -> int:
        return self.prog.traced_windows * self.steps_per_window


def reader(name: str) -> Any:
    """The module that reads metric ``name``."""
    stem = name.split(".")[0]
    path = os.path.join(HERE, stem + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
