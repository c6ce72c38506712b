"""How the system under test runs each model family: one module a family
(``benchmark/families/<family>.py``) with ``program_config``, ``loss_fn``,
``items_per_step``, ``step_flops`` and ``attention``.  Only these modules
import the port's models, and only when called."""

from __future__ import annotations

import importlib
from typing import Any


def load(name: str) -> Any:
    return importlib.import_module(f"benchmark.families.{name}")
