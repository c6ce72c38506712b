"""Traffic sources, one module a source (``benchmark/sources/<source>.py``),
found by a traffic mix's ``source`` key.  Each has:

- ``write(traffic, config, seed, directory, device) -> inputs``: the
  cell's input files from the seed, and a dict of where they are;
- ``producer(traffic, inputs, seed, config)``: the port's producer that
  serves them (it imports the port only when called);
- ``windows(inputs, traffic, seed, producer_index)``: what that producer
  serves, regenerated from the files and the seed without the port, as
  an endless iterator of (row sums, thunk of the whole window).

A new source is one new module here; a new mix of an existing source is
one new ``benchmark/traffic/<mix>.json``.
"""

from __future__ import annotations

import importlib
from typing import Any


def load(name: str) -> Any:
    return importlib.import_module(f"benchmark.sources.{name}")
