"""The one traffic generator: a cell's input files from its traffic mix and
the run's seed.

A traffic mix is a JSON file of parameters under ``benchmark/traffic/``;
its ``source`` names the module of ``benchmark/sources/`` that writes the
files (``token_stream``, ``image_shards``).  Every draw runs on the run's
device from a ``torch.Generator`` seeded with the seed, so one seed gives
the same files on one device type.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from benchmark import sources


def generator(seed: int, stream: int, device: Any) -> torch.Generator:
    """The seed's generator for one kind of draw (``stream``)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (1 << 63))


def zipf(n: int, support: int, a: float, gen: torch.Generator,
         device: Any) -> torch.Tensor:
    """``n`` draws in [0, support) with P(k) proportional to (k+1)**-a."""
    w = torch.arange(1, support + 1, dtype=torch.float64, device=device) ** -a
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=support - 1)


def write_inputs(traffic: Dict[str, Any], config: Dict[str, Any], seed: int,
                 directory: str, device: Any) -> Dict[str, Any]:
    """Write the cell's input files under ``directory``; returns where
    they are, with the ``source`` that wrote them."""
    source = traffic["source"]
    inputs = sources.load(source).write(traffic, config, seed, directory,
                                        device)
    return dict(inputs, source=source)
