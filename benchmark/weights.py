"""A configuration's weights from the run's seed, made on the device in one
draw: the program and the reference each call :func:`make` and get the
same values.

A family's reference lists its leaves as ``(path, shape, init)``, ``path``
the keys down the params tree (a list index for a layer), ``init``
``("normal", scale)`` or ``("ones",)``.
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence, Tuple

import torch

Spec = Tuple[Tuple[Any, ...], Tuple[int, ...], Tuple[Any, ...]]


def make(specs: Sequence[Spec], seed: int, device: Any) -> Tuple[Any, List[torch.Tensor]]:
    """(params tree, its leaves in ``specs`` order), float32.  Every
    ``normal`` leaf is a view into one buffer drawn by one ``randn`` call
    on ``device``, scaled in place."""
    n = sum(math.prod(shape) for _, shape, init in specs if init[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    leaves: List[torch.Tensor] = []
    off = 0
    for _, shape, init in specs:
        if init[0] == "normal":
            size = math.prod(shape)
            leaf = flat[off:off + size].view(shape).mul_(float(init[1]))
            off += size
        elif init[0] == "ones":
            leaf = torch.ones(shape, device=device, dtype=torch.float32)
        else:
            raise ValueError(f"unknown init {init!r}")
        leaves.append(leaf)
    return tree(specs, leaves), leaves


def tree(specs: Sequence[Spec], leaves: Sequence[Any]) -> Any:
    """Nest ``leaves`` by their specs' paths (dicts, and lists where a key
    is an int)."""
    root: dict = {}
    for (path, _, _), leaf in zip(specs, leaves):
        node: Any = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append({} if not isinstance(nxt, int) else [])
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        if isinstance(node, list):
            node.append(leaf)
        else:
            node[path[-1]] = leaf
    return root
