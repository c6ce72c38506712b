"""The comparison that decides ``correct``: the program's readings of the
judged steps against the plain reference's, and the stream the steps
consumed against its regeneration, each number held to the cell's limit
(``benchmark/limits/<workload>.json``).

- ``stream_mismatch``: consumed windows whose row sums differ from the
  regenerated stream's (exact: limit 0).
- ``loss_gap``: the largest relative gap of a judged step's loss.
- ``grad_gap``: the first gradient's norm, by the worst leaf: the gap
  between the two norms over the larger of the reference's norm of that
  leaf and of the median leaf.
- ``update_gap``: the same of each leaf's change over the judged steps,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone under AdamW).
- ``update_gap_median``: the median over those leaves of the same gap.
  AdamW's first steps are close to ``lr`` times a sign, so the worst leaf
  swings with the few entries whose sign is a coin toss, while a wrong
  step size or a missing share of the gradient moves every leaf.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np

NAMES = ("stream_mismatch", "loss_gap", "grad_gap", "update_gap",
         "update_gap_median")


def leaf_gap(prog: Sequence[float], ref: Sequence[float],
             keep: Sequence[bool] = (), reduce: Any = np.max) -> float:
    """``reduce`` (largest by default) of |prog - ref| / max(ref, median
    ref) over the kept leaves; 1.0 where the program has no reading."""
    ref_a = np.asarray(ref, dtype=np.float64)
    if len(prog) != len(ref_a):
        return 1.0
    prog_a = np.asarray(prog, dtype=np.float64)
    mask = np.asarray(keep, dtype=bool) if len(keep) else np.ones(len(ref_a), bool)
    if not mask.any():
        return 1.0
    scale = np.maximum(ref_a, np.median(ref_a[mask]))
    gaps = np.abs(prog_a - ref_a) / np.maximum(scale, 1e-30)
    return float(reduce(gaps[mask]))


def readings(prog_losses: Sequence[float], prog_grads: Sequence[float],
             prog_deltas: Sequence[float], ref_losses: Sequence[float],
             ref_grads: Sequence[float], ref_deltas: Sequence[float],
             mismatched_windows: int) -> Dict[str, float]:
    if len(prog_losses) != len(ref_losses):
        loss_gap = 1.0
    else:
        loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    g = np.asarray(ref_grads, dtype=np.float64)
    moved = g >= 1e-3 * np.median(g)
    return {
        "stream_mismatch": float(mismatched_windows),
        "loss_gap": float(loss_gap),
        "grad_gap": leaf_gap(prog_grads, ref_grads),
        "update_gap": leaf_gap(prog_deltas, ref_deltas, moved),
        "update_gap_median": leaf_gap(prog_deltas, ref_deltas, moved,
                                      np.median),
    }


def mismatched(got: np.ndarray, want: np.ndarray) -> int:
    """Windows whose row sums differ (a window missing counts)."""
    n = min(len(got), len(want))
    bad = int((got[:n] != want[:n]).any(axis=1).sum()) if n else 0
    return bad + abs(len(got) - len(want))


def judge(values: Dict[str, float], limits: Dict[str, Any]) -> bool:
    """Every compared number finite and within its limit.  A limit of
    None leaves its number uncompared: the cell has no reading that a
    limit could sit under (``PERF.md`` names each such number)."""
    return all(limits[k] is None
               or (math.isfinite(values[k]) and values[k] <= limits[k])
               for k in NAMES)


def lines(values: Dict[str, float], limits: Dict[str, Any]) -> List[str]:
    return [f"check {k} {values[k]!r} limit "
            f"{'none (not compared)' if limits[k] is None else repr(limits[k])}"
            for k in NAMES]
