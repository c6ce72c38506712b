"""Cross-cutting utilities: callback dispatch, device resolution and the
non-blocking completion probe (the slice's subset of ``ddl_tpu/utils``).
"""

from __future__ import annotations

from typing import Any, Sequence

from ddl_tpu_torch.protocols import CALLBACK_POSITIONS


def execute_callbacks(
    callbacks: Sequence[Any], position: str, **kwargs: Any
) -> Any:
    """Dispatch hook ``position`` on every callback that implements it;
    the last non-None return wins."""
    if position not in CALLBACK_POSITIONS:
        raise ValueError(
            f"unknown callback position {position!r}; valid: {CALLBACK_POSITIONS}"
        )
    result: Any = None
    for callback in callbacks:
        fn = getattr(callback, position, None)
        if fn is None or not callable(fn):
            continue
        ret = fn(**kwargs)
        if ret is not None:
            result = ret
    return result


def resolve_device(device: Any = "cuda"):
    """The ``torch.device`` an entry point runs on.

    Entry points default to the card.  Without CUDA they raise unless the
    caller asked for the CPU explicitly — a run never drifts onto the
    host silently.
    """
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def value_ready(value: Any, default: bool) -> bool:
    """Non-blocking completion probe over a ``torch.cuda.Event`` or a
    tuple/list of them (the port of the JAX package's ``is_ready``
    probe).  ``None`` and leaves without ``query`` answer ``default`` —
    the caller's safety direction, as in the JAX package."""
    if value is None:
        return default
    if isinstance(value, (tuple, list)):
        return all(value_ready(v, default) for v in value)
    query = getattr(value, "query", None)
    if query is None:
        return default
    return bool(query())


def wait_value(value: Any) -> None:
    """Block until every event in ``value`` (as :func:`value_ready`
    reads it) has completed."""
    if isinstance(value, (tuple, list)):
        for v in value:
            wait_value(v)
        return
    sync = getattr(value, "synchronize", None)
    if sync is not None:
        sync()


def done_event(device: Any):
    """An event recorded on ``device``'s current stream — the "work
    enqueued so far has finished" future — or None on the CPU, where
    every op has finished by the time it returns."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev
