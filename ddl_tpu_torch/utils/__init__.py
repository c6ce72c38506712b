"""Cross-cutting utilities: callback dispatch, call tracing, the bool
env gate, device resolution and the non-blocking completion probe (port
of ``ddl_tpu/utils``).
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Any, Callable, Iterable, Optional, Sequence

from ddl_tpu_torch.protocols import CALLBACK_POSITIONS

logger = logging.getLogger("ddl_tpu_torch")


def env_flag(name: str, override: Optional[bool] = None) -> bool:
    """The boolean env gate: an explicit ``override`` wins; otherwise the
    ``DDL_TORCH_*`` knob is truthy unless ``0``/``off``/``false``
    (case-insensitive).  An unregistered name raises
    ``envspec.UnknownKnobError``."""
    # Lazy: utils is imported everywhere, envspec pulls in config.
    from ddl_tpu_torch import envspec

    return envspec.flag(name, override)


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


def with_logging(
    fn: Callable[..., Any] | None = None, *, tag: str = ""
) -> Callable[..., Any]:
    """Debug-trace a callable: entry with its arguments, exit with its
    result or exception and the duration.  Below DEBUG the wrapper only
    passes the call through."""

    def deco(f: Callable[..., Any]) -> Callable[..., Any]:
        qual = f"{tag}{f.__qualname__}"

        @functools.wraps(f)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if not logger.isEnabledFor(logging.DEBUG):
                return f(*args, **kwargs)
            t0 = time.perf_counter()
            logger.debug("-> %s args=%r kwargs=%r", qual, args[1:], kwargs)
            try:
                ret = f(*args, **kwargs)
            except BaseException as e:
                logger.debug(
                    "!! %s raised %r after %.3fms",
                    qual, e, (time.perf_counter() - t0) * 1e3,
                )
                raise
            logger.debug(
                "<- %s = %r (%.3fms)", qual, ret,
                (time.perf_counter() - t0) * 1e3,
            )
            return ret

        return wrapper

    if fn is not None:
        return deco(fn)
    return deco


def for_all_methods(
    decorator: Callable[..., Any], exclude: Iterable[str] = ()
) -> Callable[[type], type]:
    """Class decorator applying ``decorator`` to every method the class
    defines, except dunders and the names in ``exclude``."""
    exclude = set(exclude)

    def deco(cls: type) -> type:
        for name, attr in list(vars(cls).items()):
            if name in exclude or name.startswith("__"):
                continue
            if callable(attr):
                setattr(cls, name, decorator(attr))
        return cls

    return deco


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
