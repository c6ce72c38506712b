"""Structural protocol for producer-loop hooks (copy of
``ddl_tpu/protocols.py``, whose names the port keeps)."""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable


@runtime_checkable
class CallbackProtocol(Protocol):
    """Hooks dispatched around the producer hot loop: ``on_push_begin``
    once, then per window ``global_shuffle`` → ``execute_function`` →
    (handoff) → ``on_shuffle_end``; ``on_push_end`` once at shutdown.
    Missing hooks are no-ops."""

    def on_push_begin(self, **kwargs: Any) -> Any: ...

    def global_shuffle(self, **kwargs: Any) -> Any: ...

    def execute_function(self, **kwargs: Any) -> Any: ...

    def on_shuffle_end(self, **kwargs: Any) -> Any: ...

    def on_push_end(self, **kwargs: Any) -> Any: ...


#: Hook names considered valid dispatch positions.
CALLBACK_POSITIONS: tuple[str, ...] = (
    "on_init",
    "post_init",
    "fast_forward",
    "adopt_shards",
    "on_push_begin",
    "global_shuffle",
    "execute_function",
    "on_shuffle_end",
    "on_push_end",
)
