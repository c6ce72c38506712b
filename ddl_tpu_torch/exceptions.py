"""Exceptions for ddl_tpu_torch (the slice's subset of
``ddl_tpu/exceptions.py``, same names and hierarchy)."""

from __future__ import annotations


class DDLError(Exception):
    """Base class for all ddl_tpu_torch errors."""


class DoesNotMatchError(DDLError):
    """Topology or shape mismatch."""

    def __init__(self, value: object = None, message: str = ""):
        self.value = value
        self.message = message
        super().__init__(value, message)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        if self.message:
            return f"{self.value!r}: {self.message}"
        return repr(self.value)


class TransportError(DDLError):
    """A transport-level failure (ring corrupt, peer vanished, bad slot)."""


class ShutdownRequested(DDLError):
    """Internal control-flow signal: the pipeline is shutting down.
    Waits that observe a ring's shutdown flag raise this."""


class StallTimeoutError(TransportError, TimeoutError):
    """A blocking wait on the ring or a control channel exceeded its
    deadline (also a builtin ``TimeoutError``)."""


class IntegrityError(DDLError):
    """A window failed its drain-time integrity check (bad trailer
    magic, wrong producer or sequence number, or a CRC mismatch)."""


class LoaderStateError(DDLError, RuntimeError):
    """The loader was driven from an invalid state (finalized loader,
    superseded ``windows()`` stream)."""
