"""Transport: in-process window rings and the handshake control plane."""

from ddl_tpu_torch.transport.connection import (
    NOTHING,
    ConsumerConnection,
    ProducerConnection,
    ThreadChannel,
)
from ddl_tpu_torch.transport.ring import DEFAULT_TIMEOUT_S, ThreadRing, WindowRing

__all__ = [
    "DEFAULT_TIMEOUT_S",
    "NOTHING",
    "ConsumerConnection",
    "ProducerConnection",
    "ThreadChannel",
    "ThreadRing",
    "WindowRing",
]
