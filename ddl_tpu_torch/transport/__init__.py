"""Transport: window rings (in-process and shared-memory) and the
handshake control plane."""

from ddl_tpu_torch.transport.connection import (
    NOTHING,
    ConsumerConnection,
    ControlChannel,
    PipeChannel,
    ProducerConnection,
    ThreadChannel,
)
from ddl_tpu_torch.transport.ring import DEFAULT_TIMEOUT_S, ThreadRing, WindowRing
from ddl_tpu_torch.transport.shm_ring import (
    NativeShmRing,
    PyShmRing,
    create_shm_ring,
    make_ring_name,
    native_available,
    open_shm_ring,
)

__all__ = [
    "DEFAULT_TIMEOUT_S",
    "NOTHING",
    "ConsumerConnection",
    "ControlChannel",
    "NativeShmRing",
    "PipeChannel",
    "ProducerConnection",
    "PyShmRing",
    "ThreadChannel",
    "ThreadRing",
    "WindowRing",
    "create_shm_ring",
    "make_ring_name",
    "native_available",
    "open_shm_ring",
]
