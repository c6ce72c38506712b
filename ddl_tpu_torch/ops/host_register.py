"""Page-lock shared-memory ring mappings for DMA to the card
(``csrc/host_register.cu``: ``cudaHostRegister``,
``cudaHostUnregister`` and ``cudaPointerGetAttributes`` behind a plain C
interface; no kernel).

The consumer of a PROCESS-mode run feeding a card registers each ring
it attaches, its whole mapping, once, right after the handshake
(:func:`page_lock`), and unregisters it at shutdown, after every copy
that may still read a slot has completed and before the ring is closed
(:func:`page_unlock`).  A registration that fails raises: a
``non_blocking`` copy out of pageable memory still gives the right bytes,
but it blocks the host, and the overlap would be silently gone.  A
producer process that dies while its ring is registered leaves the
consumer's own mapping valid until the consumer unmaps it.
"""

from __future__ import annotations

import ctypes
from typing import Any

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    """The library, built at first use, with its C signatures."""
    from ddl_tpu_torch.ops import _build

    lib = _build.load("host_register")
    if not getattr(lib, "_ddl_bound", False):
        lib.ddl_host_register.argtypes = [_P, ctypes.c_size_t, ctypes.c_int]
        lib.ddl_host_register.restype = ctypes.c_int
        lib.ddl_host_unregister.argtypes = [_P]
        lib.ddl_host_unregister.restype = ctypes.c_int
        lib.ddl_host_is_registered.argtypes = [_P]
        lib.ddl_host_is_registered.restype = ctypes.c_int
        lib.ddl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ddl_cuda_error_string.restype = ctypes.c_char_p
        lib._ddl_bound = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().ddl_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def is_registered(addr: int) -> bool:
    """Does the CUDA runtime report ``addr`` as page-locked host memory
    (``cudaMemoryTypeHost``)?"""
    rc = _lib().ddl_host_is_registered(addr)
    if rc < 0:
        _check(-rc, f"cudaPointerGetAttributes(0x{addr:x})")
    return rc == 1


def page_lock(ring: Any, device: Any) -> None:
    """Register ``ring``'s whole mapping (``ring.mapping()``) with
    ``device``'s CUDA runtime and verify it reads back as page-locked;
    raises on any failure.  Sets ``ring.page_locked``."""
    import torch

    addr, nbytes = ring.mapping()
    index = torch.device(device).index
    _check(_lib().ddl_host_register(
        addr, nbytes, torch.cuda.current_device() if index is None else index),
        f"cudaHostRegister of {nbytes} bytes at 0x{addr:x}")
    if not is_registered(addr):
        raise RuntimeError(
            f"cudaHostRegister returned success, but 0x{addr:x} does not "
            "read back as page-locked host memory"
        )
    ring.page_locked = True


def page_unlock(ring: Any) -> None:
    """Undo :func:`page_lock`.  The caller has made sure no copy still
    reads the mapping."""
    addr, _ = ring.mapping()
    _check(_lib().ddl_host_unregister(addr), f"cudaHostUnregister(0x{addr:x})")
    ring.page_locked = False
