"""Cross-process shared-memory window ring (port of
``ddl_tpu/transport/shm_ring.py``): ctypes bindings over the port's own
copy of the C++ ring (``csrc/shm_ring.cpp``), and a pure-Python fallback.

The native library is compiled with ``g++`` at first use into
``ddl_tpu_torch/_build/``, keyed by a hash of the source and the flags
(an edited source or a changed flag rebuilds), under the file lock and
atomic publish of :func:`ddl_tpu_torch.ops._build.publish`.  Its segment
layout and ``ddlr_*`` interface are the JAX package's, so a ring either
package creates opens in the other.  :class:`PyShmRing` speaks the same
counter protocol from Python over a raw ``mmap`` of a ``/dev/shm`` file,
for hosts without a toolchain; ``DDL_TORCH_FORCE_PY_RING=1`` forces it.

PROCESS mode: the producer process creates the ring, the consumer opens
it by name.  A consumer feeding a CUDA card page-locks the whole mapping
(:meth:`mapping`, ``ops/host_register.py``), so a window's copy to the
card is a DMA straight out of the slot the producer wrote.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import time
import uuid
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ddl_tpu_torch import envspec
from ddl_tpu_torch.exceptions import (
    ShutdownRequested,
    StallTimeoutError,
    TransportError,
)
from ddl_tpu_torch.faults import fault_point
from ddl_tpu_torch.transport.ring import DEFAULT_TIMEOUT_S, WindowRing

logger = logging.getLogger("ddl_tpu_torch")

_CSRC = Path(__file__).resolve().parent / "csrc" / "shm_ring.cpp"
#: The build recipe; the library's name hashes it with the source, so a
#: flag change (e.g. adding -lrt) never reuses a library built without it.
_CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# shm_open/shm_unlink live in librt until glibc 2.34.  Without -lrt an
# under-linked .so only loads in processes where some OTHER import
# already dragged librt in with RTLD_GLOBAL (torch in the trainer), and
# fails with `undefined symbol: shm_open` in freshly spawned producer
# processes — silently demoting them to the polling Python ring.  On
# glibc >= 2.34 librt is a stub, so the flag is harmless there.
_LDLIBS = ("-lrt",)
_lib: Optional[ctypes.CDLL] = None
_build_failure_logged = False


def library_path() -> Path:
    """Where the native ring builds to for the current source and flags."""
    from ddl_tpu_torch.ops._build import BUILD_DIR

    recipe = " ".join(("g++", *_CXXFLAGS, *_LDLIBS)).encode()
    digest = hashlib.sha256(_CSRC.read_bytes() + recipe).hexdigest()[:16]
    return BUILD_DIR / f"libshm_ring-{digest}.so"


def build_native() -> Path:
    """Compile the native ring unless its current build exists."""
    from ddl_tpu_torch.ops._build import publish

    return publish(library_path(), "shm_ring",
                   ["g++", *_CXXFLAGS, str(_CSRC), "-o", "{out}", *_LDLIBS])


def _load_native() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    vp, u32, u64, i64 = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
                         ctypes.c_int64)
    for fn, restype, argtypes in (
        ("ddlr_create", vp, [ctypes.c_char_p, u32, u64]),
        ("ddlr_open", vp, [ctypes.c_char_p]),
        ("ddlr_acquire_fill", ctypes.c_int, [vp, i64]),
        ("ddlr_commit", None, [vp, u32, u64]),
        ("ddlr_acquire_drain", ctypes.c_int, [vp, i64]),
        ("ddlr_acquire_drain_ahead", ctypes.c_int, [vp, u32, i64]),
        ("ddlr_release", None, [vp, u32]),
        ("ddlr_slot_ptr", vp, [vp, u32]),
        ("ddlr_slot_payload", u64, [vp, u32]),
        ("ddlr_shutdown", None, [vp]),
        ("ddlr_is_shutdown", ctypes.c_int, [vp]),
        ("ddlr_stat", u64, [vp, ctypes.c_int]),
        ("ddlr_nslots", u32, [vp]),
        ("ddlr_slot_bytes", u64, [vp]),
        ("ddlr_map_base", vp, [vp]),
        ("ddlr_map_bytes", u64, [vp]),
        ("ddlr_close", None, [vp]),
        ("ddlr_unlink", None, [ctypes.c_char_p]),
    ):
        # Every restype is explicit: ctypes defaults to c_int, which would
        # cut a returned pointer to 32 bits.
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _lib = lib
    return lib


def native_available() -> bool:
    """Can this process use the native ring?  False under
    ``DDL_TORCH_FORCE_PY_RING`` or when the build or load fails — the
    latter logged once as a warning, because the fallback refuses non-TSO
    ISAs and polls instead of sleeping on a futex."""
    global _build_failure_logged
    if envspec.flag("DDL_TORCH_FORCE_PY_RING"):
        return False
    try:
        _load_native()
        return True
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        # Everything the toolchain path raises: g++ missing (OSError),
        # a failed compile (RuntimeError from publish), a library that
        # does not load (OSError).  Nothing broader: a ShutdownRequested
        # or a programming error must not demote the process to the slow
        # ring.
        if not _build_failure_logged:
            _build_failure_logged = True
            logger.warning(
                "native shm ring build failed (%s: %s) — falling back to "
                "the pure-Python ring (TSO ISAs only, polling waits)",
                type(e).__name__, str(e)[:500],
            )
        return False


def make_ring_name(prefix: str = "ddl-torch") -> str:
    """A shm name unique enough to survive crashed prior runs."""
    return f"/{prefix}-{os.getpid()}-{uuid.uuid4().hex[:12]}"


class NativeShmRing(WindowRing):
    """ctypes wrapper over the C++ seqcount ring (``csrc/shm_ring.cpp``)."""

    def __init__(self, name: str, nslots: int = 0, slot_bytes: int = 0,
                 create: bool = False):
        self._lib = _load_native()
        self.name = name
        self.page_locked = False
        if create:
            self._h = self._lib.ddlr_create(name.encode(), nslots, slot_bytes)
        else:
            self._h = self._lib.ddlr_open(name.encode())
        if not self._h:
            raise TransportError(
                f"failed to {'create' if create else 'open'} shm ring {name!r}"
            )
        self.nslots = int(self._lib.ddlr_nslots(self._h))
        self.slot_bytes = int(self._lib.ddlr_slot_bytes(self._h))

    @classmethod
    def create(cls, name: str, nslots: int, slot_bytes: int) -> "NativeShmRing":
        return cls(name, nslots, slot_bytes, create=True)

    @classmethod
    def open(cls, name: str) -> "NativeShmRing":
        return cls(name, create=False)

    def _check_wait(self, rc: int, timeout_s: float) -> int:
        if rc == -2:
            raise ShutdownRequested()
        if rc == -1:
            raise StallTimeoutError(f"ring {self.name} wait exceeded {timeout_s}s")
        return rc

    def acquire_fill(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
        fault_point("ring.fill", should_abort=self.is_shutdown)
        rc = self._lib.ddlr_acquire_fill(self._h, int(timeout_s * 1e6))
        return self._check_wait(rc, timeout_s)

    def commit(self, slot: int, payload_bytes: int) -> None:
        self._lib.ddlr_commit(self._h, slot, payload_bytes)

    def acquire_drain(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
        fault_point("ring.drain", should_abort=self.is_shutdown)
        rc = self._lib.ddlr_acquire_drain(self._h, int(timeout_s * 1e6))
        return self._check_wait(rc, timeout_s)

    def acquire_drain_ahead(
        self, ahead: int, timeout_s: float = DEFAULT_TIMEOUT_S
    ) -> int:
        rc = self._lib.ddlr_acquire_drain_ahead(
            self._h, ahead, int(timeout_s * 1e6)
        )
        if rc == -3:
            raise ValueError(
                f"ahead must be in [0, nslots={self.nslots}), got {ahead}"
            )
        return self._check_wait(rc, timeout_s)

    def release(self, slot: int) -> None:
        self._lib.ddlr_release(self._h, slot)

    def slot_base(self, slot: int = 0) -> int:
        """Address of ``slot``'s payload inside the mapping."""
        return int(self._lib.ddlr_slot_ptr(self._h, slot))

    def mapping(self) -> Tuple[int, int]:
        """``(address, length)`` of the whole mapping, header included
        (mmap's page-aligned base)."""
        return (int(self._lib.ddlr_map_base(self._h)),
                int(self._lib.ddlr_map_bytes(self._h)))

    def slot_view(self, slot: int) -> np.ndarray:
        buf = (ctypes.c_uint8 * self.slot_bytes).from_address(
            self.slot_base(slot)
        )
        return np.frombuffer(buf, dtype=np.uint8)

    def slot_payload(self, slot: int) -> int:
        return int(self._lib.ddlr_slot_payload(self._h, slot))

    def shutdown(self) -> None:
        self._lib.ddlr_shutdown(self._h)

    def is_shutdown(self) -> bool:
        return bool(self._lib.ddlr_is_shutdown(self._h))

    def stats(self) -> Dict[str, float]:
        return {
            "producer_stall_s": self._lib.ddlr_stat(self._h, 0) / 1e6,
            "consumer_stall_s": self._lib.ddlr_stat(self._h, 1) / 1e6,
            "committed": float(self._lib.ddlr_stat(self._h, 2)),
            "released": float(self._lib.ddlr_stat(self._h, 3)),
        }

    def poll_drain_ready(self, ahead: int = 0) -> bool:
        # Two counter reads, not stats()'s four FFI calls and dict: this
        # runs in the stream's per-window lookahead loop.
        return (
            int(self._lib.ddlr_stat(self._h, 2))
            - int(self._lib.ddlr_stat(self._h, 3))
            > ahead
        )

    def close(self) -> None:
        # Does NOT munmap: numpy views from slot_view hold raw pointers
        # into the mapping, and unmapping under them would be a
        # use-after-free.  The kernel reclaims the mapping at process
        # exit; unlink() removes the name so the memory is freed once
        # every process has exited.
        pass

    def unlink(self) -> None:
        self._lib.ddlr_unlink(self.name.encode())


class PyShmRing(WindowRing):
    """Pure-Python fallback over a raw ``mmap`` of a ``/dev/shm`` file.

    The native ring's counter protocol with Python-level polling.  Counter
    stores are 8-byte aligned single writes with one writer each, which
    publish in program order only on total-store-order ISAs (x86-64), so
    other ISAs are refused: they need the native ring's fenced atomics.
    A raw mmap rather than ``multiprocessing.shared_memory``: outstanding
    numpy views never trip a BufferError at teardown, and no resource
    tracker runs in user processes.
    """

    _HDR = 4096  # [0]=committed u64, [8]=released u64, [16]=shutdown u64,
    #              [24]=nslots u64, [32]=slot_bytes u64, [40]=magic u64
    #              (written last by the creator), [64+8i]=payload[i]
    _MAGIC = 0xDD17_00F5_0000_0001  # py-format marker (≠ the native one)

    #: ISAs whose plain aligned stores publish in program order.
    _TSO_MACHINES = ("x86_64", "amd64", "i686", "i386")

    def __init__(self, name: str, nslots: int = 0, slot_bytes: int = 0,
                 create: bool = False):
        import mmap

        machine = platform.machine().lower()
        if (machine not in self._TSO_MACHINES
                and not envspec.flag("DDL_TORCH_UNSAFE_PY_RING")):
            raise TransportError(
                f"PyShmRing requires a total-store-order ISA (x86-64); "
                f"this machine is {machine!r}.  Install a C++ toolchain "
                f"for the native ring (fenced atomics), or set "
                f"DDL_TORCH_UNSAFE_PY_RING=1 to override at your own risk."
            )
        self.name = name
        self.page_locked = False
        path = f"/dev/shm/{name.lstrip('/')}"
        if create:
            total = self._HDR + nslots * slot_bytes
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, total)
                self._mm = mmap.mmap(fd, total)
            finally:
                os.close(fd)
            self._u64 = np.frombuffer(self._mm, dtype=np.uint64)
            self._u64[:8] = 0
            self._u64[3] = nslots
            self._u64[4] = slot_bytes
            self._u64[5] = self._MAGIC  # publish: the header is now valid
        else:
            fd = -1
            try:
                for _ in range(2000):  # the peer may still be creating it
                    try:
                        fd = os.open(path, os.O_RDWR)
                        break
                    except FileNotFoundError:
                        time.sleep(0.001)
                if fd < 0:
                    raise TransportError(f"shm ring {name!r} never appeared")
                total = 0
                for _ in range(2000):  # ... or still ftruncating it
                    total = os.fstat(fd).st_size
                    if total >= self._HDR:
                        break
                    time.sleep(0.001)
                if total < self._HDR:
                    raise TransportError(f"shm ring {name!r} never grew a header")
                self._mm = mmap.mmap(fd, total)
            finally:
                if fd >= 0:
                    os.close(fd)
            self._u64 = np.frombuffer(self._mm, dtype=np.uint64)
            for _ in range(2000):  # ... or still writing the header
                if int(self._u64[5]) == self._MAGIC:
                    break
                time.sleep(0.001)
            if int(self._u64[5]) != self._MAGIC:
                raise TransportError(
                    f"shm ring {name!r} is not py-format (a native segment "
                    f"opened under DDL_TORCH_FORCE_PY_RING, or corrupt)"
                )
        self.nslots = int(self._u64[3])
        self.slot_bytes = int(self._u64[4])
        self._stall = {"producer_stall_s": 0.0, "consumer_stall_s": 0.0}

    @classmethod
    def create(cls, name: str, nslots: int, slot_bytes: int) -> "PyShmRing":
        return cls(name, nslots, slot_bytes, create=True)

    @classmethod
    def open(cls, name: str) -> "PyShmRing":
        return cls(name, create=False)

    def _wait(self, ready, timeout_s: float, key: str) -> int:
        t0 = time.perf_counter()
        spins = 0
        try:
            while True:
                if self._u64[2]:
                    raise ShutdownRequested()
                slot = ready()
                if slot is not None:
                    return slot
                if time.perf_counter() - t0 > timeout_s:
                    raise StallTimeoutError(
                        f"ring {self.name} wait exceeded {timeout_s}s"
                    )
                spins += 1
                if spins > 100:
                    time.sleep(0.0002)
        finally:
            self._stall[key] += time.perf_counter() - t0

    def acquire_fill(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
        fault_point("ring.fill", should_abort=self.is_shutdown)

        def ready():
            c, r = int(self._u64[0]), int(self._u64[1])
            return c % self.nslots if c - r < self.nslots else None

        return self._wait(ready, timeout_s, "producer_stall_s")

    def commit(self, slot: int, payload_bytes: int) -> None:
        self._u64[8 + slot] = payload_bytes
        self._u64[0] = self._u64[0] + np.uint64(1)

    def acquire_drain(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
        fault_point("ring.drain", should_abort=self.is_shutdown)
        return self.acquire_drain_ahead(0, timeout_s)

    def acquire_drain_ahead(
        self, ahead: int, timeout_s: float = DEFAULT_TIMEOUT_S
    ) -> int:
        if not 0 <= ahead < self.nslots:
            raise ValueError(
                f"ahead must be in [0, nslots={self.nslots}), got {ahead}"
            )

        def ready():
            c, r = int(self._u64[0]), int(self._u64[1])
            return (r + ahead) % self.nslots if c > r + ahead else None

        return self._wait(ready, timeout_s, "consumer_stall_s")

    def release(self, slot: int) -> None:
        self._u64[1] = self._u64[1] + np.uint64(1)

    def slot_base(self, slot: int = 0) -> int:
        """Address of ``slot``'s payload inside the mapping."""
        return self.mapping()[0] + self._HDR + slot * self.slot_bytes

    def mapping(self) -> Tuple[int, int]:
        """``(address, length)`` of the whole mapping, header included."""
        return self._u64.ctypes.data, len(self._mm)

    def slot_view(self, slot: int) -> np.ndarray:
        off = self._HDR + slot * self.slot_bytes
        return np.frombuffer(self._mm, dtype=np.uint8,
                             count=self.slot_bytes, offset=off)

    def slot_payload(self, slot: int) -> int:
        return int(self._u64[8 + slot])

    def shutdown(self) -> None:
        self._u64[2] = 1

    def is_shutdown(self) -> bool:
        return bool(self._u64[2])

    def stats(self) -> Dict[str, float]:
        return {
            **self._stall,
            "committed": float(self._u64[0]),
            "released": float(self._u64[1]),
        }

    def close(self) -> None:
        # The mmap stays mapped until process exit, as in NativeShmRing.
        pass

    def unlink(self) -> None:
        try:
            os.unlink(f"/dev/shm/{self.name.lstrip('/')}")
        except OSError:
            pass


def create_shm_ring(name: str, nslots: int, slot_bytes: int) -> WindowRing:
    """Create the best available cross-process ring (native, else Python)."""
    if native_available():
        return NativeShmRing.create(name, nslots, slot_bytes)
    return PyShmRing.create(name, nslots, slot_bytes)


def open_shm_ring(name: str) -> WindowRing:
    if native_available():
        return NativeShmRing.open(name)
    return PyShmRing.open(name)
