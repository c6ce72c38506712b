"""End-to-end window integrity: checksummed (seq, producer) slot trailers
(port of ``ddl_tpu/integrity.py``).

The trailer layout is byte-identical to the JAX package's, so a window
stamped by one package verifies in the other::

    u32 magic   u32 crc32(payload [+ scales])   u64 seq
    u32 producer_idx   u32 flags   u32 wire_code   u32 scale_bytes

The port stamps and verifies raw windows only (``wire_code ==
scale_bytes == 0``): the wire-encoded tier, whose CRC also covers the
trailer-extension scales, is a later slice.  ``DDL_TORCH_INTEGRITY=0``
disables the layer.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np

#: Trailer size reserved past the payload in every ring slot.
HEADER_BYTES = 32

_MAGIC = 0x44444C57  # "DDLW"
_FMT = "<IIQIIII"
_FMT_BYTES = struct.calcsize(_FMT)  # 32


def integrity_enabled(override: Optional[bool] = None) -> bool:
    """The ``DDL_TORCH_INTEGRITY`` gate (default ON)."""
    from ddl_tpu_torch import envspec

    return envspec.flag("DDL_TORCH_INTEGRITY", override)


def window_crc(payload: np.ndarray) -> int:
    """CRC32 of a window payload (a C-contiguous uint8 view)."""
    return zlib.crc32(np.ascontiguousarray(payload)) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class WindowHeader:
    magic: int
    crc: int
    seq: int
    producer_idx: int
    flags: int
    wire_code: int = 0
    scale_bytes: int = 0

    @property
    def valid_magic(self) -> bool:
        return self.magic == _MAGIC


def write_header(
    slot_view: np.ndarray,
    payload_bytes: int,
    seq: int,
    producer_idx: int,
    crc: int,
) -> None:
    """Stamp a raw-window trailer into ``slot_view`` past the payload."""
    packed = struct.pack(_FMT, _MAGIC, crc, seq, producer_idx, 0, 0, 0)
    slot_view[payload_bytes : payload_bytes + _FMT_BYTES] = np.frombuffer(
        packed, dtype=np.uint8
    )


def read_header(slot_view: np.ndarray, payload_bytes: int) -> WindowHeader:
    raw = bytes(slot_view[payload_bytes : payload_bytes + _FMT_BYTES])
    return WindowHeader(*struct.unpack(_FMT, raw))


def verify_window(
    slot_view: np.ndarray,
    payload_bytes: int,
    expect_seq: int,
    expect_producer: int,
) -> Optional[str]:
    """Full drain-time check.  Returns a failure description, or None.
    Ordered cheap-to-expensive: magic, identity and sequence, then CRC."""
    hdr = read_header(slot_view, payload_bytes)
    if not hdr.valid_magic:
        return f"bad header magic 0x{hdr.magic:08x} (torn or unstamped commit)"
    if hdr.producer_idx != expect_producer:
        return (
            f"window from producer {hdr.producer_idx}, "
            f"expected producer {expect_producer}"
        )
    if hdr.seq != expect_seq:
        return f"window seq {hdr.seq}, expected {expect_seq} (drop/duplicate)"
    got = window_crc(slot_view[:payload_bytes])
    if got != hdr.crc:
        return (
            f"payload crc32 0x{got:08x} != committed 0x{hdr.crc:08x} "
            f"(seq {hdr.seq}, producer {hdr.producer_idx})"
        )
    return None
