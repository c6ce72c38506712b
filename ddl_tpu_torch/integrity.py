"""End-to-end window integrity: checksummed (seq, producer) slot trailers
(port of ``ddl_tpu/integrity.py``).

The trailer layout is byte-identical to the JAX package's, so a window
stamped by one package verifies in the other::

    u32 magic   u32 crc32(payload [+ scales])   u64 seq
    u32 producer_idx   u32 flags   u32 wire_code   u32 scale_bytes

The last two fields are the wire extension (:mod:`ddl_tpu_torch.wire`):
``wire_code`` names the payload's wire dtype (0 = raw, what a raw
header carries) and ``scale_bytes`` sizes the int8 scales stored in the
trailer extension, the region just past this header.  An encoded window
is committed at its encoded size, so header and scales fit in the
raw-sized slot.  The CRC covers the encoded payload and then the scales:
a flipped wire byte fails verification exactly as a flipped raw byte
does.  ``DDL_TORCH_INTEGRITY=0`` disables the layer.
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


def wire_crc(slot_view: np.ndarray, payload_bytes: int,
             scale_bytes: int) -> int:
    """The committed CRC of a (possibly wire-encoded) slot: the payload
    CRC continued over the trailer-extension scales.  The producer's
    encoded commit and :func:`verify_window` both call this one function.
    ``scale_bytes == 0`` is the plain :func:`window_crc`."""
    crc = window_crc(slot_view[:payload_bytes])
    if scale_bytes:
        start = payload_bytes + HEADER_BYTES
        crc = zlib.crc32(
            np.ascontiguousarray(slot_view[start : start + scale_bytes]), crc
        ) & 0xFFFFFFFF
    return crc


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

    @property
    def wire_dtype(self) -> str:
        """The payload's wire dtype name (``"raw"`` for a raw header)."""
        from ddl_tpu_torch import wire

        return wire._CODE_TO_DTYPE.get(self.wire_code, "raw")


def blob_seq(digest: str) -> int:
    """Stable 64-bit sequence tag derived from a cache-entry digest.

    The disk tier of the shard cache (:mod:`ddl_tpu_torch.cache.store`)
    stamps its entries with the trailer above and this digest-derived
    value in the header's ``seq`` field: a spill file renamed or
    hard-linked across keys then fails :func:`verify_window`'s sequence
    check even when its payload CRC is intact, so a stale entry can never
    alias a foreign key.
    """
    return int(digest[:16], 16) & 0xFFFFFFFFFFFFFFFF


def write_header(
    slot_view: np.ndarray,
    payload_bytes: int,
    seq: int,
    producer_idx: int,
    crc: int,
    wire_code: int = 0,
    scale_bytes: int = 0,
) -> None:
    """Stamp the trailer into ``slot_view`` past the payload.
    ``payload_bytes`` is the size of the bytes that travel (the encoded
    size for a wire-encoded window); the scales are written separately
    (:func:`write_scales`), just past this header."""
    packed = struct.pack(
        _FMT, _MAGIC, crc, seq, producer_idx, 0, wire_code, scale_bytes
    )
    slot_view[payload_bytes : payload_bytes + _FMT_BYTES] = np.frombuffer(
        packed, dtype=np.uint8
    )


def read_header(slot_view: np.ndarray, payload_bytes: int) -> WindowHeader:
    raw = bytes(slot_view[payload_bytes : payload_bytes + _FMT_BYTES])
    return WindowHeader(*struct.unpack(_FMT, raw))


def write_scales(slot_view: np.ndarray, payload_bytes: int,
                 scales: np.ndarray) -> None:
    """Write int8 scales into the trailer extension, just past the
    header; the caller stamps the matching ``scale_bytes`` and folds the
    scales into the CRC (:func:`wire_crc`)."""
    raw = np.ascontiguousarray(scales).view(np.uint8).reshape(-1)
    start = payload_bytes + HEADER_BYTES
    slot_view[start : start + raw.nbytes] = raw


def read_scales(slot_view: np.ndarray, payload_bytes: int,
                scale_bytes: int) -> np.ndarray:
    """The trailer extension's scales as a flat fp32 array (a copy: the
    slot may be released while the decode runs)."""
    start = payload_bytes + HEADER_BYTES
    return np.array(slot_view[start : start + scale_bytes]).view(np.float32)


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
    got = wire_crc(slot_view, payload_bytes, hdr.scale_bytes)
    if got != hdr.crc:
        return (
            f"payload crc32 0x{got:08x} != committed 0x{hdr.crc:08x} "
            f"(seq {hdr.seq}, producer {hdr.producer_idx}, "
            f"wire {hdr.wire_dtype})"
        )
    return None
