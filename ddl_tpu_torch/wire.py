"""Wire format for the data plane: quantized and compressed window bytes
(port of ``ddl_tpu/wire.py``; every encoding is byte-identical to the
JAX package's).

- **Lossy tier** (``wire_dtype``): ``"bf16"`` halves and ``"int8"``
  quarters the wire bytes of float windows, int8 with blockwise fp32
  scales (one per :data:`QUANT_BLOCK` values: ``max|x| / 127`` per block,
  zero blocks at scale 1, round half to even, clip to +-127 — the
  numerics of the JAX package's ``parallel.collectives.
  quantize_blockwise``, copied here).  Opt-in per reader
  (``ProducerFunctionSkeleton.wire_dtype``) or forced by
  ``DDL_TORCH_WIRE_DTYPE``.
- **Lossless tier** (``codec``): ``zlib`` always, ``zstd``/``lz4`` only
  where their libraries are installed; a missing codec is named in the
  error, never swapped.  Encode takes an explicit ``level``, decode an
  explicit ``max_output``.

bf16 is computed here without a bf16 numpy dtype: the float32 bits,
rounded to nearest even in ``uint32`` arithmetic, keep their top 16 bits
(a NaN becomes the quiet NaN ``0x7FC0`` with its sign, as the JAX
package's ``ml_dtypes`` cast gives).

Chaos sites ``wire.encode`` / ``wire.decode`` (:mod:`ddl_tpu_torch.
faults`).  Accounting: encoders report ``wire.encoded_bytes`` (what
moved) beside ``wire.payload_bytes`` (the logical raw bytes).
"""

from __future__ import annotations

import struct
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ddl_tpu_torch import envspec
from ddl_tpu_torch.exceptions import DecodeError
from ddl_tpu_torch.faults import fault_point

#: Valid wire dtypes; ``"raw"`` moves the window's own storage dtype.
WIRE_DTYPES = ("raw", "bf16", "int8")

#: Header wire codes (the integrity trailer and the pack_rows header
#: both carry them).
WIRE_CODES = {"raw": 0, "bf16": 1, "int8": 2}
_CODE_TO_DTYPE = {v: k for k, v in WIRE_CODES.items()}

#: Quantization granularity: values per fp32 scale.
QUANT_BLOCK = 256

#: Default decode output bound.
DEFAULT_MAX_OUTPUT = 1 << 31


def check_wire_dtype(wire_dtype: Optional[str]) -> str:
    """Normalise and validate a wire dtype (None → ``"raw"``)."""
    wd = wire_dtype or "raw"
    if wd not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be one of {WIRE_DTYPES}, got {wire_dtype!r}"
        )
    return wd


def resolve_wire_dtype(requested: Optional[str]) -> str:
    """The effective wire dtype: ``DDL_TORCH_WIRE_DTYPE`` when set and
    non-empty (``raw`` is the kill switch, a lossy value forces the
    tier), else the reader's capability."""
    env = envspec.raw("DDL_TORCH_WIRE_DTYPE")
    if env is not None and env != "":
        return check_wire_dtype(env)
    return check_wire_dtype(requested)


def resolve_wire_codec(requested: Optional[str] = None) -> Optional[str]:
    """The effective lossless codec name: ``DDL_TORCH_WIRE_CODEC`` when
    set and non-empty (``"none"`` turns it off), else ``requested``.
    Validated against the registry, not constructed: a codec whose
    library is missing fails where the bytes are."""
    env = envspec.raw("DDL_TORCH_WIRE_CODEC")
    name = env if env is not None and env != "" else requested
    if not name or name == "none":
        return None
    if name not in _CODECS:
        raise ValueError(f"unknown codec {name!r}; known: {tuple(_CODECS)}")
    return name


def lossy_supported(dtype: Any) -> bool:
    """The lossy tier applies to float windows only (quantizing token ids
    would corrupt them; tokens take the lossless tier)."""
    return np.dtype(dtype).kind == "f"


# -- blockwise quantization ----------------------------------------------------


def _nblocks(cols: int, block: int = QUANT_BLOCK) -> int:
    return -(-cols // block)


def scale_bytes_for(shape: Tuple[int, ...], wire_dtype: str,
                    block: int = QUANT_BLOCK) -> int:
    """Bytes of one encoded window's scales (0 unless int8)."""
    if wire_dtype != "int8":
        return 0
    rows = int(shape[0])
    cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    return 4 * rows * _nblocks(cols, block)


def encoded_nbytes(shape: Tuple[int, ...], dtype: Any, wire_dtype: str) -> int:
    """Payload bytes of one window after encoding (scales apart)."""
    n = int(np.prod(shape))
    if wire_dtype == "raw":
        return n * np.dtype(dtype).itemsize
    if wire_dtype == "bf16":
        return n * 2
    return n  # int8: one byte per value


def quantize_rows(arr: np.ndarray, block: int = QUANT_BLOCK
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Blockwise int8 quantize of a ``(rows, ...)`` array over its
    flattened columns: ``(q int8 (rows, cols), scales fp32 (rows,
    nblocks))``."""
    rows = arr.shape[0]
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(rows, -1)
    cols = flat.shape[1]
    pad = (-cols) % block
    absx = np.abs(flat)
    padded = np.pad(absx, ((0, 0), (0, pad))) if pad else absx
    s = padded.reshape(rows, -1, block).max(axis=-1) / np.float32(127.0)
    s = np.where(s == 0.0, np.float32(1.0), s).astype(np.float32)
    expand = np.repeat(s, block, axis=1)[:, :cols]
    q = np.clip(np.rint(flat / expand), -127.0, 127.0).astype(np.int8)
    return q, s


def dequantize_rows(q: np.ndarray, scales: np.ndarray,
                    block: int = QUANT_BLOCK) -> np.ndarray:
    """Inverse of :func:`quantize_rows` (fp32, up to rounding error)."""
    cols = q.shape[1]
    expand = np.repeat(scales.astype(np.float32), block, axis=1)[:, :cols]
    return q.astype(np.float32) * expand


def bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bit patterns (``uint16``), round to nearest
    even; a NaN becomes ``0x7FC0`` carrying its sign bit."""
    u = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
               >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(arr.astype(np.float32, copy=False))
    if nan.any():
        quiet = np.where((u >> np.uint32(31)) != 0, np.uint16(0xFFC0),
                         np.uint16(0x7FC0)).astype(np.uint16)
        rounded = np.where(nan, quiet, rounded)
    return rounded


def bf16_to_float32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (``uint16``) → float32 (exact)."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def encode_window(arr: np.ndarray, wire_dtype: str,
                  block: int = QUANT_BLOCK
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Encode a window into its wire payload: ``(payload uint8 1-D,
    scales fp32 | None)``.  Raw is a zero-copy byte view; bf16 and int8
    need a float window (:func:`lossy_supported`)."""
    wire_dtype = check_wire_dtype(wire_dtype)
    if wire_dtype == "raw":
        return np.ascontiguousarray(arr).view(np.uint8).reshape(-1), None
    if not lossy_supported(arr.dtype):
        raise ValueError(
            f"lossy wire_dtype {wire_dtype!r} needs a float window, got "
            f"{np.dtype(arr.dtype).name} (use the lossless codec tier)"
        )
    if wire_dtype == "bf16":
        return bf16_bits(arr).view(np.uint8).reshape(-1), None
    q, s = quantize_rows(arr.reshape(arr.shape[0], -1), block)
    return q.view(np.uint8).reshape(-1), s


def decode_window(payload: np.ndarray, scales: Optional[np.ndarray],
                  shape: Tuple[int, ...], dtype: Any, wire_dtype: str,
                  block: int = QUANT_BLOCK, out: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """Decode a wire payload back to the window's shape and dtype, into
    ``out`` when given (decode straight into the serving buffer)."""
    wire_dtype = check_wire_dtype(wire_dtype)
    dtype = np.dtype(dtype)
    n = int(np.prod(shape))
    if wire_dtype == "raw":
        dec = payload[: n * dtype.itemsize].view(dtype).reshape(shape)
    elif wire_dtype == "bf16":
        bits = np.ascontiguousarray(payload[: n * 2]).view(np.uint16)
        dec = bf16_to_float32(bits).astype(dtype).reshape(shape)
    else:
        if scales is None:
            raise DecodeError("int8 wire payload arrived without scales")
        rows = int(shape[0])
        q = payload[:n].view(np.int8).reshape(rows, -1)
        dec = dequantize_rows(q, scales.reshape(rows, -1), block).astype(
            dtype
        ).reshape(shape)
    if out is not None:
        np.copyto(out, dec)
        return out
    return dec


# -- lossless codec seam -------------------------------------------------------


class ZlibCodec:
    """stdlib zlib, always available (levels 1-9).  Decode reads zlib and
    gzip framing both (``wbits=47``)."""

    name = "zlib"

    def encode_bytes(self, data: bytes, level: int) -> bytes:
        return zlib.compress(data, min(max(int(level), 1), 9))

    def decode_bytes(self, data: bytes, max_output: int) -> bytes:
        d = zlib.decompressobj(47)
        try:
            out = d.decompress(data, max_output)
        except zlib.error as e:
            raise DecodeError(f"zlib decode failed: {e}") from e
        if d.unconsumed_tail:
            raise DecodeError(
                f"zlib decode exceeded max_output={max_output} bytes"
            )
        if not d.eof:
            # A truncated stream decompresses to partial output without
            # an exception: it must fail here.
            raise DecodeError(
                f"zlib stream truncated ({len(data)} input bytes, "
                "no end-of-stream marker)"
            )
        return out


class ZstdCodec:
    """zstandard, only where the library is importable."""

    name = "zstd"

    def __init__(self) -> None:
        import zstandard  # raises ImportError where absent

        self._mod = zstandard

    def encode_bytes(self, data: bytes, level: int) -> bytes:
        return self._mod.ZstdCompressor(level=int(level)).compress(data)

    def decode_bytes(self, data: bytes, max_output: int) -> bytes:
        try:
            return self._mod.ZstdDecompressor().decompress(
                data, max_output_size=max_output
            )
        except self._mod.ZstdError as e:
            raise DecodeError(f"zstd decode failed: {e}") from e


class Lz4Codec:
    """lz4.frame, only where the library is importable."""

    name = "lz4"

    def __init__(self) -> None:
        import lz4.frame  # raises ImportError where absent

        self._mod = lz4.frame

    def encode_bytes(self, data: bytes, level: int) -> bytes:
        return self._mod.compress(data, compression_level=int(level))

    def decode_bytes(self, data: bytes, max_output: int) -> bytes:
        try:
            out = self._mod.decompress(data)
        except RuntimeError as e:
            raise DecodeError(f"lz4 decode failed: {e}") from e
        if len(out) > max_output:
            raise DecodeError(
                f"lz4 decode exceeded max_output={max_output} bytes"
            )
        return out


#: name → (constructor, wire code); code 0 is "no codec".
_CODECS = {"zlib": (ZlibCodec, 1), "zstd": (ZstdCodec, 2), "lz4": (Lz4Codec, 3)}
_CODEC_BY_CODE = {code: name for name, (_, code) in _CODECS.items()}


def available_codecs() -> Tuple[str, ...]:
    """Codec names this host can construct."""
    out = []
    for name, (ctor, _) in _CODECS.items():
        try:
            ctor()
        except ImportError:
            continue
        out.append(name)
    return tuple(out)


def get_codec(name: str) -> Any:
    """Construct a codec by name, or raise naming what IS available."""
    if name not in _CODECS:
        raise ValueError(f"unknown codec {name!r}; known: {tuple(_CODECS)}")
    ctor, _ = _CODECS[name]
    try:
        return ctor()
    except ImportError as e:
        raise ValueError(
            f"codec {name!r} needs a library this host lacks ({e}); "
            f"available here: {available_codecs()}"
        ) from e


# -- self-describing exchange payloads -----------------------------------------

#: pack_rows header: magic, version, wire code, codec code, ndim,
#: dtype-name length, scales nbytes, payload nbytes, raw nbytes.
_PACK_MAGIC = 0x44444C58  # "DDLX"
_PACK_FMT = "<IHBBBBQQQ"
_PACK_BYTES = struct.calcsize(_PACK_FMT)


def pack_rows(
    rows: np.ndarray,
    wire_dtype: str = "raw",
    codec: Optional[str] = None,
    level: int = 3,
    block: int = QUANT_BLOCK,
    metrics: Any = None,
) -> np.ndarray:
    """Encode exchange lane rows into one self-describing uint8 array —
    header, shape, dtype name, scales, (compressed) payload — so a peer
    decodes with no out-of-band agreement.  The ``wire.encode`` site
    fires on the bytes past the header."""
    wire_dtype = check_wire_dtype(wire_dtype)
    payload, scales = encode_window(rows, wire_dtype, block)
    raw_nbytes = int(rows.nbytes)
    codec_code = 0
    body = payload.tobytes()
    if codec:
        body = get_codec(codec).encode_bytes(body, level=level)
        codec_code = _CODECS[codec][1]
    scales_b = scales.tobytes() if scales is not None else b""
    dtype_name = np.dtype(rows.dtype).name.encode()
    hdr = struct.pack(
        _PACK_FMT, _PACK_MAGIC, 1, WIRE_CODES[wire_dtype], codec_code,
        rows.ndim, len(dtype_name), len(scales_b), len(body), raw_nbytes,
    )
    shape_b = struct.pack(f"<{rows.ndim}q", *rows.shape)
    buf = np.frombuffer(
        hdr + shape_b + dtype_name + scales_b + body, dtype=np.uint8
    ).copy()
    fault_point("wire.encode", view=buf[_PACK_BYTES:])
    if metrics is not None:
        metrics.incr("wire.encoded_bytes", float(buf.nbytes))
        metrics.incr("wire.payload_bytes", float(raw_nbytes))
    return buf


def unpack_rows(
    buf: np.ndarray,
    max_output: int = DEFAULT_MAX_OUTPUT,
    block: int = QUANT_BLOCK,
    metrics: Any = None,
) -> np.ndarray:
    """Decode a :func:`pack_rows` envelope back to its rows.  Any
    malformed field raises :class:`DecodeError` (the callers' ladders
    catch only that).  The ``wire.decode`` site fires first."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    fault_point("wire.decode", view=buf[_PACK_BYTES:])
    if buf.nbytes < _PACK_BYTES:
        raise DecodeError(f"wire envelope truncated ({buf.nbytes} bytes)")
    raw = buf.tobytes()
    magic, ver, wcode, ccode, ndim, dlen, slen, blen, raw_nbytes = (
        struct.unpack_from(_PACK_FMT, raw)
    )
    if magic != _PACK_MAGIC or ver != 1:
        raise DecodeError(f"bad wire envelope magic/version 0x{magic:08x}/{ver}")
    if wcode not in _CODE_TO_DTYPE:
        raise DecodeError(f"unknown wire code {wcode}")
    off = _PACK_BYTES
    try:
        shape = struct.unpack_from(f"<{ndim}q", raw, off)
        off += 8 * ndim
        dtype = np.dtype(raw[off : off + dlen].decode())
        off += dlen
    except (struct.error, UnicodeDecodeError, TypeError, ValueError) as e:
        raise DecodeError(f"malformed wire envelope header: {e}") from e
    scales_b = raw[off : off + slen]
    off += slen
    body = raw[off : off + blen]
    if len(body) != blen:
        raise DecodeError(
            f"wire envelope payload truncated ({len(body)} < {blen})"
        )
    if ccode:
        name = _CODEC_BY_CODE.get(ccode)
        if name is None:
            raise DecodeError(f"unknown codec code {ccode}")
        body = get_codec(name).decode_bytes(body, max_output=max_output)
    payload = np.frombuffer(body, dtype=np.uint8)
    wire_dtype = _CODE_TO_DTYPE[wcode]
    n = int(np.prod(shape))
    # Every region is length-checked against the shape before any view:
    # exchange envelopes carry no CRC.
    if len(scales_b) != slen or slen != scale_bytes_for(
        tuple(shape), wire_dtype, block
    ):
        raise DecodeError(
            f"wire scales region {len(scales_b)}/{slen} bytes disagrees "
            f"with shape {shape}/{wire_dtype}"
        )
    scales = np.frombuffer(scales_b, dtype=np.float32) if slen else None
    if encoded_nbytes(tuple(shape), dtype, wire_dtype) != payload.nbytes:
        raise DecodeError(
            f"wire payload size {payload.nbytes} disagrees with "
            f"shape {shape}/{dtype.name}/{wire_dtype}"
        )
    if n * dtype.itemsize != raw_nbytes:
        raise DecodeError("wire envelope raw-size field disagrees with shape")
    try:
        rows = decode_window(payload, scales, tuple(shape), dtype,
                             wire_dtype, block)
    except ValueError as e:
        raise DecodeError(f"wire payload decode failed: {e}") from e
    if metrics is not None:
        metrics.incr("wire.decoded_windows")
    return rows


def wire_report(metrics: Any) -> Dict[str, float]:
    """The ``wire.*`` counters of one registry."""
    return {
        "encoded_bytes": metrics.counter("wire.encoded_bytes"),
        "payload_bytes": metrics.counter("wire.payload_bytes"),
        "decoded_windows": metrics.counter("wire.decoded_windows"),
        "fallbacks": metrics.counter("wire.fallbacks"),
        "decode_fails": metrics.counter("wire.decode_fails"),
    }


# -- format economics ----------------------------------------------------------
#
# Moving one raw byte over a link of speed L costs 1/L s raw, and
# 1/enc + ratio/L + 1/dec encoded: the encoded leg wins when
# L < (1 - ratio) / (1/enc + 1/dec).


def measure_wire_stats(
    sample: np.ndarray,
    wire_dtypes: Tuple[str, ...] = ("bf16", "int8"),
    codecs: Tuple[str, ...] = (),
    level: int = 1,
    deadline: Optional[float] = None,
) -> Dict[str, Dict[str, float]]:
    """Time each wire format on ``sample``: ``{fmt: {"ratio",
    "encode_bytes_per_s", "decode_bytes_per_s"}}`` (lossy entries add
    ``max_rel_drift``).  ``deadline`` (an absolute ``time.monotonic()``)
    leaves out the formats not reached before it."""
    sample = np.ascontiguousarray(sample)
    out: Dict[str, Dict[str, float]] = {}
    for wd in wire_dtypes:
        if deadline is not None and time.monotonic() >= deadline:
            break
        if not lossy_supported(sample.dtype):
            break
        t0 = time.perf_counter()
        payload, scales = encode_window(sample, wd)
        t_enc = time.perf_counter() - t0
        enc_bytes = payload.nbytes + (
            scales.nbytes if scales is not None else 0
        )
        t0 = time.perf_counter()
        dec = decode_window(payload, scales, sample.shape, sample.dtype, wd)
        t_dec = time.perf_counter() - t0
        drift = float(
            np.abs(dec - sample).max()
            / max(float(np.abs(sample).max()), 1e-9)
        )
        out[wd] = {
            "ratio": round(enc_bytes / sample.nbytes, 4),
            "encode_bytes_per_s": round(sample.nbytes / max(t_enc, 1e-9), 1),
            "decode_bytes_per_s": round(sample.nbytes / max(t_dec, 1e-9), 1),
            "max_rel_drift": drift,
        }
    raw = sample.tobytes()
    for name in codecs:
        if deadline is not None and time.monotonic() >= deadline:
            break
        if name not in available_codecs():
            continue
        c = get_codec(name)
        t0 = time.perf_counter()
        enc = c.encode_bytes(raw, level=level)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = c.decode_bytes(enc, max_output=2 * len(raw))
        t_dec = time.perf_counter() - t0
        if dec != raw:
            continue  # a corrupting codec never enters the table
        out[f"{name}-l{level}"] = {
            "ratio": round(len(enc) / len(raw), 4),
            "encode_bytes_per_s": round(len(raw) / max(t_enc, 1e-9), 1),
            "decode_bytes_per_s": round(len(raw) / max(t_dec, 1e-9), 1),
        }
    return out


def break_even_table(
    stats: Dict[str, Any],
    link_bytes_per_s: Optional[float] = None,
) -> Dict[str, float]:
    """Per-format break-even link speed (bytes/s): the speed below which
    paying encode + decode beats moving raw bytes.  Only formats that
    shrink (``ratio < 1``); with ``link_bytes_per_s``, only those still
    worth turning on at that link."""
    table: Dict[str, float] = {}
    for fmt, st in stats.items():
        if not isinstance(st, dict) or "ratio" not in st:
            continue
        enc = float(st.get("encode_bytes_per_s", 0.0))
        dec = float(st.get("decode_bytes_per_s", 0.0))
        if enc <= 0 or dec <= 0:
            continue
        denom = 1.0 / enc + 1.0 / dec
        if st["ratio"] < 1.0 and denom > 0:
            threshold = (1.0 - float(st["ratio"])) / denom
            if link_bytes_per_s is None or link_bytes_per_s < threshold:
                table[fmt] = threshold
    return table


def pick_wire_format(stats: Dict[str, Any], link_bytes_per_s: float) -> str:
    """The cheapest format for a link, ``"raw"`` as the floor: the argmin
    of encode + wire + decode time per raw byte."""
    link = max(float(link_bytes_per_s), 1e-9)
    best, best_t = "raw", 1.0 / link
    for fmt, st in sorted(stats.items()):
        if not isinstance(st, dict) or "ratio" not in st:
            continue
        enc = float(st.get("encode_bytes_per_s", 0.0))
        dec = float(st.get("decode_bytes_per_s", 0.0))
        if enc <= 0 or dec <= 0:
            continue
        t = 1.0 / enc + float(st["ratio"]) / link + 1.0 / dec
        if t < best_t:
            best, best_t = fmt, t
    return best
