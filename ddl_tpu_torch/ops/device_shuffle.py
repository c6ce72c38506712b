"""Device-side global shuffle: one exchange round on the card (port of
``ddl_tpu/ops/device_shuffle.py``).

Each instance's exchange block (lane A + lane B, ``2 * half`` rows) lands
once on its ring device; lane A moves forward along the shared
permutation (``i -> p[i]``) and lane B backward (``i -> pinv[i]``) —
byte-identical to the host exchange, because both derive the permutation
from ``exchange_permutation(n, seed, round)`` (``ddl_tpu_torch.shuffle``).

The hand-written CUDA kernel K9 (``csrc/device_shuffle.cu``) replaces the
Pallas ring ``_exchange_kernel``: one launch per round over a table of n
source and n destination block pointers and the ``(2, n)`` routes
``[p, pinv]``, passed as data.  On one card the n ring positions are n
block regions of one allocation (``devices=[cuda:0] * n``); a ring over
several distinct cards is the multi-card slice and raises here.

Beside the kernel:

- :func:`exchange_plain` — the same function in plain torch indexing: the
  path of CPU tensors and the tests' oracle, never the card's path;
- :func:`as_exchange_input` / :func:`exchange_output_blocks` — the H2D
  landing and the D2H hand-back through page-locked staging, one buffer
  set per geometry.  A round runs land, kernel, hand-back on the current
  stream; its caller holds :data:`LANDING_LOCK` from the landing to the
  hand-back, since a geometry's buffers are reused by its next round;
- :func:`plan_exchange` — one round's bytes per lane, device vs host, raw
  vs the wire.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ddl_tpu_torch.concurrency import named_lock
from ddl_tpu_torch.parallel.mesh import one_card

#: Held by a caller from a round's landing to its hand-back: the landing
#: buffers of a geometry are reused by its next round.
LANDING_LOCK = named_lock("shuffle.device.landing")

#: Ring positions one launch addresses (the kernel's parameter table).
MAX_RING = 64

#: The two lanes of one exchange round: lane A along ``p``, lane B along
#: ``pinv``.
_N_LANES = 2

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signature."""
    from ddl_tpu_torch.ops import _build

    lib = _build.load("device_shuffle")
    if not getattr(lib, "_ddl_bound", False):
        lib.ddl_exchange_round.argtypes = [
            _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P,
        ]
        lib.ddl_exchange_round.restype = ctypes.c_int
        lib._ddl_bound = True
    return lib


def _routes(routes: Any, n: int) -> np.ndarray:
    """``[p, pinv]`` as a contiguous (2, n) int32 array whose rows are
    permutations of ``range(n)`` (the kernel reads them unchecked beyond
    their range)."""
    r = np.ascontiguousarray(routes, dtype=np.int32)
    if r.shape != (_N_LANES, n):
        raise ValueError(f"routes must be (2, {n}) [p, pinv], got {r.shape}")
    for row in r:
        if not np.array_equal(np.sort(row), np.arange(n)):
            raise ValueError(f"routes rows must be permutations of range({n})")
    return r


def _block_rows(gin: torch.Tensor, n: int) -> int:
    if gin.dim() != 2 or gin.shape[0] % (_N_LANES * n):
        raise ValueError(
            f"input must be (n * 2*half, cols) with n={n}, got "
            f"{tuple(gin.shape)}"
        )
    return gin.shape[0] // n


def exchange_plain(gin: torch.Tensor, routes: Any) -> torch.Tensor:
    """One exchange round in plain torch indexing: the global input
    ``(n * 2*half, cols)`` → a new tensor where position i's lane A sits
    at ``routes[0][i]`` and its lane B at ``routes[1][i]``."""
    n = np.shape(routes)[1]
    r = torch.as_tensor(_routes(routes, n), dtype=torch.long, device=gin.device)
    rows = _block_rows(gin, n)
    half = rows // _N_LANES
    g = gin.reshape(n, rows, gin.shape[1])
    out = torch.empty_like(g)
    out[r[0], :half] = g[:, :half]
    out[r[1], half:] = g[:, half:]
    return out.reshape(gin.shape)


def exchange_ring(gin: torch.Tensor, devices: Sequence[Any],
                  routes: Any) -> torch.Tensor:
    """K9: one exchange round over the global input ``gin`` (n ring
    positions of ``2*half`` rows each, one allocation), into a new
    tensor, on the current stream.  ``routes`` is the (2, n) ``[p, pinv]``
    of this round (data, not code).  A CPU tensor takes
    :func:`exchange_plain`; a CUDA tensor reaches the kernel or raises."""
    devices = tuple(devices)
    n = len(devices)
    if n == 1:
        return gin
    if gin.device.type == "cpu":
        return exchange_plain(gin, routes)
    if gin.device.type != "cuda":
        raise ValueError(f"unsupported device {gin.device}")
    if one_card(devices) != gin.device:
        raise ValueError(f"ring devices {devices} do not hold the input "
                         f"on {gin.device}")
    if n > MAX_RING:
        raise ValueError(f"the kernel addresses at most {MAX_RING} ring "
                         f"positions, got {n}")
    if not gin.is_contiguous():
        raise ValueError("input must be contiguous")
    r = _routes(routes, n)
    rows = _block_rows(gin, n)
    block_bytes = rows * gin.shape[1] * gin.element_size()
    out = torch.empty_like(gin)
    src = (_P * n)(*(gin.data_ptr() + i * block_bytes for i in range(n)))
    dst = (_P * n)(*(out.data_ptr() + i * block_bytes for i in range(n)))
    rc = _lib().ddl_exchange_round(
        src, dst, r.ctypes.data, n, block_bytes // _N_LANES,
        torch.cuda.current_stream(gin.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "exchange kernel launch failed: "
            + ("unsupported arguments" if rc < 0 else f"CUDA error {rc}")
        )
    exchange_ring.launches += 1
    return out


exchange_ring.launches = 0

#: The kernel wrappers of this module (K9).
KERNELS = (exchange_ring,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# -- landing and hand-back ------------------------------------------------


@dataclasses.dataclass
class _Landing:
    """One geometry's buffers: page-locked host staging for the landing
    and the hand-back, and the device input."""

    host_in: torch.Tensor
    dev: torch.Tensor
    host_out: torch.Tensor


@functools.lru_cache(maxsize=8)
def _landing(device: torch.device, n: int, rows: int, cols: int,
             dtype: torch.dtype) -> _Landing:
    """Cached per geometry, so steady-state rounds allocate nothing; a
    loader cycles a handful of geometries."""
    shape = (n * rows, cols)
    return _Landing(
        host_in=torch.empty(shape, dtype=dtype, pin_memory=True),
        dev=torch.empty(shape, dtype=dtype, device=device),
        host_out=torch.empty(shape, dtype=dtype, pin_memory=True),
    )


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def as_exchange_input(blocks: Sequence[np.ndarray],
                      devices: Sequence[Any]) -> torch.Tensor:
    """Land the per-instance lane blocks ``(2*half, cols)`` on the ring
    and return the global input ``(n * 2*half, cols)`` — the exchange's
    H2D edge.  On a card the rows cross once, through the geometry's
    page-locked staging, on the current stream; on the CPU they are
    stacked."""
    devices = tuple(devices)
    n = len(devices)
    if len(blocks) != n:
        raise ValueError(f"need one lane block per ring position ({n}), "
                         f"got {len(blocks)}")
    rows, cols = blocks[0].shape
    for b in blocks:
        if b.shape != (rows, cols) or b.dtype != blocks[0].dtype:
            raise ValueError("lane blocks must share shape and dtype")
    device = one_card(devices)
    if device.type == "cpu":
        return torch.from_numpy(np.concatenate(blocks))
    buf = _landing(device, n, rows, cols, _torch_dtype(blocks[0].dtype))
    staged = buf.host_in.numpy()
    for i, b in enumerate(blocks):
        staged[i * rows:(i + 1) * rows] = b
    buf.dev.copy_(buf.host_in, non_blocking=True)
    return buf.dev


def exchange_output_blocks(out: torch.Tensor,
                           devices: Sequence[Any]) -> List[np.ndarray]:
    """Fetch the exchanged lane blocks back to the host, one per ring
    position — the D2H edge where the fabric hands rows back to each
    producer's pool.  Waits for the current stream, so a fault of the
    round's kernel surfaces here.  The arrays are the caller's own (never
    views of a staging buffer the geometry's next round reuses)."""
    n = len(tuple(devices))
    rows = out.shape[0] // n
    if out.device.type == "cpu":
        host = out.numpy()
        return [host[i * rows:(i + 1) * rows] for i in range(n)]
    buf = _landing(out.device, n, rows, out.shape[1], out.dtype)
    buf.host_out.copy_(out, non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    host = buf.host_out.numpy()
    return [host[i * rows:(i + 1) * rows].copy() for i in range(n)]


# -- accounting -------------------------------------------------------------


def exchange_wire_bytes(n: int, half: int, cols: int, dtype: Any) -> int:
    """Raw bytes one round moves between ring positions: two lanes of
    ``half`` rows per position."""
    if n <= 1 or half < 1:
        return 0
    return _N_LANES * n * half * cols * np.dtype(dtype).itemsize


def plan_exchange(n: int, num_exchange: int, cols: int, dtype: Any,
                  wire_dtype: Optional[str] = None,
                  n_devices: Optional[int] = None) -> Dict[str, Any]:
    """Price one exchange round, per lane, device vs host (the JAX
    package's plan, field for field).  The host path's lanes may ride
    the wire: a row costs the encoded row plus its scales
    (``parallel.ici.wire_cols``); the device legs move raw rows.
    ``plannable`` is False for a single instance, an exchange with no
    lane rows, or fewer ring devices than instances."""
    from ddl_tpu_torch import wire as _wire
    from ddl_tpu_torch.parallel.ici import wire_cols

    dtype = np.dtype(dtype)
    half = num_exchange // 2
    wd = _wire.resolve_wire_dtype(wire_dtype)
    if wd != "raw" and not _wire.lossy_supported(dtype):
        wd = "raw"
    raw_row = cols * dtype.itemsize
    host_row = wire_cols(cols, dtype, wd)
    legs = []
    for lane in ("lane_a", "lane_b"):
        legs.append({
            "leg": lane,
            "rows": n * half,
            "ici_bytes": n * half * raw_row,
            "host_bytes_raw": n * half * raw_row,
            "host_bytes_wire": n * half * host_row,
        })
    plannable = n >= 2 and half >= 1
    why = None
    if n < 2:
        why = "single instance: nothing to exchange"
    elif half < 1:
        why = f"num_exchange {num_exchange} leaves no lane rows"
    if plannable and n_devices is not None and n_devices < n:
        plannable = False
        why = f"ring needs {n} devices for {n} instances, have {n_devices}"
    return {
        "plannable": plannable,
        "why_not": why,
        "n": n,
        "half": half,
        "cols": cols,
        "dtype": dtype.name,
        "wire_dtype": wd,
        "legs": legs,
        "ici_bytes": sum(leg["ici_bytes"] for leg in legs),
        "host_bytes_raw": sum(leg["host_bytes_raw"] for leg in legs),
        "host_bytes_wire": sum(leg["host_bytes_wire"] for leg in legs),
    }
