"""The ICI ingest tier's fan-out kernels (port of
``ddl_tpu/ops/ici_fanout.py``).

One anchor position's window, a 2-D ``(rows, cols)`` block, is
replicated (K7, ring broadcast) or sharded (K8, ring scatter) across a
1-axis ring of mesh positions.  The results are :class:`~ddl_tpu_torch.
parallel.mesh.ShardedArray` s over the ring, in the reference's layout:
a global ``(n * rows, cols)`` (replicate; :func:`replicated_view`
reinterprets it as one replicated ``(rows, cols)`` array) or ``(rows,
cols)`` (shard) array split ``P("x")``, ring position ``i`` holding
block ``i``.

The hand-written CUDA kernels (``csrc/ici_fanout.cu``) replace the Pallas
rings ``_bcast_kernel`` and ``_scatter_kernel``: one launch each, over a
table of destination pointers, copying straight from the anchor tensor
into freshly allocated position tensors.  K7's source position keeps the
anchor tensor itself (zero copy).  On one card the ring positions are
regions of one device (``devices=["cuda:0"] * n``); a ring over several
distinct cards is the multi-card slice and raises.

Beside each kernel, its plain version (:func:`replicate_plain`,
:func:`shard_plain`): the path of CPU tensors and the tests' oracle.  A
CUDA tensor reaches the kernel or raises.  The pricing
(:func:`wire_bytes`, :func:`payload_bytes`, :func:`bcast_grid`) is the
reference's, verbatim: the planner prices the ICI ring the reference
runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ddl_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    ShardedArray,
    one_card,
)

#: The fan-out ring's private mesh axis (always 1-axis; the
#: redistribution planner owns the mapping onto dp x fsdp x tp).
AXIS = "x"

#: Default chunk count of the reference's broadcast pipeline.  Only the
#: plan prices it: a one-card launch has no pipeline to deepen.
DEFAULT_CHUNKS = 4

#: Landing slots the reference's fused dispatch keeps in flight at once.
#: Only the plan prices them: a one-card launch allocates fresh outputs.
N_SLOTS = 2

#: Ring positions one launch addresses (the kernel's parameter table).
MAX_RING = 64

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    from ddl_tpu_torch.ops import _build

    lib = _build.load("ici_fanout")
    if not getattr(lib, "_ddl_bound", False):
        lib.ddl_fanout_replicate.argtypes = [
            _P, _P, ctypes.c_int, ctypes.c_longlong, _P,
        ]
        lib.ddl_fanout_replicate.restype = ctypes.c_int
        lib.ddl_fanout_shard.argtypes = [
            _P, _P, ctypes.c_int, ctypes.c_longlong, _P,
        ]
        lib.ddl_fanout_shard.restype = ctypes.c_int
        lib._ddl_bound = True
    return lib


# -- geometry helpers (the reference's pricing, verbatim) --------------------


def bcast_grid(n_dev: int, n_chunks: int) -> int:
    """Broadcast pipeline depth: chunk c reaches ring position p at step
    p + c - 1, so the tail's last chunk lands at step n_dev + n_chunks - 3."""
    return n_chunks + n_dev - 2


def wire_bytes(mode: str, nbytes: int, n_dev: int,
               n_chunks: int = DEFAULT_CHUNKS,
               rows: Optional[int] = None) -> int:
    """Total bytes the reference's fan-out ring moves over its links
    (clamped edge repeats and sink-chunk wrap sends included).  Pass
    ``rows`` (the 2D view's leading dim) when known: the broadcast pads
    rows up to a chunk multiple and every send moves whole padded
    chunks."""
    if n_dev <= 1:
        return 0
    if mode == "replicate":
        if rows:
            # ceil(rows/n_chunks) whole rows per chunk-send.
            chunk = -(-rows // n_chunks) * (nbytes // rows)
        else:
            chunk = -(-nbytes // n_chunks)
        return n_dev * bcast_grid(n_dev, n_chunks) * chunk
    if mode == "shard":
        block = nbytes // n_dev
        return n_dev * (n_dev - 1) * block
    raise ValueError(f"mode must be replicate|shard, got {mode!r}")


def payload_bytes(mode: str, nbytes: int, n_dev: int) -> int:
    """Bytes usefully delivered by the fan-out: n-1 windows for
    replicate, the off-source blocks for shard."""
    if n_dev <= 1:
        return 0
    if mode == "replicate":
        return (n_dev - 1) * nbytes
    if mode == "shard":
        return nbytes - nbytes // n_dev
    raise ValueError(f"mode must be replicate|shard, got {mode!r}")


# -- the ring as a sharded array ---------------------------------------------


@functools.lru_cache(maxsize=32)
def _ring_mesh(devices: Tuple[str, ...]) -> Mesh:
    return Mesh(list(devices), (AXIS,))


def _ring(devices: Sequence[Any]) -> Tuple[str, ...]:
    return tuple(str(torch.device(d)) for d in devices)


def _check_block(block: torch.Tensor, devices: Tuple[str, ...],
                 src: int) -> None:
    """A 2-D block on the ring's one device, with ``src`` a ring
    position; a CUDA block must be contiguous (the kernels read it
    flat)."""
    if block.dim() != 2:
        raise ValueError(f"the fan-out takes a 2-D block, got {tuple(block.shape)}")
    if not 0 <= src < len(devices):
        raise ValueError(f"src {src} is not a position of the "
                         f"{len(devices)}-position ring")
    device = one_card(devices)
    if block.device != device:
        raise ValueError(f"ring devices {list(devices)} do not hold the "
                         f"block on {block.device}")
    if block.device.type == "cuda":
        if len(devices) > MAX_RING:
            raise ValueError(f"the kernels address at most {MAX_RING} ring "
                             f"positions, got {len(devices)}")
        if not block.is_contiguous():
            raise ValueError("the block must be contiguous")


def _pointers(tensors: Sequence[torch.Tensor]):
    return (_P * len(tensors))(*(t.data_ptr() for t in tensors))


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            + ("unsupported arguments" if rc < 0 else f"CUDA error {rc}")
        )


def replicate_plain(block: torch.Tensor, n: int, src: int = 0) -> List[torch.Tensor]:
    """K7's function in plain torch: every ring position's copy of the
    block (the source position keeps ``block`` itself)."""
    return [block if i == src else block.clone() for i in range(n)]


def shard_plain(block: torch.Tensor, n: int) -> List[torch.Tensor]:
    """K8's function in plain torch: ring position ``i``'s own copy of
    row-block ``i``."""
    rows = block.shape[0] // n
    return [block[i * rows:(i + 1) * rows].clone() for i in range(n)]


def fanout_replicate(block: torch.Tensor, devices: Sequence[Any],
                     src: int = 0) -> ShardedArray:
    """K7: broadcast a ``(rows, cols)`` block to every ring position, on
    the current stream.

    ``block`` lives on ring position ``src``.  Returns a global ``(n *
    rows, cols)`` array split ``P("x")`` over the ring, every block
    byte-identical to the source (see :func:`replicated_view`); the
    source position's block is ``block`` itself.
    """
    ring = _ring(devices)
    n = len(ring)
    _check_block(block, ring, src)
    if n == 1:
        blocks = [block]
    elif block.device.type == "cpu":
        blocks = replicate_plain(block, n, src)
    else:
        blocks = [block if i == src else torch.empty_like(block)
                  for i in range(n)]
        dsts = [b for i, b in enumerate(blocks) if i != src]
        _raise_on(_lib().ddl_fanout_replicate(
            block.data_ptr(), _pointers(dsts), len(dsts),
            block.numel() * block.element_size(),
            torch.cuda.current_stream(block.device).cuda_stream,
        ), "fan-out replicate")
        fanout_replicate.launches += 1
    rows, cols = block.shape
    return ShardedArray((n * rows, cols),
                        NamedSharding(_ring_mesh(ring), P(AXIS)), blocks)


def fanout_shard(block: torch.Tensor, devices: Sequence[Any],
                 src: int = 0) -> ShardedArray:
    """K8: scatter a ``(rows, cols)`` block over the ring, on the current
    stream: row-block ``i`` lands on ring position ``i``, for any
    ``src``.  ``rows`` must divide by the ring size (the planner
    guarantees it or takes the plain route).  Returns a global ``(rows,
    cols)`` array split ``P("x")``, each position's block its own
    contiguous tensor (``block`` itself on a one-position ring)."""
    ring = _ring(devices)
    n = len(ring)
    _check_block(block, ring, src)
    rows, cols = block.shape
    if rows % n:
        raise ValueError(
            f"shard fan-out needs rows ({rows}) divisible by the ring "
            f"size ({n})"
        )
    if n == 1:
        blocks = [block]
    elif block.device.type == "cpu":
        blocks = shard_plain(block, n)
    else:
        blocks = [torch.empty((rows // n, cols), dtype=block.dtype,
                              device=block.device) for _ in range(n)]
        _raise_on(_lib().ddl_fanout_shard(
            block.data_ptr(), _pointers(blocks), n,
            blocks[0].numel() * block.element_size(),
            torch.cuda.current_stream(block.device).cuda_stream,
        ), "fan-out shard")
        fanout_shard.launches += 1
    return ShardedArray((rows, cols),
                        NamedSharding(_ring_mesh(ring), P(AXIS)), blocks)


fanout_replicate.launches = 0
fanout_shard.launches = 0

#: The kernel wrappers of this module (K7, K8).
KERNELS = (fanout_replicate, fanout_shard)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def replicated_view(out: ShardedArray, devices: Sequence[Any]) -> ShardedArray:
    """Reinterpret a block-per-position broadcast result ``(n * rows,
    cols)`` as ONE replicated ``(rows, cols)`` array — zero copy: the
    per-position blocks become the replicas."""
    ring = _ring(devices)
    rows = out.shape[0] // len(ring)
    return ShardedArray((rows, out.shape[1]),
                        NamedSharding(_ring_mesh(ring), P(None, None)),
                        [s.data for s in out.shards])
