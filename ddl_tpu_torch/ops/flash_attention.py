"""Causal flash attention (port of ``ddl_tpu/ops/flash_attention.py``).

Hand-written CUDA kernels replace the Pallas TPU kernels: K1 the
online-softmax forward (``_fwd_kernel``), K2 the dQ backward
(``_dq_kernel``) and K3 the dK/dV backward (``_dkv_kernel``); K4-K6 are
the same kernels with the packed-segment mask (``_fwd_kernel_seg``,
``_dq_kernel_seg``, ``_dkv_kernel_seg``), behind their own wrappers as the
JAX package keeps separate ``_seg`` entry points.  Each kernel has one
route per dtype:

- the forward (K1/K4): bf16 takes the wgmma + TMA kernel of
  ``csrc/flash_fwd_sm90.cu`` (which also skips key tiles whose document
  ids cannot meet the query tile's, :func:`live_tiles`), fp32 the exact
  FMA kernel of ``csrc/flash_attention.cu``;
- the dQ backward (K2/K5): bf16 takes the wgmma + TMA kernel of
  ``csrc/flash_bwd_sm90.cu`` (dQ of a query tile in registers; K5 skips
  key tiles whose ids cannot meet the query tile's, at the forward's tiles:
  :func:`live_tiles`), fp32 the FMA kernel of ``csrc/flash_attention.cu``;
- the dK/dV backward (K3/K6): bf16 takes the wgmma + TMA kernel of
  ``csrc/flash_bwd_sm90.cu`` (the GQA group summed in registers; K6 skips
  query tiles whose ids cannot meet the key tile's, :func:`live_tiles_dkv`),
  fp32 the FMA kernel of ``csrc/flash_attention.cu``.

``torch.autograd.Function`` carries the gradient, as ``jax.custom_vjp``
did; ``delta = rowsum(dO * O)`` stays plain torch outside the kernels, as
in the JAX package.

Beside the kernels, :func:`attention_plain` is the same function written
densely in PyTorch — masked with the same finite ``-1e30``, the same
empty-row rule, returning ``(out, lse)``, differentiated by autograd.
The public wrappers take it only for tensors on the CPU; a CUDA tensor
reaches the kernels or raises.  Each kernel wrapper counts its launches
(``.launches``), so a run can show that it went through the kernel, and
the launches its bf16 wgmma kernel served (``.sm90_launches``), so a run
shows which route it took.

Layouts follow the JAX package: q ``(B, T, H, D)``, k/v compact GQA
``(B, T, H / kv_repeat, D)``, lse ``(B, H, T)`` fp32, segment ids
``(B, Tq)`` / ``(B, Tk)`` (int32, contiguous, for the kernels).  Head dims
16, 32, 64 and 128; the bf16 wgmma kernels' TMA also needs q, k, v (and
the backward's ``dout``) 16-byte aligned.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_NEG_INF = -1e30
#: Head dims the kernels are instantiated for.
HEAD_DIMS = (16, 32, 64, 128)
#: Query rows and key rows of the bf16 forward's tiles (flash_fwd_sm90.cu's
#: BQ and BK), which the bf16 dQ backward shares (flash_bwd_sm90.cu's DQ_BQ
#: and DQ_BK); both kernels' tile counters hold :func:`live_tiles` to them.
SM90_BLOCK_Q = 128
SM90_BLOCK_K = 128
#: Query rows and key rows of the bf16 dK/dV backward's tiles
#: (flash_bwd_sm90.cu's BQ and BK; its tile counter holds
#: :func:`live_tiles_dkv` to them).
SM90_DKV_BLOCK_Q = 64
SM90_DKV_BLOCK_K = 128
_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    """The fp32 kernel library, built at first use, with its C
    signatures."""
    from ddl_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_ddl_bound", False):
        geom = [_I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
        fwd, dq, dkv = [_P] * 5, [_P] * 8, [_P] * 9
        ids = [_P, _P]
        for fn, args in (
            (lib.ddl_flash_fwd, fwd), (lib.ddl_flash_bwd_dq, dq),
            (lib.ddl_flash_bwd_dkv, dkv), (lib.ddl_flash_fwd_seg, fwd + ids),
            (lib.ddl_flash_bwd_dq_seg, dq + ids),
            (lib.ddl_flash_bwd_dkv_seg, dkv + ids),
        ):
            fn.argtypes = args + geom
            fn.restype = _I
        lib._ddl_bound = True
    return lib


def _lib_sm90() -> ctypes.CDLL:
    """The bf16 forward's library, built at first use."""
    from ddl_tpu_torch.ops import _build

    lib = _build.load("flash_fwd_sm90")
    if not getattr(lib, "_ddl_bound", False):
        lib.ddl_flash_fwd_sm90.argtypes = (
            [_P] * 9 + [_I] * 9 + [_F, _P])
        lib.ddl_flash_fwd_sm90.restype = _I
        lib._ddl_bound = True
    return lib


def _lib_sm90_bwd() -> ctypes.CDLL:
    """The bf16 backward's library (dK/dV and dQ), built at first use."""
    from ddl_tpu_torch.ops import _build

    lib = _build.load("flash_bwd_sm90")
    if not getattr(lib, "_ddl_bound", False):
        lib.ddl_flash_bwd_dkv_sm90.argtypes = (
            [_P] * 13 + [_I] * 9 + [_F, _P])
        lib.ddl_flash_bwd_dkv_sm90.restype = _I
        lib.ddl_flash_bwd_dkv_sm90_scratch.argtypes = [_I] * 5
        lib.ddl_flash_bwd_dkv_sm90_scratch.restype = ctypes.c_longlong
        lib.ddl_flash_bwd_dq_sm90.argtypes = (
            [_P] * 12 + [_I] * 9 + [_F, _P])
        lib.ddl_flash_bwd_dq_sm90.restype = _I
        lib.ddl_flash_bwd_dq_sm90_scratch.argtypes = [_I] * 4
        lib.ddl_flash_bwd_dq_sm90_scratch.restype = ctypes.c_longlong
        lib._ddl_bound = True
    return lib


_ERRORS = {-1: "unsupported arguments",
           -2: "the CUDA driver's tensor-map encoder is missing or "
               "refused a map"}


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _ERRORS.get(rc, f"CUDA error {rc}"))


def _validate(q, k, v) -> Tuple[int, int, int, int, int, int]:
    """Shapes, device, dtype and layout the kernels take; raises on the
    rest.  Returns (B, Tq, Tk, H, Hkv, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError("q, k and v must share dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, T, heads, D), got {tuple(t.shape)}")
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} unsupported (kernels take {HEAD_DIMS})")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    return B, Tq, Tk, H, Hkv, D


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _validate_ids(q, k, seg_q, seg_k) -> Tuple[int, int]:
    """Segment ids the packed kernels take: int32, contiguous, ``(B, Tq)``
    and ``(B, Tk)``, on q's device; raises on the rest.  Returns their
    data pointers."""
    B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
    for name, t, T in (("seg_q", seg_q, Tq), ("seg_k", seg_k, Tk)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != (B, T):
            raise ValueError(f"{name} must be {(B, T)}, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return seg_q.data_ptr(), seg_k.data_ptr()


def _validate_visited(visited, q, tiles: str) -> None:
    """``visited``, where given, is a one-element int64 tensor on q's card
    and the inputs are bf16 (only the wgmma kernels count tiles)."""
    if visited is not None and (
            q.dtype != torch.bfloat16 or visited.dtype != torch.int64
            or visited.numel() != 1 or visited.device != q.device):
        raise ValueError(f"visited counts the bf16 kernel's {tiles}: a "
                         f"one-element int64 tensor on {q.device}, with bf16 "
                         "inputs")


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the TMA "
                             f"copies, got address {t.data_ptr():#x}")


def _fwd(q, k, v, q_offset, k_offset, causal, seg, visited):
    """Launch K1 (``seg is None``) or K4 (``seg = (seg_q, seg_k)``): the
    wgmma kernel for bf16, the FMA kernel for fp32.  Returns ``(out, lse,
    sm90)``, ``sm90`` telling which route ran."""
    B, Tq, Tk, H, Hkv, D = _validate(q, k, v)
    ids = () if seg is None else _validate_ids(q, k, *seg)
    _validate_visited(visited, q, "key tiles")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        return (*_fwd_sm90(q, k, v, out, lse, ids, q_offset, k_offset,
                           causal, visited), True)
    lib = _lib()
    rc = (lib.ddl_flash_fwd if seg is None else lib.ddl_flash_fwd_seg)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *ids, B, Tq, Tk, H, Hkv, D,
        int(q_offset), int(k_offset), int(bool(causal)), 1.0 / (D ** 0.5),
        _stream(q),
    )
    _check(rc, "flash forward")
    return out, lse, False


def _fwd_sm90(q, k, v, out, lse, ids, q_offset, k_offset, causal, visited):
    """Launch the bf16 wgmma kernel (and, for K4, its id-range pre-pass
    into a scratch of ``2 * B * (ceil(Tq / 64) + ceil(Tk / 128))`` int32)."""
    _check_aligned(q=q, k=k, v=v)
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    ranges = None
    if ids:
        n = 2 * B * (-(-Tq // 64) + -(-Tk // SM90_BLOCK_K))
        ranges = torch.empty(n, dtype=torch.int32, device=q.device)
    rc = _lib_sm90().ddl_flash_fwd_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *(ids or (None, None)),
        None if ranges is None else ranges.data_ptr(),
        None if visited is None else visited.data_ptr(), B, Tq, Tk, H, Hkv, D,
        int(q_offset), int(k_offset), int(bool(causal)), 1.0 / (D ** 0.5),
        _stream(q),
    )
    _check(rc, "flash forward (sm90)")
    return out, lse


def live_tiles(seg_q, seg_k, q_offset=0, k_offset=0, causal=True):
    """Which (query tile, key tile) pairs the bf16 packed forward visits:
    ``(B, ceil(Tq / SM90_BLOCK_Q), ceil(Tk / SM90_BLOCK_K))`` bool.

    A pair is visited when the causal loop reaches it (key tile j while
    ``j * BK <= q_offset + q0 + BQ - 1 - k_offset``, ``q0`` the tile's
    first row) and the tiles' id ranges ``[min, max]`` overlap.  A pair
    with ``seg_q[q] == seg_k[k]`` puts that id in both ranges, so no pair
    the masks allow is ever skipped, whatever the ids.  The plain
    statement of the kernel's rule, on any device; with ids all equal it
    gives the tiles of the causal loop alone (what K1 visits).  The bf16
    packed dQ backward (K5) loads the same key tiles for each query tile
    (K2 those of the causal loop), once per query head.
    """
    return _live_pairs(seg_q, seg_k, q_offset, k_offset, causal,
                       SM90_BLOCK_Q, SM90_BLOCK_K)


def live_tiles_dkv(seg_q, seg_k, q_offset=0, k_offset=0, causal=True):
    """Which (key tile, query tile) pairs the bf16 packed dK/dV backward
    visits: ``(B, ceil(Tk / SM90_DKV_BLOCK_K), ceil(Tq / SM90_DKV_BLOCK_Q))``
    bool.

    The forward's rule transposed, at the backward's tiles: a key tile
    loads query tile i from the causal diagonal on (``q_offset + q0 + BQ -
    1 >= k_offset + k0``) when the tiles' id ranges overlap, so no pair the
    masks allow is ever skipped.  With ids all equal it gives the causal
    loop alone (what K3 visits).  The kernel visits these tiles once per
    query head.
    """
    return _live_pairs(seg_q, seg_k, q_offset, k_offset, causal,
                       SM90_DKV_BLOCK_Q, SM90_DKV_BLOCK_K).transpose(1, 2)


def _live_pairs(seg_q, seg_k, q_offset, k_offset, causal, block_q, block_k):
    """``(B, n_query_tiles, n_key_tiles)``: the causal loop's tile pairs
    (key tile first row <= query tile last row, in global positions) whose
    id ranges overlap."""
    seg_q, seg_k = torch.as_tensor(seg_q), torch.as_tensor(seg_k)

    def ranges(ids, block):
        B, T = ids.shape
        n = -(-T // block)
        pad = n * block - T
        ids = ids.to(torch.int64)
        lo = torch.nn.functional.pad(ids, (0, pad), value=2 ** 62)
        hi = torch.nn.functional.pad(ids, (0, pad), value=-(2 ** 62))
        return (lo.view(B, n, block).amin(-1), hi.view(B, n, block).amax(-1))

    q_lo, q_hi = ranges(seg_q, block_q)
    k_lo, k_hi = ranges(seg_k, block_k)
    live = ((q_lo[:, :, None] <= k_hi[:, None, :])
            & (k_lo[:, None, :] <= q_hi[:, :, None]))
    if causal:
        dev = live.device
        q_last = q_offset + torch.arange(live.shape[1], device=dev) * block_q \
            + block_q - 1 - k_offset
        k_first = torch.arange(live.shape[2], device=dev) * block_k
        live &= (k_first[None, :] <= q_last[:, None])[None]
    return live


def _bwd_dq(q, k, v, dout, lse, delta, dlse, q_offset, k_offset, causal, seg,
            visited):
    """Launch K2 or K5: the wgmma kernel for bf16, the FMA kernel for fp32.
    Returns ``(dq, sm90)``, ``sm90`` telling which route ran."""
    B, Tq, Tk, H, Hkv, D = _validate(q, k, v)
    _validate_rows(dout, q, lse, delta, dlse)
    ids = () if seg is None else _validate_ids(q, k, *seg)
    _validate_visited(visited, q, "key tiles")
    dq = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        return _bwd_dq_sm90(q, k, v, dout, lse, delta, dlse, dq, ids, q_offset,
                            k_offset, causal, visited), True
    lib = _lib()
    rc = (lib.ddl_flash_bwd_dq if seg is None else lib.ddl_flash_bwd_dq_seg)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(),
        dq.data_ptr(), *ids, B, Tq, Tk, H, Hkv, D, int(q_offset),
        int(k_offset), int(bool(causal)), 1.0 / (D ** 0.5), _stream(q),
    )
    _check(rc, "flash dq")
    return dq, False


def _bwd_dq_sm90(q, k, v, dout, lse, delta, dlse, dq, ids, q_offset, k_offset,
                 causal, visited):
    """Launch the bf16 wgmma dQ kernel and, for K5, its pre-passes (the
    padded key ids and the id ranges) into a byte scratch the library
    sizes."""
    _check_aligned(q=q, k=k, v=v, dout=dout)
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    lib = _lib_sm90_bwd()
    scratch = None
    if ids:
        scratch = torch.empty(lib.ddl_flash_bwd_dq_sm90_scratch(B, Tq, Tk, 1),
                              dtype=torch.uint8, device=q.device)
    rc = lib.ddl_flash_bwd_dq_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(), dq.data_ptr(),
        *(ids or (None, None)), None if scratch is None else scratch.data_ptr(),
        None if visited is None else visited.data_ptr(), B, Tq, Tk, H, Hkv, D,
        int(q_offset), int(k_offset), int(bool(causal)), 1.0 / (D ** 0.5),
        _stream(q),
    )
    _check(rc, "flash dq (sm90)")
    return dq


def _bwd_dkv(q, k, v, dout, lse, delta, dlse, q_offset, k_offset, causal,
             seg, visited):
    """Launch K3 or K6: the wgmma kernel for bf16, the FMA kernel for fp32.
    Returns ``(dk, dv, sm90)``, ``sm90`` telling which route ran."""
    B, Tq, Tk, H, Hkv, D = _validate(q, k, v)
    _validate_rows(dout, q, lse, delta, dlse)
    ids = () if seg is None else _validate_ids(q, k, *seg)
    _validate_visited(visited, q, "query tiles")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.dtype == torch.bfloat16:
        return (*_bwd_dkv_sm90(q, k, v, dout, lse, delta, dlse, dk, dv, ids,
                               q_offset, k_offset, causal, visited), True)
    lib = _lib()
    rc = (lib.ddl_flash_bwd_dkv if seg is None else lib.ddl_flash_bwd_dkv_seg)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *ids, B, Tq, Tk, H, Hkv, D,
        int(q_offset), int(k_offset), int(bool(causal)), 1.0 / (D ** 0.5),
        _stream(q),
    )
    _check(rc, "flash dkv")
    return dk, dv, False


def _bwd_dkv_sm90(q, k, v, dout, lse, delta, dlse, dk, dv, ids, q_offset,
                  k_offset, causal, visited):
    """Launch the bf16 wgmma dK/dV kernel and its pre-passes (the row
    terms and, for K6, the id ranges) into a byte scratch the library
    sizes."""
    _check_aligned(q=q, k=k, v=v, dout=dout)
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    lib = _lib_sm90_bwd()
    scratch = torch.empty(
        lib.ddl_flash_bwd_dkv_sm90_scratch(B, Tq, Tk, H, int(bool(ids))),
        dtype=torch.uint8, device=q.device)
    rc = lib.ddl_flash_bwd_dkv_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *(ids or (None, None)), scratch.data_ptr(),
        None if visited is None else visited.data_ptr(), B, Tq, Tk, H, Hkv, D,
        int(q_offset), int(k_offset), int(bool(causal)), 1.0 / (D ** 0.5),
        _stream(q),
    )
    _check(rc, "flash dkv (sm90)")
    return dk, dv


def flash_fwd(q, k, v, q_offset=0, k_offset=0, causal=True, visited=None):
    """K1: ``(out, lse)`` of causal GQA attention, on the current stream.
    ``visited`` (bf16 only): a one-element int64 tensor on the card that
    gains the number of key tiles the kernel loads, summed over every
    (batch row, head, query tile)."""
    out, lse, sm90 = _fwd(q, k, v, q_offset, k_offset, causal, None, visited)
    flash_fwd.launches += 1
    flash_fwd.sm90_launches += sm90
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, dlse, q_offset=0, k_offset=0,
                 causal=True, visited=None):
    """K2: dQ from the saved lse, ``delta = rowsum(dO * O)`` and the lse
    cotangent ``dlse`` (all ``(B, H, Tq)`` fp32).  ``visited`` (bf16
    only): a one-element int64 tensor on the card that gains the number of
    key tiles the kernel loads, summed over every (batch row, head, query
    tile)."""
    dq, sm90 = _bwd_dq(q, k, v, dout, lse, delta, dlse, q_offset, k_offset,
                       causal, None, visited)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.sm90_launches += sm90
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, dlse, q_offset=0, k_offset=0,
                  causal=True, visited=None):
    """K3: ``(dk, dv)`` in the compact GQA layout, summed over each KV
    head's query-head group inside the kernel.  ``visited`` (bf16 only): a
    one-element int64 tensor on the card that gains the number of query
    tiles the kernel loads, summed over every (batch row, KV head, key
    tile)."""
    dk, dv, sm90 = _bwd_dkv(q, k, v, dout, lse, delta, dlse, q_offset,
                            k_offset, causal, None, visited)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.sm90_launches += sm90
    return dk, dv


def flash_fwd_seg(q, k, v, seg_q, seg_k, q_offset=0, k_offset=0, causal=True,
                  visited=None):
    """K4: K1 that also masks ``seg_q[q] != seg_k[k]`` (packed documents);
    ``visited`` as for K1 counts the key tiles its skip leaves to load."""
    out, lse, sm90 = _fwd(q, k, v, q_offset, k_offset, causal, (seg_q, seg_k),
                          visited)
    flash_fwd_seg.launches += 1
    flash_fwd_seg.sm90_launches += sm90
    return out, lse


def flash_bwd_dq_seg(q, k, v, dout, lse, delta, dlse, seg_q, seg_k,
                     q_offset=0, k_offset=0, causal=True, visited=None):
    """K5: K2 under the packed-segment mask; ``visited`` as for K2 counts
    the key tiles its skip leaves to load."""
    dq, sm90 = _bwd_dq(q, k, v, dout, lse, delta, dlse, q_offset, k_offset,
                       causal, (seg_q, seg_k), visited)
    flash_bwd_dq_seg.launches += 1
    flash_bwd_dq_seg.sm90_launches += sm90
    return dq


def flash_bwd_dkv_seg(q, k, v, dout, lse, delta, dlse, seg_q, seg_k,
                      q_offset=0, k_offset=0, causal=True, visited=None):
    """K6: K3 under the packed-segment mask; ``visited`` as for K3 counts
    the query tiles its skip leaves to load."""
    dk, dv, sm90 = _bwd_dkv(q, k, v, dout, lse, delta, dlse, q_offset,
                            k_offset, causal, (seg_q, seg_k), visited)
    flash_bwd_dkv_seg.launches += 1
    flash_bwd_dkv_seg.sm90_launches += sm90
    return dk, dv


#: The kernel wrappers, in K1..K6 order.
KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv,
           flash_fwd_seg, flash_bwd_dq_seg, flash_bwd_dkv_seg)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.sm90_launches = 0


reset_launch_counts()


def _validate_rows(dout, q, lse, delta, dlse) -> None:
    if dout.shape != q.shape or dout.dtype != q.dtype or not dout.is_contiguous():
        raise ValueError("dout must match q in shape, dtype and layout")
    rows = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta), ("dlse", dlse)):
        if (tuple(t.shape) != rows or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 {rows} on {q.device}")


def _bwd_rows(dout, out, dlse):
    """The backward's row terms: contiguous, 16-byte aligned ``dout`` (a
    copy where autograd hands a view off alignment; the bf16 kernel's TMA
    needs it), ``delta_i = rowsum(dO_i * O_i)`` (the softmax-jacobian
    diagonal term) and the lse cotangent, both ``(B, H, T)`` fp32."""
    dout = dout.contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return dout, delta, dlse.float().contiguous()


class _FlashAttention(torch.autograd.Function):
    """K1-K3 as one differentiable op returning ``(out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal):
        out, lse = flash_fwd(q, k, v, q_offset, k_offset, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_offset, k_offset, causal)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout, delta, dlse = _bwd_rows(dout, out, dlse)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, dlse, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, dlse, *ctx.args)
        return dq, dk, dv, None, None, None


class _FlashAttentionSeg(torch.autograd.Function):
    """K4-K6 as one differentiable op returning ``(out, lse)``; the
    segment ids get no gradient (JAX gives them a float0 cotangent)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, q_offset, k_offset, causal):
        out, lse = flash_fwd_seg(q, k, v, seg_q, seg_k, q_offset, k_offset,
                                 causal)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_k)
        ctx.args = (q_offset, k_offset, causal)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, seg_q, seg_k = ctx.saved_tensors
        dout, delta, dlse = _bwd_rows(dout, out, dlse)
        dq = flash_bwd_dq_seg(q, k, v, dout, lse, delta, dlse, seg_q, seg_k,
                              *ctx.args)
        dk, dv = flash_bwd_dkv_seg(q, k, v, dout, lse, delta, dlse, seg_q,
                                   seg_k, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def attention_plain(q, k, v, q_offset=0, k_offset=0, causal=True,
                    kv_repeat=1, seg_q=None, seg_k=None):
    """Dense PyTorch version of the kernels' function: ``(out, lse)``.

    Scores in fp32 from the input values, scale ``1/sqrt(D)``, the causal
    mask on global positions and (given ``seg_q (B, Tq)`` and ``seg_k
    (B, Tk)``) the packed-segment mask ``seg_q[q] != seg_k[k]``, both with
    the finite ``-1e30``; a fully masked row gives ``out = 0`` and
    ``lse = -1e30`` (and zero gradients).  Differentiable through torch
    autograd, ``lse`` included.
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    kf = k.float().repeat_interleave(kv_repeat, dim=2)
    vf = v.float().repeat_interleave(kv_repeat, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / (D ** 0.5))
    if causal:
        dev = q.device
        mask = (k_offset + torch.arange(Tk, device=dev))[None, :] > (
            q_offset + torch.arange(Tq, device=dev)
        )[:, None]
        s = s.masked_fill(mask, _NEG_INF)
    if seg_q is not None:
        s = s.masked_fill((seg_q[:, None, :, None] != seg_k[:, None, None, :]),
                          _NEG_INF)
    m = s.amax(-1)
    empty = m <= _NEG_INF / 2
    # The shift is a constant for the gradient (logsumexp's identity).
    safe_m = torch.where(empty, torch.zeros_like(m), m).detach()
    e = torch.exp(s - safe_m[..., None])  # masked entries underflow to 0
    l = e.sum(-1)
    live = l > 0
    l_safe = torch.where(live, l, torch.ones_like(l))
    lse = torch.where(live, safe_m + torch.log(l_safe),
                      torch.full_like(l, _NEG_INF))
    out = torch.einsum("bhqk,bkhd->bqhd", e / l_safe[..., None], vf)
    return out.to(q.dtype), lse


def flash_attention_with_lse(q, k, v, q_offset=0, k_offset=0, causal=True,
                             kv_repeat=1, segment_ids=None,
                             kv_segment_ids=None):
    """Flash attention returning ``(out, logsumexp (B, H, T) fp32)``.

    ``q_offset`` / ``k_offset`` are GLOBAL token offsets for the causal
    mask.  Rows with every key masked return ``out == 0`` and
    ``lse == -1e30``.  ``segment_ids`` (B, Tq) / ``kv_segment_ids`` (B, Tk;
    defaults to ``segment_ids``): packed-sequence masking, tokens attend
    only within their own segment (K4-K6 on the card, which take int32
    contiguous ids and raise on others).  CPU tensors take
    :func:`attention_plain`; CUDA tensors the kernels.
    """
    if q.shape[2] != k.shape[2] * kv_repeat:
        raise ValueError(f"{q.shape[2]} heads != {k.shape[2]} x {kv_repeat}")
    if kv_segment_ids is not None and segment_ids is None:
        # Key-only ids have no sound default for the queries.
        raise ValueError(
            "kv_segment_ids requires segment_ids (the query-side ids)"
        )
    seg_k = kv_segment_ids if kv_segment_ids is not None else segment_ids
    if q.device.type == "cpu":
        return attention_plain(q, k, v, q_offset, k_offset, causal, kv_repeat,
                               segment_ids, seg_k)
    if segment_ids is not None:
        return _FlashAttentionSeg.apply(q, k, v, segment_ids, seg_k, q_offset,
                                        k_offset, causal)
    return _FlashAttention.apply(q, k, v, q_offset, k_offset, causal)


def flash_attention(q, k, v, causal=True, kv_repeat=1, segment_ids=None):
    """Flash attention over ``(B, T, H, D)`` queries with compact GQA k/v
    ``(B, T, H / kv_repeat, D)``; differentiable.  ``segment_ids`` (B, T):
    packed-sequence masking (causality still applies on top)."""
    out, _ = flash_attention_with_lse(q, k, v, 0, 0, causal, kv_repeat,
                                      segment_ids=segment_ids)
    return out
