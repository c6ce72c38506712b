"""Causal flash attention (port of ``ddl_tpu/ops/flash_attention.py``).

Hand-written CUDA kernels (``csrc/flash_attention.cu``) replace the
Pallas TPU kernels: K1 the online-softmax forward (``_fwd_kernel``), K2
the dQ backward (``_dq_kernel``) and K3 the dK/dV backward
(``_dkv_kernel``); K4-K6 are the same kernels with the packed-segment
mask (``_fwd_kernel_seg``, ``_dq_kernel_seg``, ``_dkv_kernel_seg``),
behind their own wrappers as the JAX package keeps separate ``_seg``
entry points.  ``torch.autograd.Function`` carries the gradient, as
``jax.custom_vjp`` did; ``delta = rowsum(dO * O)`` stays plain torch
outside the kernels, as in the JAX package.

Beside the kernels, :func:`attention_plain` is the same function written
densely in PyTorch — masked with the same finite ``-1e30``, the same
empty-row rule, returning ``(out, lse)``, differentiated by autograd.
The public wrappers take it only for tensors on the CPU; a CUDA tensor
reaches the kernels or raises.  Each kernel wrapper counts its launches
(``.launches``), so a run can show that it went through the kernel.

Layouts follow the JAX package: q ``(B, T, H, D)``, k/v compact GQA
``(B, T, H / kv_repeat, D)``, lse ``(B, H, T)`` fp32, segment ids
``(B, Tq)`` / ``(B, Tk)`` (int32, contiguous, for the kernels).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_NEG_INF = -1e30
#: Head dims the kernels are instantiated for.
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    from ddl_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_ddl_bound", False):
        geom = [_I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
        fwd, dq, dkv = [_I] + [_P] * 5, [_I] + [_P] * 8, [_I] + [_P] * 9
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


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            + ("unsupported arguments" if rc < 0 else f"CUDA error {rc}")
        )


def _validate(q, k, v) -> Tuple[int, int, int, int, int, int]:
    """Shapes, device, dtype and layout the kernels take; raises on the
    rest.  Returns (B, Tq, Tk, H, Hkv, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPE_CODES:
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


def _fwd(q, k, v, q_offset, k_offset, causal, seg):
    """Launch K1 (``seg is None``) or K4 (``seg = (seg_q, seg_k)``)."""
    B, Tq, Tk, H, Hkv, D = _validate(q, k, v)
    ids = () if seg is None else _validate_ids(q, k, *seg)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = (lib.ddl_flash_fwd if seg is None else lib.ddl_flash_fwd_seg)(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *ids, B, Tq, Tk, H, Hkv, D,
        int(q_offset), int(k_offset), int(bool(causal)), 1.0 / (D ** 0.5),
        _stream(q),
    )
    _check(rc, "flash forward")
    return out, lse


def _bwd_dq(q, k, v, dout, lse, delta, dlse, q_offset, k_offset, causal, seg):
    """Launch K2 or K5."""
    B, Tq, Tk, H, Hkv, D = _validate(q, k, v)
    _validate_rows(dout, q, lse, delta, dlse)
    ids = () if seg is None else _validate_ids(q, k, *seg)
    dq = torch.empty_like(q)
    lib = _lib()
    rc = (lib.ddl_flash_bwd_dq if seg is None else lib.ddl_flash_bwd_dq_seg)(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(),
        dq.data_ptr(), *ids, B, Tq, Tk, H, Hkv, D, int(q_offset),
        int(k_offset), int(bool(causal)), 1.0 / (D ** 0.5), _stream(q),
    )
    _check(rc, "flash dq")
    return dq


def _bwd_dkv(q, k, v, dout, lse, delta, dlse, q_offset, k_offset, causal,
             seg):
    """Launch K3 or K6."""
    B, Tq, Tk, H, Hkv, D = _validate(q, k, v)
    _validate_rows(dout, q, lse, delta, dlse)
    ids = () if seg is None else _validate_ids(q, k, *seg)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib()
    rc = (lib.ddl_flash_bwd_dkv if seg is None else lib.ddl_flash_bwd_dkv_seg)(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *ids, B, Tq, Tk, H, Hkv, D,
        int(q_offset), int(k_offset), int(bool(causal)), 1.0 / (D ** 0.5),
        _stream(q),
    )
    _check(rc, "flash dkv")
    return dk, dv


def flash_fwd(q, k, v, q_offset=0, k_offset=0, causal=True):
    """K1: ``(out, lse)`` of causal GQA attention, on the current stream."""
    out = _fwd(q, k, v, q_offset, k_offset, causal, None)
    flash_fwd.launches += 1
    return out


def flash_bwd_dq(q, k, v, dout, lse, delta, dlse, q_offset=0, k_offset=0,
                 causal=True):
    """K2: dQ from the saved lse, ``delta = rowsum(dO * O)`` and the lse
    cotangent ``dlse`` (all ``(B, H, Tq)`` fp32)."""
    dq = _bwd_dq(q, k, v, dout, lse, delta, dlse, q_offset, k_offset, causal,
                 None)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, dlse, q_offset=0, k_offset=0,
                  causal=True):
    """K3: ``(dk, dv)`` in the compact GQA layout, summed over each KV
    head's query-head group inside the kernel."""
    dkv = _bwd_dkv(q, k, v, dout, lse, delta, dlse, q_offset, k_offset,
                   causal, None)
    flash_bwd_dkv.launches += 1
    return dkv


def flash_fwd_seg(q, k, v, seg_q, seg_k, q_offset=0, k_offset=0, causal=True):
    """K4: K1 that also masks ``seg_q[q] != seg_k[k]`` (packed documents)."""
    out = _fwd(q, k, v, q_offset, k_offset, causal, (seg_q, seg_k))
    flash_fwd_seg.launches += 1
    return out


def flash_bwd_dq_seg(q, k, v, dout, lse, delta, dlse, seg_q, seg_k,
                     q_offset=0, k_offset=0, causal=True):
    """K5: K2 under the packed-segment mask."""
    dq = _bwd_dq(q, k, v, dout, lse, delta, dlse, q_offset, k_offset, causal,
                 (seg_q, seg_k))
    flash_bwd_dq_seg.launches += 1
    return dq


def flash_bwd_dkv_seg(q, k, v, dout, lse, delta, dlse, seg_q, seg_k,
                      q_offset=0, k_offset=0, causal=True):
    """K6: K3 under the packed-segment mask."""
    dkv = _bwd_dkv(q, k, v, dout, lse, delta, dlse, q_offset, k_offset,
                   causal, (seg_q, seg_k))
    flash_bwd_dkv_seg.launches += 1
    return dkv


#: The kernel wrappers, in K1..K6 order.
KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv,
           flash_fwd_seg, flash_bwd_dq_seg, flash_bwd_dkv_seg)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def _validate_rows(dout, q, lse, delta, dlse) -> None:
    if dout.shape != q.shape or dout.dtype != q.dtype or not dout.is_contiguous():
        raise ValueError("dout must match q in shape, dtype and layout")
    rows = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta), ("dlse", dlse)):
        if (tuple(t.shape) != rows or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 {rows} on {q.device}")


def _bwd_rows(dout, out, dlse):
    """The backward's row terms: contiguous ``dout``, ``delta_i =
    rowsum(dO_i * O_i)`` (the softmax-jacobian diagonal term) and the lse
    cotangent, both ``(B, H, T)`` fp32."""
    dout = dout.contiguous()
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
