"""Single-device attention dispatch (port of the single-device part of
``ddl_tpu/parallel/ring_attention.py``: :func:`attention` with no mesh,
and :func:`attention_reference`).  Ring attention over several cards
and the sharded local attention are later slices.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def attention(q, k, v, impl: str = "auto", causal: bool = True,
              kv_repeat: int = 1, segment_ids=None):
    """The single attention dispatcher models call.

    ``impl``: "flash" forces the flash kernels (their plain version for
    CPU tensors), "dense" the dense reference, "auto" the kernels for
    CUDA tensors and the dense reference on the CPU — as the JAX
    package's "auto" takes the Pallas kernel on the TPU and dense XLA
    elsewhere.  ``segment_ids`` (B, T): packed-sequence masking on either
    path (the kernels take them int32 and contiguous).
    """
    if impl not in ("auto", "flash", "dense"):
        raise ValueError(
            f"impl must be 'auto', 'flash', or 'dense', got {impl!r}"
        )
    use_flash = impl == "flash" or (impl == "auto" and q.device.type == "cuda")
    if use_flash:
        from ddl_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, kv_repeat=kv_repeat,
                               segment_ids=segment_ids)
    return attention_reference(q, k, v, causal=causal, kv_repeat=kv_repeat,
                               segment_ids=segment_ids)


def attention_reference(q, k, v, causal: bool = True, kv_repeat: int = 1,
                        segment_ids=None):
    """Single-device full attention — the dense oracle, in the input
    dtype like the JAX package's (scores ``(B, H, T, T)``).
    ``segment_ids`` (B, T): tokens attend only within their own segment."""
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    B, T, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (D ** 0.5)
    if causal:
        mask = torch.arange(T, device=q.device)[None, :] > torch.arange(
            T, device=q.device
        )[:, None]
        s = s.masked_fill(mask[None, None], _NEG_INF)
    if segment_ids is not None:
        segmask = segment_ids[:, :, None] != segment_ids[:, None, :]  # (B, T, T)
        s = s.masked_fill(segmask[:, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
