"""Attention dispatch, ring attention and the sharded local attention
(port of ``ddl_tpu/parallel/ring_attention.py``).

- :func:`attention` — the one dispatcher models call: a mesh with an
  ``sp`` axis of size > 1 takes :func:`ring_attention`, any other mesh
  :func:`sharded_local_attention`, no mesh the single-device path.
- :func:`ring_attention` — sequence-parallel attention over global
  tensors: the tokens are cut over the ``sp`` positions (and the batch
  over ``dp``), and :func:`ring_attention_shard` rotates the compact K/V
  blocks (and, packed, their key-side segment ids) around the ring with
  :func:`~ddl_tpu_torch.parallel.collectives.ppermute`, each position
  accumulating its queries' attention over every block.  With the flash
  kernels each step is one ``flash_attention_with_lse`` call at the
  blocks' GLOBAL offsets (K1-K3, or K4-K6 with the rotating key ids) and
  steps merge by the logsumexp identity, so the lse cotangent reaches the
  backward kernels; the dense route keeps a running max and denominator
  (:func:`_block_attend`).
- :func:`sharded_local_attention` — batch over ``dp``, heads over
  ``tp``, one attention call per position; an axis that does not divide
  its dimension stays unsharded (one warning per geometry).

Positions are those of one device (:class:`~ddl_tpu_torch.parallel.mesh.
Mesh`); work that other mesh axes only replicate runs once, on the
positions at coordinate 0 of those axes.  ``"auto"`` takes the kernels
for CUDA tensors and the dense reference on the CPU; on CUDA tensors the
ring reaches K1-K6 or raises.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import torch

from ddl_tpu_torch.parallel.mesh import NamedSharding, P, ShardedArray, shard

_NEG_INF = -1e30
logger = logging.getLogger(__name__)
_warned_replicated: set = set()  # one replicated-fallback warning per geometry


def _block_attend(q, k, v, q_pos, k_pos, causal: bool, scale: float,
                  kv_repeat: int = 1, seg_q=None, seg_k=None):
    """Scores and weighted values of one (Q-block, KV-block) pair.

    Returns (o_partial, row_max, row_sum) for online-softmax accumulation.
    q: (B, Tq, H, D); k/v: (B, Tk, H/kv_repeat, D); positions: (Tq,), (Tk,).
    GQA heads are expanded here, locally: the ring rotates the compact
    K/V.  ``seg_q``/``seg_k`` (B, Tq)/(B, Tk): packed-sequence masking.
    """
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = k_pos[None, None, None, :] > q_pos[None, None, :, None]
        s = s.masked_fill(mask, _NEG_INF)
    if seg_q is not None:
        segmask = seg_q[:, None, :, None] != seg_k[:, None, None, :]
        s = s.masked_fill(segmask, _NEG_INF)
    m = s.amax(-1)  # (B, H, Tq); _NEG_INF for fully masked rows
    # Subtract a zeroed max for fully masked rows so exp() sees finite
    # arguments, and zero their probabilities — but RETURN the true max:
    # clamping the running max to 0 would underflow exp(s) later for rows
    # whose real scores are strongly negative.
    safe_m = torch.where(m <= _NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(s <= _NEG_INF / 2, torch.zeros_like(p), p)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m, p.sum(-1)


def _ring_index(sharded: ShardedArray, axis_name: str):
    """(ring size, each position's index along ``axis_name``)."""
    mesh = sharded.sharding.mesh
    ax = mesh.axis_names.index(axis_name)
    return mesh.shape[axis_name], [c[ax] for c in mesh.coords()]


def _flash_merge(o_acc, lse_acc, o_blk, lse_blk):
    """Merge two normalized partials by the logsumexp identity.  The
    sentinel for empty rows is the finite ``-1e30``, so the weights are
    zeroed there explicitly (exp of sentinel differences is not
    negligible: exp(-1e30 - (-1e30 + log 2)) = 0.5)."""
    lse_new = torch.logaddexp(lse_acc, lse_blk)  # (B, H, T)
    safe = torch.where(lse_new <= _NEG_INF / 2, torch.zeros_like(lse_new),
                       lse_new)
    zero = torch.zeros_like(lse_new)
    w_a = torch.where(lse_acc <= _NEG_INF / 2, zero,
                      torch.exp(lse_acc - safe)).transpose(1, 2)[..., None]
    w_b = torch.where(lse_blk <= _NEG_INF / 2, zero,
                      torch.exp(lse_blk - safe)).transpose(1, 2)[..., None]
    return o_acc * w_a + o_blk.float() * w_b, lse_new


def ring_attention_shard(q: ShardedArray, k: ShardedArray, v: ShardedArray,
                         axis_name: str, causal: bool = True,
                         kv_repeat: int = 1, use_flash: bool = False,
                         segment_ids: Optional[ShardedArray] = None,
                         ) -> ShardedArray:
    """The ring body over every position of the inputs' mesh (the JAX
    package's per-shard body under ``shard_map``, run for all positions).

    Each position holds its sequence block: q (B, T_local, H, D) and
    compact GQA k/v (B, T_local, H/kv_repeat, D).  The compact K/V blocks
    circulate ``sp`` times through :func:`~ddl_tpu_torch.parallel.
    collectives.ppermute`; at step i position ``my`` attends the block
    that started at ``(my - i) mod sp``.

    With ``use_flash`` each step calls ``flash_attention_with_lse`` with
    ``q_offset = my * T`` and ``k_offset = src * T`` (blocks wholly in
    the future skip their tiles inside the kernel) and the rotating key
    ids, and steps merge by the logsumexp identity; otherwise the attend
    is dense (:func:`_block_attend`) with a running max and denominator.
    ``segment_ids`` (B, T_local): packed-sequence masking — the key-side
    ids rotate with their K/V blocks.
    """
    from ddl_tpu_torch.parallel.collectives import ppermute

    sp, my = _ring_index(q, axis_name)
    perm = [(j, (j + 1) % sp) for j in range(sp)]
    n = len(my)
    qs = [s.data.contiguous() for s in q.shards]
    seg_q = (None if segment_ids is None
             else [s.data.contiguous() for s in segment_ids.shards])
    k_cur, v_cur, seg_k = k, v, segment_ids
    B, T, H, D = qs[0].shape
    if use_flash:
        from ddl_tpu_torch.ops import flash_attention as fa

        o = [torch.zeros(qs[0].shape, dtype=torch.float32, device=qs[0].device)
             for _ in range(n)]
        lse = [torch.full((B, H, T), _NEG_INF, dtype=torch.float32,
                          device=qs[0].device) for _ in range(n)]
    else:
        scale = 1.0 / (D ** 0.5)
        ar = torch.arange(T, device=qs[0].device)
        o = [torch.zeros_like(qs[0]) for _ in range(n)]
        m = [torch.full((B, H, T), _NEG_INF, dtype=qs[0].dtype,
                        device=qs[0].device) for _ in range(n)]
        l_ = [torch.zeros((B, H, T), dtype=qs[0].dtype, device=qs[0].device)
              for _ in range(n)]
    for i in range(sp):
        for p in range(n):
            src = (my[p] - i) % sp
            kp = k_cur.shards[p].data.contiguous()
            vp = v_cur.shards[p].data.contiguous()
            sk = None if seg_k is None else seg_k.shards[p].data.contiguous()
            if use_flash:
                o_blk, lse_blk = fa.flash_attention_with_lse(
                    qs[p], kp, vp, q_offset=my[p] * T, k_offset=src * T,
                    causal=causal, kv_repeat=kv_repeat,
                    segment_ids=None if seg_q is None else seg_q[p],
                    kv_segment_ids=sk,
                )
                o[p], lse[p] = _flash_merge(o[p], lse[p], o_blk, lse_blk)
                continue
            o_blk, m_blk, l_blk = _block_attend(
                qs[p], kp, vp, my[p] * T + ar, src * T + ar, causal, scale,
                kv_repeat, seg_q=None if seg_q is None else seg_q[p],
                seg_k=sk,
            )
            m_new = torch.maximum(m[p], m_blk)
            alpha = torch.exp(m[p] - m_new)  # rescale old accumulator
            beta = torch.exp(m_blk - m_new)  # rescale new block
            l_[p] = l_[p] * alpha + l_blk * beta
            o[p] = (o[p] * alpha.transpose(1, 2)[..., None]
                    + o_blk * beta.transpose(1, 2)[..., None])
            m[p] = m_new
        if i + 1 < sp:  # the last rotation's blocks would go unused
            k_cur = ppermute(k_cur, perm, axis_name)
            v_cur = ppermute(v_cur, perm, axis_name)
            if seg_k is not None:
                seg_k = ppermute(seg_k, perm, axis_name)
    if use_flash:
        out = [x.to(qs[0].dtype) for x in o]
    else:
        out = [o[p] / torch.clamp(l_[p], min=1e-30).transpose(1, 2)[..., None]
               for p in range(n)]
    return ShardedArray(q.shape, q.sharding, out)


def ring_attention(q, k, v, mesh: Any, causal: bool = True, axis: str = "sp",
                   dp_axis: Optional[str] = "dp", kv_repeat: int = 1,
                   use_flash: bool = False, segment_ids=None):
    """Sequence-parallel attention over global tensors.

    q: (B, T, H, D), k/v: (B, T, H/kv_repeat, D); B is cut over
    ``dp_axis`` (if the mesh has it), T over ``axis``, each position's
    block a differentiable view, and the result is assembled back into
    one global tensor.  Falls back to the dense reference when the mesh
    has no ``axis`` or it has size 1.  ``segment_ids`` (B, T):
    packed-sequence masking; the key-side ids ride the ring with their
    K/V blocks.
    """
    if axis not in mesh.axis_names or mesh.shape[axis] == 1:
        return attention_reference(q, k, v, causal=causal,
                                   kv_repeat=kv_repeat,
                                   segment_ids=segment_ids)
    batch_axis = dp_axis if (dp_axis and dp_axis in mesh.axis_names) else None
    ring = mesh.sub_mesh((batch_axis, axis))
    spec = NamedSharding(ring, P(batch_axis, axis, None, None))
    seg = (None if segment_ids is None
           else shard(segment_ids, NamedSharding(ring, P(batch_axis, axis))))
    return ring_attention_shard(
        shard(q, spec), shard(k, spec), shard(v, spec), axis, causal=causal,
        kv_repeat=kv_repeat, use_flash=use_flash, segment_ids=seg,
    ).assemble()


def sharded_local_attention(q, k, v, mesh: Any, causal: bool = True,
                            kv_repeat: int = 1, use_flash: bool = False,
                            dp_axis: str = "dp", tp_axis: str = "tp",
                            segment_ids=None):
    """Batch/head-sharded attention for meshes WITHOUT a sequence axis.

    Attention is independent across batch and heads, so each position
    runs the whole attention of its batch block (``dp_axis``) and head
    block (``tp_axis``) with no communication.  Axes that don't divide
    the corresponding dimension stay unsharded; with neither sharding
    anything on a mesh of several positions, attention runs once,
    replicated (one warning per geometry).  ``segment_ids`` (B, T):
    packed-sequence masking, batch-sharded like q.
    """
    from ddl_tpu_torch.ops.flash_attention import flash_attention

    def impl(q, k, v, seg):
        if use_flash:
            return flash_attention(q, k, v, causal=causal,
                                   kv_repeat=kv_repeat, segment_ids=seg)
        return attention_reference(q, k, v, causal=causal,
                                   kv_repeat=kv_repeat, segment_ids=seg)

    B, _, H, _ = q.shape
    Hkv = k.shape[2]
    bax = dp_axis if (
        dp_axis in mesh.axis_names
        and mesh.shape[dp_axis] > 1
        and B % mesh.shape[dp_axis] == 0
    ) else None
    hax = tp_axis if (
        tp_axis in mesh.axis_names
        and mesh.shape[tp_axis] > 1
        and H % mesh.shape[tp_axis] == 0
        and Hkv % mesh.shape[tp_axis] == 0
    ) else None
    if bax is None and hax is None:
        if mesh.size > 1:
            key = (tuple(mesh.axis_names), tuple(mesh.devices.shape), B, H)
            if key not in _warned_replicated:
                _warned_replicated.add(key)
                logger.warning(
                    "sharded_local_attention: neither %r (batch %d) nor %r "
                    "(heads %d/%d) is a shardable mesh axis — attention "
                    "runs fully replicated on every device",
                    dp_axis, B, tp_axis, H, Hkv,
                )
        else:
            logger.debug(
                "sharded_local_attention: single-device mesh, local attention"
            )
        return impl(q, k, v, segment_ids)
    sub = mesh.sub_mesh((bax, hax))
    spec = NamedSharding(sub, P(bax, None, hax, None))
    qs, ks, vs = shard(q, spec), shard(k, spec), shard(v, spec)
    segs = (None if segment_ids is None
            else shard(segment_ids, NamedSharding(sub, P(bax, None))))
    outs = [
        impl(qs.shards[p].data.contiguous(), ks.shards[p].data.contiguous(),
             vs.shards[p].data.contiguous(),
             None if segs is None else segs.shards[p].data.contiguous())
        for p in range(sub.size)
    ]
    return ShardedArray(q.shape, spec, outs).assemble()


def attention(q, k, v, impl: str = "auto", causal: bool = True,
              kv_repeat: int = 1, segment_ids=None, mesh: Any = None,
              axis: str = "sp", dp_axis: str = "dp", tp_axis: str = "tp"):
    """The single attention dispatcher models call:

    - a mesh with a >1-sized ``axis`` (sp) → :func:`ring_attention`,
    - any other mesh → :func:`sharded_local_attention`,
    - no mesh → single-device attention.

    ``impl``: "flash" forces the flash kernels (their plain version for
    CPU tensors), "dense" the dense reference, "auto" the kernels for
    CUDA tensors and the dense reference on the CPU — as the JAX
    package's "auto" takes the Pallas kernel on the TPU and dense XLA
    elsewhere.  ``segment_ids`` (B, T): packed-sequence masking on every
    route (the kernels take them int32 and contiguous; on the ring the
    key-side ids rotate with their K/V blocks).
    """
    if impl not in ("auto", "flash", "dense"):
        raise ValueError(
            f"impl must be 'auto', 'flash', or 'dense', got {impl!r}"
        )
    use_flash = impl == "flash" or (impl == "auto" and q.device.type == "cuda")
    if mesh is not None:
        # Over a process-spanning mesh the model holds this process's
        # rows: its attention runs on this process's positions.
        mesh = mesh.local()
    if mesh is not None and axis in mesh.axis_names and mesh.shape[axis] > 1:
        return ring_attention(
            q, k, v, mesh, causal=causal, axis=axis, dp_axis=dp_axis,
            kv_repeat=kv_repeat, use_flash=use_flash,
            segment_ids=segment_ids,
        )
    if mesh is not None:
        return sharded_local_attention(
            q, k, v, mesh, causal=causal, kv_repeat=kv_repeat,
            use_flash=use_flash, dp_axis=dp_axis, tp_axis=tp_axis,
            segment_ids=segment_ids,
        )
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
