"""The bf16 kernels' tile skips: :func:`live_tiles`, the plain statement of
which (query tile, key tile) pairs the packed forward visits, and
:func:`live_tiles_dkv`, which (key tile, query tile) pairs the packed
dK/dV backward visits.

The kernel skips a key tile whose document-id range ``[min, max]`` is
disjoint from the query tile's; the rule must never skip a pair that the
masks allow (``seg_q[q] == seg_k[k]`` and, causal, ``k_off + k <= q_off +
q``), whatever the ids — sorted or not, ragged lengths, offsets — in the
kernel's own tile geometry (``SM90_BLOCK_Q`` x ``SM90_BLOCK_K`` for the
forward, ``SM90_DKV_BLOCK_K`` x ``SM90_DKV_BLOCK_Q`` for the backward).
The kernels themselves run only on a card (``tests/test_torch_cuda.py``
holds their output against the plain version there, and their counts of
loaded tiles against these rules); these tests hold the rules they state.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from ddl_tpu_torch.ops import flash_attention as tfa


def _allowed_pairs(sq, sk, q_off, k_off, causal):
    """(b, q, k) of every pair the masks allow."""
    same = sq[:, :, None] == sk[:, None, :]
    if causal:
        q = q_off + np.arange(sq.shape[1])
        k = k_off + np.arange(sk.shape[1])
        same &= (k[None, :] <= q[:, None])[None]
    return np.nonzero(same)


@st.composite
def _packed_case(draw):
    B = draw(st.integers(1, 2))
    Tq = draw(st.integers(1, 400))
    Tk = draw(st.integers(1, 400))
    n_docs = draw(st.integers(1, 12))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    if draw(st.booleans()):  # packed documents: sorted, contiguous ids
        sq = np.sort(rng.integers(0, n_docs, (B, Tq)), axis=1)
        sk = np.sort(rng.integers(0, n_docs, (B, Tk)), axis=1)
    else:  # any ids, in any order, negative ones included
        sq = rng.integers(-3, n_docs, (B, Tq))
        sk = rng.integers(-3, n_docs, (B, Tk))
    causal = draw(st.booleans())
    q_off = draw(st.integers(0, 200))
    k_off = draw(st.integers(0, 200))
    return sq.astype(np.int32), sk.astype(np.int32), q_off, k_off, causal


@given(case=_packed_case())
@settings(max_examples=200, deadline=None)
def test_every_allowed_pair_lies_in_a_live_tile(case):
    sq, sk, q_off, k_off, causal = case
    block_q, block_k = tfa.SM90_BLOCK_Q, tfa.SM90_BLOCK_K
    live = tfa.live_tiles(torch.tensor(sq), torch.tensor(sk), q_off, k_off,
                          causal).numpy()
    nq, nk = -(-sq.shape[1] // block_q), -(-sk.shape[1] // block_k)
    assert live.shape == (sq.shape[0], nq, nk) and live.dtype == np.bool_
    b, q, k = _allowed_pairs(sq, sk, q_off, k_off, causal)
    assert live[b, q // block_q, k // block_k].all()


@pytest.mark.parametrize("causal,n_live", [(True, 8), (False, 12)])
def test_live_tile_count_on_three_documents(causal, n_live):
    """Documents of 100, 200 and 212 tokens in 128-token tiles: query tiles
    hold ids [0, 1], [1, 1], [1, 2], [2, 2]; causal, tile 3 skips key tiles
    0 and 1 (10 causal pairs, 8 live); without the causal loop, 12 of 16."""
    ids = torch.tensor([[0] * 100 + [1] * 200 + [2] * 212], dtype=torch.int32)
    live = tfa.live_tiles(ids, ids, causal=causal)
    assert live.shape == (1, 4, 4)
    assert int(live.sum()) == n_live
    assert not live[0, 3, 0] and not live[0, 3, 1]
    if causal:
        assert not live[0].triu(1).any()  # the causal loop stops at the diagonal


def test_live_tiles_follow_the_offsets():
    """The causal loop on global positions: a query tile at q_off sees
    key tiles up to its last row's position."""
    ids = torch.zeros(1, 384, dtype=torch.int32)
    live = tfa.live_tiles(ids, ids, q_offset=0, k_offset=200)
    # q tile 0 ends at position 127, before the first key (200): none.
    # q tile 1 ends at 255 -> keys (local) up to 55: key tile 0.
    # q tile 2 ends at 383 -> keys up to 183: key tiles 0 and 1.
    assert live[0].int().tolist() == [[0, 0, 0], [1, 0, 0], [1, 1, 0]]


@given(case=_packed_case())
@settings(max_examples=200, deadline=None)
def test_every_allowed_pair_lies_in_a_live_dkv_tile(case):
    sq, sk, q_off, k_off, causal = case
    block_q, block_k = tfa.SM90_DKV_BLOCK_Q, tfa.SM90_DKV_BLOCK_K
    live = tfa.live_tiles_dkv(torch.tensor(sq), torch.tensor(sk), q_off,
                              k_off, causal).numpy()
    nq, nk = -(-sq.shape[1] // block_q), -(-sk.shape[1] // block_k)
    assert live.shape == (sq.shape[0], nk, nq) and live.dtype == np.bool_
    b, q, k = _allowed_pairs(sq, sk, q_off, k_off, causal)
    assert live[b, k // block_k, q // block_q].all()


@pytest.mark.parametrize("causal,n_live", [(True, 14), (False, 20)])
def test_live_dkv_tile_count_on_three_documents(causal, n_live):
    """Documents of 100, 200 and 212 tokens: 128-row key tiles hold ids
    [0, 1], [1, 1], [1, 2], [2, 2]; 64-row query tiles [0, 0], [0, 1],
    [1, 1], [1, 1], [1, 2], [2, 2], [2, 2], [2, 2].  Causal, key tile j
    loads query tiles 2j on (20 pairs), 14 of them live; without the causal
    loop, 20 of 32."""
    ids = torch.tensor([[0] * 100 + [1] * 200 + [2] * 212], dtype=torch.int32)
    live = tfa.live_tiles_dkv(ids, ids, causal=causal)
    assert live.shape == (1, 4, 8)
    assert int(live.sum()) == n_live
    # Key tile 0 (ids 0-1) never meets query tiles 5-7 (id 2).
    assert not live[0, 0, 5:].any()
    if causal:
        assert live[0].int().tolist() == [
            [1, 1, 1, 1, 1, 0, 0, 0],
            [0, 0, 1, 1, 1, 0, 0, 0],
            [0, 0, 0, 0, 1, 1, 1, 1],
            [0, 0, 0, 0, 0, 0, 1, 1],
        ]


def test_live_dkv_tiles_follow_the_offsets():
    """The backward's causal loop starts at the diagonal in global
    positions: key tile j (first key at k_offset + 128 j) loads query tile
    i once its last row (q_offset + 64 i + 63) reaches that key."""
    live = tfa.live_tiles_dkv(torch.zeros(1, 384, dtype=torch.int32),
                              torch.zeros(1, 256, dtype=torch.int32),
                              q_offset=0, k_offset=200)
    # Key tile 0 starts at 200: query tiles ending at 255, 319, 383.
    # Key tile 1 starts at 328: the query tile ending at 383.
    assert live[0].int().tolist() == [[0, 0, 0, 1, 1, 1],
                                      [0, 0, 0, 0, 0, 1]]
