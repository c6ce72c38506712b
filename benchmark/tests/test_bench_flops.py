"""The operation and byte counts against cases worked by hand."""

import math

import pytest

from benchmark import flops


def test_decoder_flops_hand_worked():
    # d 8, 2 heads of 4, 1 kv head, d_ff 16, 1 layer, vocab 10, T 4:
    # q/k/v 2*8*(2+2)*4 = 256, out 2*2*4*8 = 128, causal half of scores and
    # attn@v 2*2*4*2*4/2 = 64, SwiGLU 3*2*8*16 = 768, head 2*8*10 = 160.
    assert flops.decoder_flops_per_token(8, 2, 1, 16, 1, 10, 4) == 3 * (
        256 + 128 + 64 + 768 + 160)


def test_encoder_flops_hand_worked():
    # d 4, 2 heads, d_ff 8, 1 layer, 2 patches of 6 values, 3 classes:
    # per patch q/k/v 2*4*12 = 96, out 32, scores and attn@v 2*2*2*4 = 32,
    # MLP 2*2*4*8 = 128, patch projection 2*6*4 = 48; head 2*4*3 = 24.
    per_patch = 96 + 32 + 32 + 128 + 48
    assert flops.encoder_flops_per_image(4, 2, 8, 1, 2, 6, 3) == 3 * (
        2 * per_patch + 24)


def test_published_sizes():
    # Mistral-7B widths at 4 layers, T 4096: 6.42 GFLOP a token; ViT-B/16:
    # 105 GFLOP an image (fwd + bwd).
    assert flops.decoder_flops_per_token(
        4096, 32, 8, 14336, 4, 32000, 4096) == pytest.approx(6.42e9, rel=1e-3)
    assert flops.encoder_flops_per_image(
        768, 12, 3072, 12, 196, 768, 1000) == pytest.approx(1.048e11, rel=1e-3)


def test_attention_work_hand_worked():
    # B 1, T 2, one head of dim 1, causal: 3 attended pairs.  Forward 2
    # products = 12 FLOPs, backward 5 = 30.  Bytes (bf16, fp32 lse): q 4,
    # k 4, v 4, o 4, lse 8 -> forward reads q k v, writes o lse = 24;
    # backward reads q k v o dO lse = 28, writes dq dk dv = 12.
    w = flops.attention_work(1, 2, 1, 1, 1, causal=True)
    assert w["fwd"] == (12.0, 24.0)
    assert w["bwd"] == (30.0, 40.0)
    nc = flops.attention_work(1, 2, 1, 1, 1, causal=False)
    assert nc["fwd"][0] == 16.0 and nc["bwd"][0] == 40.0


def test_bound_takes_the_larger_side():
    assert flops.bound_s(989e12, 0.0, 989e12, 3.35e12) == 1.0
    assert flops.bound_s(0.0, 6.7e12, 989e12, 3.35e12) == 2.0
    assert math.isclose(flops.bound_s(1.0, 1.0, 2.0, 4.0), 0.5)
