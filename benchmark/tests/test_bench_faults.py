"""A run with the timed path broken underneath comes out not correct: the
whole run (inputs, the port's fit, the reference, the comparison) at
tiny widths on the CPU, the look for a card skipped.  One cell has one
card, so the exchange between cards has no fault to plant."""

import time

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny


def _run(kind, seed, loss_wrapper=None):
    return run.execute(tiny.spec(kind), seed, 0.5, False, device="cpu",
                       t0=time.perf_counter(), loss_wrapper=loss_wrapper)


@pytest.mark.parametrize("kind", ["tokens", "images"])
def test_sound_run_is_correct(kind):
    out = _run(kind, 2 ** 31 + 21)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


@pytest.mark.parametrize("kind", ["tokens", "images"])
def test_step_that_leaves_the_state_unchanged(kind, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    out = _run(kind, 2 ** 31 + 22)
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("kind", ["tokens", "images"])
def test_half_the_batch_left_out(kind):
    def halve(loss):
        return lambda p, b: loss(p, tuple(c[: c.shape[0] // 2] for c in b))

    out = _run(kind, 2 ** 31 + 23, loss_wrapper=halve)
    assert not out["correct"]


@pytest.mark.parametrize("kind", ["tokens", "images"])
def test_value_altered_where_produced(kind, monkeypatch):
    from ddl_tpu_torch import readers

    cls, name = ((readers.TokenStreamProducer, "_fill") if kind == "tokens"
                 else (readers.FileShardProducer, "_load_next"))
    original = getattr(cls, name)
    fills = []

    def altered(self, my_ary):
        original(self, my_ary)
        fills.append(1)
        if len(fills) == 5:  # one window, after the start-up fills
            flat = my_ary.reshape(-1)
            flat[0] = flat[0] + 1
    monkeypatch.setattr(cls, name, altered)
    out = _run(kind, 2 ** 31 + 24)
    assert not out["correct"]
    assert out["checks"]["stream_mismatch"]["value"] >= 1


@pytest.mark.parametrize("kind", ["tokens", "images"])
def test_step_size_five_percent_too_large(kind, monkeypatch):
    from ddl_tpu_torch.parallel import train

    original = train.adamw
    monkeypatch.setattr(train, "adamw",
                        lambda lr, **kw: original(lr * 1.05, **kw))
    out = _run(kind, 2 ** 31 + 25)
    assert not out["correct"]
    assert out["checks"]["update_gap_median"]["value"] > 0.02
