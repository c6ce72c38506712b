"""The MULTIHOST step's rule for losses across processes, on the CPU.

A MULTIHOST step (``ddl_tpu_torch/parallel/train.py``) computes loss and
grads over each process's rows, then sums them over the group in one
bucket (``collectives.process_mean``).  The JAX package's step is jitted
over the global batch, where a ``cross_entropy`` loss is
``sum(nll * mask) / sum(mask)`` over every process's rows
(``ddl_tpu/models/losses.py``).  When the processes keep different token
counts, the mean of their means is not that value.

These tests simulate two processes in one: each shard's loss and grads
go through the same staging code the step runs (``losses.loss_weight``,
``collectives.stage_bucket`` / ``unstage_bucket``), the two buckets are
summed as gloo's ``all_reduce`` would, and the result is held to a
one-process step over the joined batch.  The count-weighted rule passes
at rtol 1e-5; the world-size mean (no weight) fails the same check.
"""

import numpy as np
import pytest
import torch

from ddl_tpu_torch.models import losses
from ddl_tpu_torch.parallel.collectives import stage_bucket, unstage_bucket

RTOL = 1e-5
T, D, V, ROWS = 12, 6, 11, 4


def _data(seed: int):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(D, V)).astype(np.float32)
    x = rng.normal(size=(2 * ROWS, T, D)).astype(np.float32)
    tokens = rng.integers(0, V, size=(2 * ROWS, T)).astype(np.int64)
    # Shard 0 keeps few positions, shard 1 most of them.
    drop = np.zeros((2 * ROWS, T), bool)
    drop[:ROWS, 2:] = True
    drop[ROWS:, ::5] = True
    # Packed documents: shard 0 in many short documents, shard 1 in one.
    seg = np.zeros((2 * ROWS, T), np.int32)
    seg[:ROWS] = np.arange(T) // 3
    return w, x, tokens, drop, seg


def _loss(kind: str, w, x, tokens, drop, seg):
    logits = x @ w
    if kind == "masked":
        return losses.cross_entropy(logits, tokens, mask=~drop)
    if kind == "extra_mask":
        return losses.next_token_cross_entropy(logits, tokens,
                                               extra_mask=drop)
    return losses.next_token_cross_entropy(logits, tokens, segment_ids=seg)


def _global_step(kind: str, seed: int):
    w, *batch = _data(seed)
    wt = torch.tensor(w, requires_grad=True)
    loss = _loss(kind, wt, *(torch.from_numpy(b) for b in batch))
    loss.backward()
    return float(loss.detach()), wt.grad.numpy()


def _two_process_step(kind: str, seed: int, weighted: bool):
    """Each simulated process: its rows, its loss and grads, staged into
    its own bucket; the buckets summed; each process unstages."""
    w, *batch = _data(seed)
    staged = []
    for rank in range(2):
        rows = slice(rank * ROWS, (rank + 1) * ROWS)
        wt = torch.tensor(w, requires_grad=True)
        with losses.loss_weight() as scope:
            loss = _loss(kind, wt, *(torch.from_numpy(b[rows]) for b in batch))
        loss.backward()
        loss = loss.detach()
        weight = scope.weight(None) if weighted else None
        tensors, like = [wt.grad, loss], [wt, loss]
        host = torch.empty(sum(t.numel() for t in like) + (weight is not None))
        staged.append((tensors, stage_bucket(tensors, like, host, weight),
                       host, scope.counts))
    total = staged[0][2] + staged[1][2]
    out = []
    for tensors, slices, host, counts in staged:
        host.copy_(total)
        unstage_bucket(tensors, slices, host, 2, weighted)
        out.append((float(tensors[1]), tensors[0].numpy(), counts))
    return out


@pytest.mark.parametrize("kind", ["masked", "extra_mask", "segment_ids"])
def test_count_weighted_step_equals_the_global_batch(kind):
    want_loss, want_grad = _global_step(kind, seed=3)
    got = _two_process_step(kind, seed=3, weighted=True)
    # The shards keep different token counts: the case the rule is for.
    assert float(got[0][2][0]) != float(got[1][2][0])
    for loss, grad, _counts in got:
        np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
        np.testing.assert_allclose(grad, want_grad, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("kind", ["masked", "extra_mask", "segment_ids"])
def test_world_size_mean_misses_the_global_batch(kind):
    """The old rule (divide the sum by the world size) on the same shards
    fails the check the count-weighted rule passes."""
    want_loss, want_grad = _global_step(kind, seed=3)
    for loss, grad, _counts in _two_process_step(kind, seed=3, weighted=False):
        assert not np.allclose(loss, want_loss, rtol=RTOL)
        assert not np.allclose(grad, want_grad, rtol=RTOL, atol=1e-7)


def test_equal_counts_give_the_same_step_either_way():
    """Where both shards keep every position (a token stream), the
    count-weighted step and the world-size mean agree."""
    w, x, tokens, _drop, _seg = _data(5)
    none = np.zeros_like(_drop)
    steps = []
    for weighted in (True, False):
        staged = []
        for rank in range(2):
            rows = slice(rank * ROWS, (rank + 1) * ROWS)
            wt = torch.tensor(w, requires_grad=True)
            with losses.loss_weight() as scope:
                loss = losses.next_token_cross_entropy(
                    torch.from_numpy(x[rows]) @ wt,
                    torch.from_numpy(tokens[rows]),
                    extra_mask=torch.from_numpy(none[rows]))
            loss.backward()
            loss = loss.detach()
            weight = scope.weight(None) if weighted else None
            host = torch.empty(wt.numel() + 1 + (weight is not None))
            staged.append(([wt.grad, loss], stage_bucket(
                [wt.grad, loss], [wt, loss], host, weight), host))
        total = staged[0][2] + staged[1][2]
        tensors, slices, host = staged[0]
        host.copy_(total)
        unstage_bucket(tensors, slices, host, 2, weighted)
        steps.append((float(tensors[1]), tensors[0].numpy().copy()))
    np.testing.assert_allclose(steps[0][0], steps[1][0], rtol=RTOL)
    np.testing.assert_allclose(steps[0][1], steps[1][1], rtol=RTOL, atol=1e-7)


def test_loss_weight_scope_counts_one_call():
    logits = torch.zeros(3, 5)
    targets = torch.zeros(3, dtype=torch.long)
    with losses.loss_weight() as scope:
        pass
    assert scope.weight("default") == "default"
    with losses.loss_weight() as scope:
        losses.cross_entropy(logits, targets, mask=torch.tensor([1, 0, 1]))
    assert float(scope.weight(None)) == 2.0
    with losses.loss_weight() as scope:
        losses.cross_entropy(logits, targets)
    assert float(scope.weight(None)) == 3.0
    with losses.loss_weight() as scope:
        losses.cross_entropy(logits, targets)
        losses.cross_entropy(logits, targets)
    assert scope.weight("several") == "several"
    # Outside a scope nothing is noted, and the value is unchanged.
    a = losses.cross_entropy(logits, targets, mask=torch.tensor([1, 0, 1]))
    with losses.loss_weight():
        b = losses.cross_entropy(logits, targets, mask=torch.tensor([1, 0, 1]))
    assert torch.equal(a, b)
