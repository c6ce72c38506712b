"""The plain references against the port at tiny widths on the CPU: in
float32 both compute the same loss and gradients; the float8 control
does not."""

import numpy as np
import pytest
import torch

from benchmark import families, weights
from benchmark.reference import common
from benchmark.reference import family as reference_family
from benchmark.tests import tiny


def _batch(kind, traffic, config, seed=3):
    rng = np.random.default_rng(seed)
    B = traffic["batch_size"]
    if kind == "tokens":
        return rng.integers(0, config["vocab_size"], (B, traffic["seq_len"]),
                            dtype=np.int32)
    px = config["image_size"] ** 2 * config["num_channels"]
    rows = rng.standard_normal((B, px + 1)).astype(np.float32)
    rows[:, -1] = rng.integers(0, config["num_labels"], B)
    return rows


def _port_batch(kind, rows):
    t = torch.from_numpy(rows)
    if kind == "tokens":
        return (t,)
    return (t[:, :-1], t[:, -1:])


def _loss_and_grads(kind, precision):
    spec = tiny.spec(kind)
    config, traffic = spec["config"], spec["traffic"]
    specs = reference_family(config["family"]).leaf_specs(config)
    rows = _batch(kind, traffic, config)
    out = {}
    for side in ("port", "reference"):
        tree, leaves = weights.make(specs, 5, "cpu")
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        tree = weights.tree(specs, leaves)
        if side == "port":
            fam = families.load(config["family"])
            pcfg = fam.program_config(dict(config, compute_dtype="float32"),
                                      traffic)
            loss = fam.loss_fn(pcfg, traffic)(tree,
                                              _port_batch(kind, rows))
        else:
            ref = reference_family(config["family"])
            t = torch.from_numpy(rows)
            loss = (ref.block_loss(tree, t, config, traffic, precision)
                    / ref.batch_count(t, config, traffic))
        loss.backward()
        out[side] = (float(loss.detach()), [p.grad.clone() for p in leaves])
    return out


@pytest.mark.parametrize("kind", ["tokens", "images"])
def test_reference_equals_port_in_float32(kind):
    common.exact_float32()
    out = _loss_and_grads(kind, "float32")
    (lp, gp), (lr, gr) = out["port"], out["reference"]
    assert lp == pytest.approx(lr, rel=1e-5)
    for a, b in zip(gp, gr):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["tokens", "images"])
def test_float8_control_departs(kind):
    out = _loss_and_grads(kind, "float8")
    (lp, gp), (lc, gc) = out["port"], out["reference"]
    rel = max(float((a - b).norm() / b.norm()) for a, b in zip(gc, gp))
    assert rel > 1e-2


def test_adamw_matches_torch():
    torch.manual_seed(0)
    p = [torch.randn(5, 3), torch.randn(7)]
    q = [t.clone().requires_grad_(True) for t in p]
    hp = {"lr": 1e-2, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
          "weight_decay": 1e-4}
    opt = torch.optim.AdamW(q, lr=hp["lr"], betas=(hp["b1"], hp["b2"]),
                            eps=hp["eps"], weight_decay=hp["weight_decay"])
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    for step in range(1, 4):
        g = [torch.randn_like(t) for t in p]
        for t, gi in zip(q, g):
            t.grad = gi.clone()
        opt.step()
        common.adamw_step(p, g, m, v, step, hp)
    for a, b in zip(p, q):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)
