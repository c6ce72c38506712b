"""Serving on the PyTorch port: train briefly, then batched KV-cache
generation.

The twin of ``examples/generate.py`` at the same scale: a tiny Llama is
fitted on a repeating token pattern, then ``llama.generate`` serves
batched completions three ways — greedy, temperature sampling, and
nucleus (top-p) sampling with a top-k cap — through the stacked KV cache
(one cached prefill, then one cached step per token).  Each sampled call
takes its own explicit ``torch.Generator`` on the device (seeds 42 and
43, where the reference passes ``jax.random.key(42)`` / ``key(43)``).
On the card the attention runs in the hand-written flash kernels.  It
runs on the card unless asked for the CPU.

Run:

    python examples/generate_torch.py                 # card
    python examples/generate_torch.py --device cpu    # no card needed

Exit 0 with a learned continuation (greedy decode reproduces the
training pattern) is the pass criterion; the last line is ``OK``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VOCAB = 64
PERIOD = 7
SEQ = 32
PROMPT = 10
NEW = 12


def model_config():
    """The reference example's tiny Llama, in fp32."""
    import torch

    from ddl_tpu_torch.models import llama

    return llama.LlamaConfig(
        vocab=VOCAB, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=64, dtype=torch.float32,
    )


def pattern_tokens() -> np.ndarray:
    """A deterministic repeating pattern the model can memorise fast."""
    return np.tile(np.arange(SEQ, dtype=np.int32) % PERIOD, (8, 1))


def train(params, cfg, device: str, steps: int = 60):
    """``steps`` AdamW steps on the pattern over a one-position dp mesh;
    returns (params, last loss)."""
    import torch

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.mesh import make_mesh
    from ddl_tpu_torch.parallel.train import adamw, make_train_step

    mesh = make_mesh({"dp": 1}, [device])
    init_fn, step_fn = make_train_step(
        lambda p, b: llama.next_token_loss(p, b, cfg),
        adamw(1e-2), mesh=mesh, param_specs=llama.param_specs(cfg),
    )
    state = init_fn(params)
    tokens = torch.from_numpy(pattern_tokens()).to(device)
    loss = None
    for _ in range(steps):
        state, loss = step_fn(state, tokens)
    return state.params, float(loss)


def generate_three(params, prompt, cfg):
    """Greedy, temperature 0.8 (seed 42) and temperature 0.8 with
    top_p 0.9 / top_k 8 (seed 43) continuations of ``prompt``."""
    import torch

    from ddl_tpu_torch.models import llama

    def gen(seed):
        return torch.Generator(prompt.device).manual_seed(seed)

    greedy = llama.generate(params, prompt, cfg, max_new_tokens=NEW)
    sampled = llama.generate(params, prompt, cfg, max_new_tokens=NEW,
                             temperature=0.8, generator=gen(42))
    nucleus = llama.generate(params, prompt, cfg, max_new_tokens=NEW,
                             temperature=0.8, generator=gen(43),
                             top_p=0.9, top_k=8)
    return greedy, sampled, nucleus


def main(device: str = "cuda") -> int:
    import torch

    from ddl_tpu_torch.models import llama

    cfg = model_config()
    params, loss = train(llama.init_params(cfg, seed=0, device=device), cfg,
                         device)
    print(f"train loss after 60 steps: {loss:.4f}")

    tokens = pattern_tokens()
    prompt = torch.from_numpy(tokens[:4, :PROMPT]).to(device)
    greedy, sampled, nucleus = generate_three(params, prompt, cfg)
    continuation = greedy[:, PROMPT:].cpu().numpy()
    expected = np.tile(
        np.arange(PROMPT, PROMPT + NEW, dtype=np.int32) % PERIOD, (4, 1))
    ok = float((continuation == expected).mean())
    print(f"greedy continuation matches pattern: {ok:.0%}")
    print("sampled   :", sampled[0, PROMPT:].tolist())
    print("nucleus   :", nucleus[0, PROMPT:].tolist())
    for out in (sampled, nucleus):
        arr = out.cpu().numpy()
        assert arr.shape == (4, PROMPT + NEW)
        assert ((arr >= 0) & (arr < VOCAB)).all()

    if ok < 0.9:
        print("FAIL: model did not learn the pattern")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    sys.exit(main(ap.parse_args().device))
