"""End-to-end LM pretraining on the PyTorch port: token stream → Trainer
→ flash Llama → greedy KV-cache decode.

The twin of ``examples/train_llama.py`` at the same laptop scale: a
synthetic flat token file is served by :class:`TokenStreamProducer`
workers, each window crosses to the device as one copy, and the
window-stream ``Trainer.fit`` runs a 2-layer Llama (head_dim 32) with the
hand-written CUDA flash-attention kernels on the card (dense attention
on the CPU).  The run's knobs come from the layered configs: defaults →
``DDL_TORCH_*`` env → the arguments below.  It runs on the card unless
asked for the CPU.

Run:

    python examples/train_llama_torch.py                  # THREAD, card
    python examples/train_llama_torch.py process          # spawned producers
    python examples/train_llama_torch.py --device cpu     # no card needed
    DDL_TORCH_N_PRODUCERS=4 python examples/train_llama_torch.py process

    # ZeRO-1 optimizer-state sharding over dp (and int8 grad comm) ride
    # the standard TrainConfig env (ddl_tpu_torch/parallel/optimizer.py):
    DDL_TORCH_TRAIN_OPTIMIZER_SHARDING=zero1 python examples/train_llama_torch.py
    DDL_TORCH_TRAIN_OPTIMIZER_SHARDING=zero1 DDL_TORCH_TRAIN_GRAD_COMM=int8 \
        python examples/train_llama_torch.py

The trainer runs over ``make_mesh({"dp": <local cards>})`` with the
model's ``param_specs``, as the reference does; a mesh over several
distinct cards waits for the multi-card slice.

Exit 0 with finite, decreasing loss and a 32-token continuation inside
the vocab is the pass criterion.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEQ_LEN = 128
WINDOW_ROWS = 32
VOCAB = 512
N_TOKENS = 200_000


def make_token_file(path: str) -> None:
    """A synthetic corpus of learnable bigrams (each token mostly
    determines its successor), written atomically (temp + rename)."""
    rng = np.random.default_rng(0)
    succ = rng.integers(0, VOCAB, VOCAB)
    toks = np.empty(N_TOKENS, np.int32)
    toks[0] = 1
    noise = rng.random(N_TOKENS) < 0.1
    randoms = rng.integers(0, VOCAB, N_TOKENS)
    for i in range(1, N_TOKENS):
        toks[i] = randoms[i] if noise[i] else succ[toks[i - 1]]
    tmp = f"{path}.tmp.{os.getpid()}"
    toks.tofile(tmp)
    os.replace(tmp, path)


def _token_file_valid(path: str) -> bool:
    return (
        os.path.exists(path)
        and os.path.getsize(path) == N_TOKENS * 4
        and int(np.memmap(path, np.int32, mode="r").max()) < VOCAB
    )


def main(mode: str = "thread", device: str = "cuda") -> int:
    import torch

    from ddl_tpu_torch.config import LoaderConfig, TrainConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    token_file = os.path.join(tempfile.gettempdir(), "ddl_tpu_torch_tokens.bin")
    if not _token_file_valid(token_file):
        make_token_file(token_file)

    # n_producers (and any field not set here) comes from DDL_TORCH_*.
    cfg = LoaderConfig.load(
        batch_size=8, n_epochs=6, mode=mode, nslots=2, output="device",
        window_stream=True,
    )
    # TrainConfig.load() picks up DDL_TORCH_TRAIN_* from the env:
    # optimizer_sharding=zero1 shards AdamW's moments over dp (inert at
    # dp=1; the loss trajectory is bit-identical either way).
    train_config = TrainConfig.load()
    model = train_config.model_config(llama.LlamaConfig(
        vocab=VOCAB, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq=SEQ_LEN,
    ))
    # One dp position a local card (every visible card: -1), or the CPU.
    mesh = make_mesh({"dp": -1}, ["cpu"] if device == "cpu" else None)
    trainer = Trainer(
        loss_fn=lambda p, b: llama.next_token_loss(p, b[0], model, mesh=mesh),
        optimizer=adamw(3e-3),
        init_params=llama.init_params(model, seed=0, device=device),
        device=device,
        train_config=train_config,
        mesh=mesh,
        param_specs=llama.param_specs(model),
        batch_spec=P(("dp",)),
    )
    result = trainer.fit(
        TokenStreamProducer(token_file, SEQ_LEN, WINDOW_ROWS), config=cfg,
    )
    print("epoch losses:", [round(loss, 4) for loss in result.losses])

    # Inference on the trained weights: greedy continuation through the
    # KV-cache decode path (one cached prefill, then one step per token).
    prompt = torch.from_numpy(
        np.array(np.memmap(token_file, np.int32, mode="r")[:16])[None]
    ).to(trainer.device)
    continued = llama.generate(
        result.state.params, prompt, model, max_new_tokens=16
    )
    print("generated continuation:", continued[0, 16:].tolist())

    ok = (
        all(np.isfinite(loss) for loss in result.losses)
        and result.losses[-1] < result.losses[0]
        and tuple(continued.shape) == (1, 32)
        and int(continued.max()) < VOCAB
    )
    print("PASS" if ok else "FAIL", "- final loss", result.losses[-1])
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="thread",
                    choices=("thread", "process"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    sys.exit(main(args.mode, args.device))
