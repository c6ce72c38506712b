"""Pipeline-parallel LM pretraining on the PyTorch port: token stream →
Trainer → staged Llama.

The twin of ``examples/train_llama_pp.py``: the decoder blocks regroup
into ``pp`` pipeline stages (the GPipe microbatch schedule, buffers
hopping through ``collectives.ppermute``), each stage holding its own
layers; with a ``tp`` axis the stages run tensor-parallel resident (each
tp position computes its column and row blocks, two sums a layer).  The
data path is unchanged: token-stream producers, window rings and the
window-stream fit feed the pipelined step.  The mesh is 8 positions of
one device (the card unless asked for the CPU), the layout the
reference's CPU run takes over 8 virtual devices.

Run:

    python examples/train_llama_pp_torch.py            # pp=2 x dp=4
    python examples/train_llama_pp_torch.py pp_tp      # pp=2 x tp=2 x dp=2
    python examples/train_llama_pp_torch.py pp_1f1b    # interleaved 1F1B
                                                       # (2 chunks a position:
                                                       # bubble 0.111 vs
                                                       # gpipe's 0.2 at
                                                       # pp=2, M=4)
    python examples/train_llama_pp_torch.py pp --device cpu

Exit 0 with finite, decreasing loss is the pass criterion.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from train_llama_torch import (  # noqa: E402 - the shared synthetic corpus
    SEQ_LEN,
    VOCAB,
    WINDOW_ROWS,
    _token_file_valid,
    make_token_file,
)

LAYOUTS = ("pp", "pp_tp", "pp_1f1b")
N_POSITIONS = 8


def main(layout: str = "pp", device: str = "cuda") -> int:
    from ddl_tpu_torch.config import LoaderConfig, TrainConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel import bubble_fraction
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer
    from ddl_tpu_torch.utils import resolve_device

    token_file = os.path.join(tempfile.gettempdir(), "ddl_tpu_torch_tokens.bin")
    if not _token_file_valid(token_file):
        make_token_file(token_file)

    n_micro = 4
    # The pipeline knobs ride TrainConfig (env-overridable as
    # DDL_TORCH_TRAIN_*): pp_1f1b selects the interleaved schedule.
    tc = TrainConfig.load(
        schedule="1f1b" if layout == "pp_1f1b" else "gpipe",
        pp_chunks=2 if layout == "pp_1f1b" else 0,
        n_microbatches=n_micro,
    )
    if layout == "pp_tp":
        axes = {"pp": 2, "tp": 2, "dp": N_POSITIONS // 4}
    else:
        axes = {"pp": 2, "dp": N_POSITIONS // 2}
    dev = resolve_device(device)
    mesh = make_mesh(axes, [dev] * N_POSITIONS)
    n_chunks = tc.pp_chunks or 1
    print(f"mesh {axes}, {n_micro} microbatches, schedule={tc.schedule}, "
          f"bubble={bubble_fraction(axes['pp'], n_micro, schedule=tc.schedule, n_chunks=tc.pp_chunks or None):.3f}")

    model = tc.model_config(llama.LlamaConfig(
        vocab=VOCAB, d_model=128, n_layers=4, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq=SEQ_LEN,
    ))
    cfg = LoaderConfig.load(batch_size=8, n_epochs=6, n_producers=2,
                            mode="thread", nslots=2, output="device",
                            window_stream=True)
    trainer = Trainer(
        loss_fn=lambda p, b: llama.next_token_loss_pp(
            p, b[0], model, mesh, n_microbatches=tc.n_microbatches,
            **tc.pipeline_kwargs(),
        ),
        optimizer=adamw(3e-3),
        init_params=llama.stage_params(
            llama.init_params(model, seed=0, device=dev), axes["pp"],
            n_chunks=n_chunks,
        ),
        device=dev,
        train_config=tc,
        mesh=mesh,
        param_specs=llama.pp_param_specs(model, n_chunks=n_chunks),
        batch_spec=P(("dp",)),
    )
    result = trainer.fit(
        TokenStreamProducer(token_file, SEQ_LEN, WINDOW_ROWS), config=cfg,
    )
    print("epoch losses:", [round(loss, 4) for loss in result.losses])
    ok = (all(np.isfinite(loss) for loss in result.losses)
          and result.losses[-1] < result.losses[0])
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("layout", nargs="?", default="pp", choices=LAYOUTS)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    sys.exit(main(args.layout, args.device))
