"""End-to-end image classification on the PyTorch port: WebDataset tar
shards → Trainer → ViT.

The twin of ``examples/train_vit.py`` at the same scale: synthetic tar
shards in the WebDataset layout (``<key>.png`` + ``<key>.cls``) are
streamed by :class:`~ddl_tpu_torch.readers.WebDatasetProducer` workers
and a vision transformer trains on the loader's ``(pixels, label)``
columns through ``Trainer.fit`` over a dp mesh — the hand-written flash
kernels on the card, dense attention on the CPU.  It runs on the card
unless asked for the CPU.

Decoding PNG needs Pillow (``PIL``), which only this example and the
WebDataset producer import.

Run:

    python examples/train_vit_torch.py                  # THREAD, card
    python examples/train_vit_torch.py process          # spawned producers
    python examples/train_vit_torch.py --device cpu     # no card needed

Exit 0 with finite, decreasing loss is the pass criterion; the last line
starts with ``PASS``.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tarfile
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

IMAGE_SIZE = 16
N_CLASSES = 4
SHARDS = 2
SAMPLES_PER_SHARD = 32


def make_shards(dirpath: str) -> str:
    """Synthetic labeled shards: class k images are brightness-banded, so
    the task is learnable."""
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit("this example needs Pillow (PIL)") from e

    rng = np.random.default_rng(0)
    os.makedirs(dirpath, exist_ok=True)
    for s in range(SHARDS):
        path = os.path.join(dirpath, f"train-{s:04d}.tar")
        tmp = f"{path}.tmp.{os.getpid()}"
        with tarfile.open(tmp, "w") as tf:
            for i in range(SAMPLES_PER_SHARD):
                label = (s * SAMPLES_PER_SHARD + i) % N_CLASSES
                base = 40 + label * 50
                arr = np.clip(
                    rng.normal(base, 12, (IMAGE_SIZE, IMAGE_SIZE, 3)),
                    0, 255,
                ).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="PNG")
                for name, data in (
                    (f"{s}-{i}.png", buf.getvalue()),
                    (f"{s}-{i}.cls", str(label).encode()),
                ):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        os.replace(tmp, path)
    return os.path.join(dirpath, "train-*.tar")


def main(mode: str = "thread", device: str = "cuda") -> int:
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import vit
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import WebDatasetProducer
    from ddl_tpu_torch.trainer import Trainer
    from ddl_tpu_torch.utils import resolve_device

    resolve_device(device)  # no card and no --device cpu: stop here
    pattern = make_shards(
        os.path.join(tempfile.gettempdir(), "ddl_tpu_torch_wds")
    )
    cfg = LoaderConfig(
        batch_size=8,
        n_epochs=6,
        n_producers=2,
        mode=mode,
        nslots=2,
        output="device",
    )
    model = vit.ViTConfig(
        image_size=IMAGE_SIZE, patch_size=4, d_model=64, n_layers=2,
        n_heads=4, d_ff=128, n_classes=N_CLASSES,
    )
    # One dp position a local card (every visible card: -1), or the CPU.
    mesh = make_mesh({"dp": -1}, ["cpu"] if device == "cpu" else None)
    trainer = Trainer(
        loss_fn=lambda p, b: vit.classification_loss(p, b, model),
        optimizer=adamw(1e-3),
        init_params=vit.init_params(model, seed=0, device=device),
        device=device,
        mesh=mesh,
        param_specs=vit.param_specs(model),
        batch_spec=P(("dp",)),
    )
    result = trainer.fit(
        WebDatasetProducer(pattern, image_size=IMAGE_SIZE, window_rows=16),
        config=cfg,
    )
    print("epoch losses:", [round(loss, 4) for loss in result.losses])
    ok = (
        all(np.isfinite(loss) for loss in result.losses)
        and result.losses[-1] < result.losses[0]
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
