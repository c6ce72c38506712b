"""``image_shards``: ``n_shards`` ``.npy`` files of ``rows_per_shard`` rows
``[pixels..., label]`` in float32, served by ``FileShardProducer`` through
a RAM shard cache of ``cache_ram_bytes``.

Labels follow a Zipf law of exponent ``label_zipf_a`` over the classes;
each pixel is uniform in [0, 0.5) plus half the label's share of the
classes, so brightness tracks the label, then normalised per channel with
``normalize_mean`` / ``normalize_std``, as torchvision's ``ToTensor`` +
``Normalize`` hand images to a trainer.

Producer ``p`` of ``P`` owns the sorted shards ``p-1, p-1+P, ...``,
serves them in turn, one a window, its rows in the order of a fresh
``numpy.random.default_rng([seed, p])`` permutation each time.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Iterator

import numpy as np
import torch

from benchmark import generate
from benchmark.reference.stream import row_sums

#: The generator stream of the seed that draws the shards.
_SHARDS = 3


def shard(traffic: Dict[str, Any], config: Dict[str, Any], seed: int,
          index: int, device: Any) -> np.ndarray:
    """Shard ``index``: (rows, pixels + 1)."""
    rows = int(traffic["rows_per_shard"])
    side, ch = int(config["image_size"]), int(config["num_channels"])
    classes = int(config["num_labels"])
    gen = generate.generator(seed * 4099 + index, _SHARDS, device)
    labels = generate.zipf(rows, classes, float(traffic["label_zipf_a"]),
                           gen, device)
    px = torch.rand((rows, side * side, ch), generator=gen,
                    dtype=torch.float32, device=device)
    px.mul_(0.5).add_((0.5 / classes) * labels.to(torch.float32)[:, None, None])
    mean = torch.tensor(traffic["normalize_mean"], dtype=torch.float32,
                        device=device)
    std = torch.tensor(traffic["normalize_std"], dtype=torch.float32,
                       device=device)
    px.sub_(mean).div_(std)
    out = torch.cat([px.reshape(rows, -1),
                     labels.to(torch.float32)[:, None]], dim=1)
    return out.cpu().numpy()


def write(traffic: Dict[str, Any], config: Dict[str, Any], seed: int,
          directory: str, device: Any) -> Dict[str, Any]:
    for i in range(int(traffic["n_shards"])):
        np.save(os.path.join(directory, f"shard-{i:03d}.npy"),
                shard(traffic, config, seed, i, device))
    return {"shard_pattern": os.path.join(directory, "shard-*.npy")}


def producer(traffic: Dict[str, Any], inputs: Dict[str, Any], seed: int,
             config: Dict[str, Any]) -> Any:
    from ddl_tpu_torch import readers
    from ddl_tpu_torch.cache import CacheStore

    px = config["image_size"] ** 2 * config["num_channels"]
    store = CacheStore(ram_budget_bytes=int(traffic["cache_ram_bytes"]))
    return readers.FileShardProducer(
        inputs["shard_pattern"], splits=(px, 1), seed=seed, cache=store)


def windows(inputs: Dict[str, Any], traffic: Dict[str, Any], seed: int,
            producer_index: int) -> Iterator[tuple]:
    paths = sorted(glob.glob(inputs["shard_pattern"]))
    mine = paths[producer_index - 1::int(traffic["producers"])]
    shards = [np.load(p, mmap_mode="r") for p in mine]
    sums = [row_sums(np.asarray(s)) for s in shards]
    rng = np.random.default_rng([seed, producer_index])
    cursor = 0
    while True:
        i = cursor % len(shards)
        cursor += 1
        perm = rng.permutation(len(shards[i]))
        yield sums[i][perm], (lambda s=shards[i], p=perm: np.asarray(s)[p])
