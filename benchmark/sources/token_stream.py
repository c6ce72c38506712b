"""``token_stream``: ``n_tokens`` int32 ids drawn from a Zipf law of
exponent ``zipf_a`` over the configuration's vocabulary (rank ``r`` has
weight ``r**-zipf_a``), served by ``TokenStreamProducer``: producer ``p``
of ``P`` owns the sequences ``p-1, p-1+P, ...`` of ``seq_len`` tokens and
each window draws ``batch_size * steps_per_window`` of them without
replacement from ``numpy.random.default_rng([seed, 0, p])``."""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator

import numpy as np
import torch

from benchmark import generate
from benchmark.reference.stream import row_sums

#: The generator stream of the seed that draws the ids.
_TOKENS = 1


def ids(traffic: Dict[str, Any], vocab: int, seed: int,
        device: Any) -> np.ndarray:
    gen = generate.generator(seed, _TOKENS, device)
    out = generate.zipf(int(traffic["n_tokens"]), vocab,
                        float(traffic["zipf_a"]), gen, device)
    return out.to(torch.int32).cpu().numpy()


def write(traffic: Dict[str, Any], config: Dict[str, Any], seed: int,
          directory: str, device: Any) -> Dict[str, Any]:
    path = os.path.join(directory, "tokens.int32")
    ids(traffic, int(config["vocab_size"]), seed, device).tofile(path)
    return {"token_file": path}


def _rows(traffic: Dict[str, Any]) -> int:
    return int(traffic["batch_size"]) * int(traffic["steps_per_window"])


def producer(traffic: Dict[str, Any], inputs: Dict[str, Any], seed: int,
             config: Dict[str, Any]) -> Any:
    from ddl_tpu_torch import readers

    return readers.TokenStreamProducer(
        inputs["token_file"], int(traffic["seq_len"]), _rows(traffic),
        seed=seed)


def windows(inputs: Dict[str, Any], traffic: Dict[str, Any], seed: int,
            producer_index: int) -> Iterator[tuple]:
    tokens = np.memmap(inputs["token_file"], dtype=np.int32, mode="r")
    seq, rows = int(traffic["seq_len"]), _rows(traffic)
    mine = np.arange(producer_index - 1, len(tokens) // seq,
                     int(traffic["producers"]))
    rng = np.random.default_rng([seed, 0, producer_index])
    while True:
        pick = rng.choice(mine, rows, replace=len(mine) < rows)
        win = np.stack([tokens[int(i) * seq:(int(i) + 1) * seq] for i in pick])
        yield row_sums(win), (lambda w=win: w)
