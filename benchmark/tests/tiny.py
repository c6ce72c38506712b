"""Cells at widths a CPU test can hold, of the same families and traffic
sources as the benchmark's cells, with the benchmark's limits but one.

``update_gap_median`` reads higher at these widths than on the card's
cells (sound CPU runs 1.8e-4-4.9e-4 over 13 seeds a family, the float8
control 2.3e-3-3.6e-3 on three), so the tiny cells hold it to a limit
set from those readings as the card's limit is from the card's."""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict

from benchmark import run

LLAMA = {
    "name": "tiny-llama", "family": "llama", "hidden_act": "silu",
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "vocab_size": 256, "compute_dtype": "bfloat16",
    "param_dtype": "float32",
    "optimizer": {"name": "adamw", "lr": 1e-3, "b1": 0.9, "b2": 0.999,
                  "eps": 1e-8, "weight_decay": 1e-4},
}
TOKENS = {"source": "token_stream", "n_tokens": 32768, "zipf_a": 1.2,
          "seq_len": 32, "batch_size": 4, "steps_per_window": 2,
          "producers": 2, "nslots": 2, "mode": "thread", "judged_steps": 3,
          "trace_windows": 2}
VIT = {
    "name": "tiny-vit", "family": "vit", "image_size": 16, "patch_size": 4,
    "num_channels": 3, "hidden_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 2, "intermediate_size": 64, "num_labels": 10,
    "norm_eps": 1e-5, "compute_dtype": "bfloat16", "param_dtype": "float32",
    "optimizer": {"name": "adamw", "lr": 1e-3, "b1": 0.9, "b2": 0.999,
                  "eps": 1e-8, "weight_decay": 1e-4},
}
IMAGES = {"source": "image_shards", "n_shards": 4, "rows_per_shard": 8,
          "label_zipf_a": 1.5, "normalize_mean": [0.485, 0.456, 0.406],
          "normalize_std": [0.229, 0.224, 0.225],
          "cache_ram_bytes": 5 * 8 * (16 * 16 * 3 + 1) * 4, "batch_size": 8,
          "steps_per_window": 1, "producers": 2, "nslots": 2,
          "mode": "thread", "judged_steps": 3, "trace_windows": 2}

#: ``update_gap_median``'s limit at these widths.
UPDATE_GAP_MEDIAN = 1.2e-3

_CELLS = {"tokens": (LLAMA, TOKENS, "mistral-7b.tokens"),
          "images": (VIT, IMAGES, "vit-b16.images")}


def spec(kind: str) -> Dict[str, Any]:
    """A tiny cell of ``kind`` ("tokens" or "images") with the
    limits (but :data:`UPDATE_GAP_MEDIAN`) and metrics of the benchmark
    cell of that family."""
    config, traffic, workload = _CELLS[kind]
    full = run.cell_spec(workload)
    full["config"] = copy.deepcopy(config)
    full["traffic"] = copy.deepcopy(traffic)
    full["limits"] = dict(full["limits"], update_gap_median=UPDATE_GAP_MEDIAN)
    return full
