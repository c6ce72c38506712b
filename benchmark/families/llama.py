"""The decoder family on the port: ``ddl_tpu_torch.models.llama`` with the
configuration's widths, bfloat16 compute over float32 master weights."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from benchmark import flops


def program_config(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Any:
    from ddl_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        max_seq=int(traffic["seq_len"]), rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"],
        dtype=getattr(torch, cfg["compute_dtype"]),
        param_dtype=getattr(torch, cfg["param_dtype"]),
    )


def loss_fn(pcfg: Any, traffic: Dict[str, Any]) -> Callable[[Any, Any], Any]:
    from ddl_tpu_torch.models import llama

    return lambda p, b: llama.next_token_loss(p, b[0], pcfg)


def items_per_step(traffic: Dict[str, Any]) -> Tuple[str, int]:
    return "tokens", int(traffic["batch_size"]) * int(traffic["seq_len"])


def step_flops(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> float:
    seq = int(traffic["seq_len"])
    return int(traffic["batch_size"]) * seq * flops.decoder_flops_per_token(
        cfg["hidden_size"], cfg["num_attention_heads"],
        cfg["num_key_value_heads"], cfg["intermediate_size"],
        cfg["num_hidden_layers"], cfg["vocab_size"], seq)


def attention(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    """One step's attention calls: their shape and count."""
    return dict(batch=int(traffic["batch_size"]), seq=int(traffic["seq_len"]),
                heads=cfg["num_attention_heads"],
                kv_heads=cfg["num_key_value_heads"],
                head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
                causal=True, calls=cfg["num_hidden_layers"])
