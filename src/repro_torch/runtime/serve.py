"""Serving helpers shared by the shell's ``ElasticServer``."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.config import ModelConfig


def greedy_tokens(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Greedy next-token over the true vocab (masks the padded tail)."""
    masked = torch.where(
        torch.arange(logits.shape[-1], device=logits.device) < vocab,
        logits, -torch.inf)
    return torch.argmax(masked, dim=-1).to(torch.int32)


def extra_decode_inputs(cfg: ModelConfig, batch_size: int, dtype,
                        device="cpu") -> Dict[str, torch.Tensor]:
    """Per-family auxiliary decode inputs: zero encoder frames for enc-dec
    (its ``decode_step`` does not read them, as in the JAX package); the
    other families need none."""
    extras: Dict[str, torch.Tensor] = {}
    if cfg.family == "encdec":
        extras["frames"] = torch.zeros(
            (batch_size, cfg.encoder_len, cfg.d_model), dtype=dtype,
            device=device)
    return extras
