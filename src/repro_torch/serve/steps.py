"""Serving step functions."""
from __future__ import annotations

import torch

from repro_torch.models import Model


def prefill_all_positions(model: Model, tokens):
    """`Model.forward_prefill` returning logits at *every* position:
    tokens (b, s) -> (logits (b, s, V), per-layer caches). The serving
    session reads ``logits[:, prompt_len - 1]``."""
    x = model.embed_in(tokens)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x, caches = model.run_stack(x, mode="prefill", positions=positions)
    return model.head(x), caches
