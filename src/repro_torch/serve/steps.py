"""Serving step functions."""
from __future__ import annotations

import torch

from repro_torch.models import Model


def prefill_all_positions(model: Model, tokens, backend: str = "auto"):
    """`Model.forward_prefill` returning logits at *every* position:
    tokens (b, s) -> (logits (b, s, V), per-layer caches). The serving
    session reads ``logits[:, prompt_len - 1]``; `backend` picks the
    flash-attention implementation."""
    x = model.embed_in(tokens)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x, caches = model.run_stack(x, mode="prefill", positions=positions,
                                backend=backend)
    return model.head(x), caches
