"""Serving step functions."""
from __future__ import annotations

from repro_torch.models import Model


def prefill_all_positions(model: Model, tokens, backend: str = "auto"):
    """`Model.forward_prefill` returning logits at *every* position:
    tokens (b, s) -> (logits (b, s, V), per-layer caches). The serving
    session reads ``logits[:, prompt_len - 1]``; `backend` picks the
    flash-attention implementation."""
    x, positions, _ = model.inputs(tokens)
    x, caches = model.run_stack(x, mode="prefill", positions=positions,
                                backend=backend)
    return model.head(x), caches
