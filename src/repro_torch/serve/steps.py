"""Serving step functions (prefill / decode), for the engine and the dry
run (`launch.dryrun`)."""
from __future__ import annotations

import torch

from repro_torch.models import Model


def prefill_all_positions(model: Model, tokens, backend: str = "auto",
                          shard: int = 0):
    """`Model.forward_prefill` returning logits at *every* position:
    tokens (b, s) -> (logits (b, s, V), per-layer caches). The serving
    session reads ``logits[:, prompt_len - 1]``; `backend` picks the
    flash-attention implementation. A `serve.sharding.ShardedModel`
    prefills on data shard `shard`."""
    if hasattr(model, "plan"):
        return model.prefill(tokens, shard, backend=backend, all_logits=True)
    x, positions, _ = model.inputs(tokens)
    x, caches = model.run_stack(x, mode="prefill", positions=positions,
                                backend=backend)
    return model.head(x), caches


def make_prefill_step(model: Model, backend: str = "auto"):
    """prefill_step(tokens (b, s) | embeds=, image_embeds=) -> (next
    tokens (b,) int32, caches): the argmax of `Model.forward_prefill`'s
    last-position logits, as the reference's `make_prefill_step`."""
    def prefill_step(tokens=None, *, embeds=None, image_embeds=None):
        logits, caches = model.forward_prefill(
            tokens, backend, embeds=embeds, image_embeds=image_embeds)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches
    return prefill_step


def make_decode_step(model: Model):
    """decode_step(caches, tokens (b, 1) | embeds=, pos) -> next tokens
    (b,) int32: the argmax of `Model.forward_decode`, which updates the
    capacity-sized caches (`pad_caches`) in place, as the reference's
    `make_decode_step` returns its new caches."""
    def decode_step(caches, tokens, pos: int, *, embeds=None):
        logits = model.forward_decode(tokens, caches, pos, embeds=embeds)
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return decode_step


def make_paged_decode_step(model: Model, state, backend: str = "auto"):
    """The paged counterpart of `make_decode_step`, closed over a
    `PagedKVState` in the eager (or numpy) mode: one call is one
    `paged_decode.paged_decode_step` — the per-layer path, each layer's
    kernel launched alone. ``decode_step(tokens (b,), seq_ids, pos) ->
    (next tokens (b,) int32, logits (b, V))``; `pos` is a scalar or (b,)
    positions, `seq_ids` may carry -1 padding rows."""
    from repro_torch.serve.paged_decode import paged_decode_step

    def decode_step(tokens, seq_ids, pos):
        logits = paged_decode_step(model, tokens, state, seq_ids, pos,
                                   backend=backend)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits
    return decode_step


def make_fused_decode_step(model: Model, state, backend: str = "auto",
                           greedy: bool = True, temperature: float = 1.0):
    """Step-function wrapper over the fused step
    (`paged_decode.build_fused_step`): one call is one token for the
    whole batch, the host's part reduced to the state's begin / end
    bookkeeping (`PagedKVState.run_fused` owns the transfer counts).
    ``decode_step(tokens, seq_ids, pos, generator=None) -> (host tokens,
    device tokens)``; it returns no logits, which never leave the device.
    Host `tokens` cost one extra upload a call; pass the previous call's
    device tokens to stay at 2 transfers a token."""
    from repro_torch.serve.paged_decode import build_fused_step

    fused = build_fused_step(model, state.slots, backend=backend,
                             greedy=greedy, temperature=temperature,
                             layout=state.layout)

    def decode_step(tokens, seq_ids, pos, generator=None):
        return state.run_fused(fused, tokens, seq_ids, pos, generator)
    return decode_step
