"""Per-layer paged-state layout, for stacks of global-attention layers.

The part of ``repro/serve/paged_state.py`` that an ATTN-only stack needs:
which layers own the pool's layer axis (`kv_of`), the column layout of
the per-step int32 control block for one or k tokens per row (`cols`),
and the page charge per request (`pages_needed`). Ring pages (sliding
window) and recurrent slots (SSM, RG-LRU) are a later slice: any other
mixer raises.
"""
from __future__ import annotations

from repro_torch.configs.base import ATTN


class ControlCols:
    """Column offsets into the per-step int32 control block for a table of
    `slots` pages. ``k == 1`` (plain decode): ``[page table | tail slot |
    tail row | position | kv length]``. ``k > 1`` (speculative verify and
    chunk fill): ``[page table | tail slot | spill slot | tail row |
    position | kv length | k input tokens]``."""

    def __init__(self, slots: int, k: int = 1):
        s = slots
        if k == 1:
            self.tail, self.row, self.pos, self.len = s, s + 1, s + 2, s + 3
            self.width = s + 4
        else:
            self.tail, self.spill = s, s + 1
            self.row, self.pos, self.len = s + 2, s + 3, s + 4
            self.tok = s + 5
            self.width = s + 5 + k


class StateLayout:
    """Static map of a config's layer stack onto the KV page pool."""

    def __init__(self, cfg, page_tokens: int):
        mixers = [m for m, _ in cfg.layer_kinds()]
        other = sorted(set(mixers) - {ATTN})
        if other:
            raise NotImplementedError(
                f"{cfg.name}: paged state for {other} layers is not ported — "
                f"the port serves global-attention stacks")
        self.cfg = cfg
        self.page_tokens = page_tokens
        self.kv_of = {l: l for l in range(len(mixers))}
        self.n_kv = len(mixers)

    def cols(self, slots: int, k: int = 1) -> ControlCols:
        return ControlCols(slots, k)

    def pages_needed(self, cap_tokens: int, tail_slots: int = 1) -> int:
        """Pool-page charge for a request growing to ``cap_tokens``: one
        page per ``page_tokens`` plus the tail page(s), per KV layer."""
        return self.n_kv * (-(-cap_tokens // self.page_tokens) + tail_slots)
