"""Speculative multi-token decode: draft proposers + per-request stats.

The port of ``repro/serve/speculative.py`` (the port imports nothing of
that package). A cheap proposer drafts ``k - 1`` tokens per request, one
widened fused step (`paged_decode.build_fused_step(k=...)`) scores all k
rows against the page pool in one pass, and the accept rule keeps the
matched prefix plus one bonus token: 2 host<->device transfers per
accepted run of up to k tokens.

Draft proposers are host-side and deterministic: they only steer *which*
tokens get verified, never what the model emits, so greedy verification
is token-for-token the 1-token path for any proposer.

- ``ngram``: `NGramDraft`, prompt-lookup decoding — match the history's
  final n-gram against earlier history and propose what followed it.
- ``self``: `ModelDraft` over the serving model — greedy continuation by
  one full-context prefill (through the flash-attention kernel) per
  draft token.
- any object with ``propose(history, n)``; `make_draft` resolves all
  three.
"""
from __future__ import annotations

import numpy as np
import torch


class NGramDraft:
    """Prompt-lookup drafting: find the most recent earlier occurrence of
    the history's final ``n``-gram (falling back to shorter grams) and
    propose the tokens that followed it; with no match, repeat the last
    token. Proposals shorter than requested are padded by repeating their
    last token — padding can only lose acceptances, never correctness."""

    name = "ngram"

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError(f"n-gram order must be >= 1, got {n}")
        self.n = n

    def propose(self, history: np.ndarray, n_draft: int) -> np.ndarray:
        h = np.asarray(history, np.int32)
        if n_draft <= 0:
            return np.zeros(0, np.int32)
        for gl in range(min(self.n, len(h) - 1), 0, -1):
            pat = h[len(h) - gl:]
            # candidate windows start strictly before the final suffix
            body = h[:len(h) - 1]
            if len(body) < gl:
                continue
            win = np.lib.stride_tricks.sliding_window_view(body, gl)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            if not len(hits):
                continue
            start = int(hits[-1]) + gl          # most recent occurrence
            cont = h[start:start + n_draft]
            if not len(cont):
                continue
            if len(cont) < n_draft:
                cont = np.concatenate(
                    [cont, np.full(n_draft - len(cont), cont[-1], np.int32)])
            return cont.astype(np.int32)
        return np.full(n_draft, h[-1], np.int32)


class ModelDraft:
    """Draft by greedy continuation of a (usually smaller) model: one
    full-context prefill per draft token, so it keeps no draft-side KV
    cache to roll back. Pointed at the serving model itself this is the
    ``self`` draft, whose acceptance is near 1. ``backend`` picks the
    flash-attention implementation of its prefills."""

    name = "model"

    def __init__(self, model, backend: str = "auto"):
        self.model, self.backend = model, backend

    def propose(self, history: np.ndarray, n_draft: int) -> np.ndarray:
        from repro_torch.serve.steps import prefill_all_positions
        toks = np.asarray(history, np.int32)
        device = next(self.model.parameters()).device
        out = []
        for _ in range(max(0, n_draft)):
            logits, _ = prefill_all_positions(
                self.model, torch.from_numpy(toks[None]).to(device),
                backend=self.backend)
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            toks = np.append(toks, np.int32(nxt))
        return np.asarray(out, np.int32)


def make_draft(draft, model=None, backend: str = "auto"):
    """Resolve a draft argument: ``"ngram"`` / ``"ngram:N"`` (order N),
    ``"self"`` (the serving `model` drafts for itself), or any object
    already exposing ``propose(history, n)``."""
    if hasattr(draft, "propose"):
        return draft
    if isinstance(draft, str):
        if draft == "ngram" or draft.startswith("ngram:"):
            n = int(draft.split(":", 1)[1]) if ":" in draft else 3
            return NGramDraft(n=n)
        if draft == "self":
            if model is None:
                raise ValueError("draft='self' needs the serving model to "
                                 "draft with")
            return ModelDraft(model, backend=backend)
    raise ValueError(f"unknown draft {draft!r}: expected 'ngram[:N]', "
                     f"'self', or an object with propose(history, n)")


class SpecStats:
    """Per-request accounting in the reference's format: ``proposed``
    draft tokens, ``accepted`` (drafts that survived verification AND were
    kept after eos/max_new clamping), ``steps`` verify steps the request
    was live, ``tokens`` emitted. Without speculation every step emits one
    token and ``proposed`` / ``accepted`` stay 0."""

    __slots__ = ("steps", "proposed", "accepted", "tokens")

    def __init__(self):
        self.steps = 0
        self.proposed = 0
        self.accepted = 0
        self.tokens = 0

    @property
    def accept_rate(self):
        return self.accepted / self.proposed if self.proposed else None

    @property
    def tokens_per_step(self):
        return self.tokens / self.steps if self.steps else 0.0

    def as_dict(self) -> dict:
        return {"tokens": self.tokens, "steps": self.steps,
                "tokens_per_step": self.tokens_per_step,
                "proposed": self.proposed, "accepted": self.accepted,
                "accept_rate": self.accept_rate}
