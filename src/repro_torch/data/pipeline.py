"""Deterministic, resumable, host-sharded synthetic token pipeline — a
copy of the JAX package's ``repro/data/pipeline.py`` (numpy only; the
port imports nothing of that package), so a batch is the reference's
batch for the same ``(seed, step, shard)``.

Batches derive from (seed, step, host_shard) through a counter-based hash —
any worker can reconstruct any step's batch (checkpoint resume and elastic
re-sharding need no data-state beyond the step counter). Double-buffered
prefetch thread hides host->device copy (the CAPI double-buffering analogue
of thesis §3.3.1).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def _batch_rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


class TokenPipeline:
    """Synthetic LM batches with a Markov-ish structure so loss can fall."""

    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 seed: int = 0, num_shards: int = 1, shard: int = 0):
        assert global_batch % num_shards == 0
        self.cfg = cfg
        self.seq = seq_len
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard
        self.step = 0

    def batch_at(self, step: int) -> dict:
        rng = _batch_rng(self.seed, step, self.shard)
        v = self.cfg.vocab_size
        b, s = self.local_batch, self.seq
        # structured stream: tokens follow t+1 = (a*t + noise) mod v so a
        # model can learn next-token structure
        a = 31
        t0 = rng.integers(0, v, size=(b, 1))
        noise = rng.integers(0, 7, size=(b, s))
        toks = np.zeros((b, s), np.int64)
        toks[:, 0] = t0[:, 0]
        for i in range(1, s):
            toks[:, i] = (a * toks[:, i - 1] + noise[:, i]) % v
        batch = {}
        inputs = toks[:, :-1] if s > 1 else toks
        labels = toks[:, 1:] if s > 1 else toks
        pad = lambda x: np.pad(x, ((0, 0), (0, s - x.shape[1])))
        if self.cfg.external_embed:
            d = self.cfg.d_model
            emb = rng.standard_normal((b, s, d)).astype(np.float32)
            batch["embeds"] = emb
        else:
            batch["tokens"] = pad(inputs).astype(np.int32)
        batch["labels"] = pad(labels).astype(np.int32)
        if self.cfg.n_img_tokens:
            batch["image_embeds"] = rng.standard_normal(
                (b, self.cfg.n_img_tokens, self.cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1

    # -- resumable state ------------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed, "shard": self.shard}

    def restore(self, state: dict):
        assert state["seed"] == self.seed and state["shard"] == self.shard, \
            "pipeline identity mismatch"
        self.step = state["step"]


class Prefetcher:
    """Background-thread double buffering (depth-2 queue)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
