"""Serving engine over one model — the port of ``repro/serve/engine.py``:
paged decode in the reference's three modes, and the dense-cache path of
an engine without a page pool.

- `generate` — static lockstep batch: prefill the (left-padded) prompts
  through the flash-attention kernel, write their K/V into the
  `PagedKVPool`, then decode every row through the fused step
  (`serve.paged_decode.build_fused_step`). Without a pool it decodes
  from dense capacity-sized caches (`Model.forward_decode`, the batch
  at one shared position), as the reference does — the only path that
  serves an MLA stack (minicpm3-4b).
- `serve` — continuous batching over a `ServeSession`: a `Scheduler`
  admits requests into free decode rows mid-flight (admission gated on
  pool headroom, crediting radix-cached prompt pages), each row decodes
  at its own position, and retiring (per-request ``max_new_tokens`` or
  ``eos_token``) frees the request's pages. By default, as in the
  reference, prompts prefill in page-sized chunks riding the widened
  fused steps and a radix prefix cache lets later requests adopt cached
  prompt pages; ``chunked_prefill=False`` prefills each prompt in one
  pass at admission.

Paged decode runs in one of the reference's three modes (``decode_mode``,
`serve.paged_decode.MODES`): ``fused`` (the default) runs the whole token
as one step over the device-resident pool — two host/device transfers a
token, whatever the depth; ``eager`` is the per-layer reference path the
fused step is tested against (each layer's K/V rows back to the host and
into the same device pool, its kernel launched alone); ``numpy``
assembles each layer's pool arrays on the host every step and uploads
them for the call (``device_gather=False`` without a mode picks it). Eager
and numpy decode one token a step over pure global-attention stacks, with
monolithic prefill in `serve()` and `ServeSession`, unsharded on a mesh's
first device; speculation, chunked prefill and hybrid stacks raise there,
as in the reference.

Speculative decode (``speculate=k`` on the engine or per `Request`): a
draft proposer (`serve.speculative`) guesses k - 1 tokens per request and
one widened fused VERIFY step scores all k rows in one pass — 2
host/device crossings per accepted run of up to k tokens. Greedy outputs
are token-for-token those of the 1-token path for any draft.

Hybrid stacks (SSD, RG-LRU and sliding-window layers, e.g. mamba2-780m
and recurrentgemma-2b) serve through the same paths: `generate`
prefills through the SSD / RG-LRU scan kernels and keeps one recurrent
slot per sequence and O(window) ring pages, and — as in the reference —
`serve()` / `ServeSession` on such a stack always prefill in chunks,
with no radix cache (a recurrent state is not content-addressable).

Overload control, as in the reference: requests may carry a deadline and
a priority; the scheduler sheds predicted and actual deadline misses,
and when a strictly more urgent request is blocked, `ServeSession` parks
an eligible active row (`preempt`: its KV pages and recurrent state swap
to the pool's host tier) and resumes it bit-identically later, the
victim ranked by a pluggable policy (`serve.preemption`). ``metrics=``
collects per-request queue wait, TTFT, per-token latency and SLO
outcomes (`serve.metrics`).

Mesh serving (``mesh=``, `launch.mesh.make_serve_mesh`): a dp x tp
`serve.sharding.ServePlan` shards the weights (heads and ffn over
"model", the rest replicated), binds every sequence to a data shard
before its first write, pads the decode rows to an equal block per data
shard, and runs the fused step and the prefill per shard with the
reduction seams between model shards; the scheduler admits per shard and
the radix cache keeps one tree per shard. A plan of one shard is the
unsharded engine. Without a page pool, `generate` on a mesh is the
reference's dense-cache path over the plan (`ShardedModel.
forward_prefill_dense`; minicpm3-4b's MLA included).

Greedy decoding is argmax; temperature sampling draws from a
``torch.Generator`` seeded with ``seed``. ``knee_cache`` (a JSON path,
canonically ``api.knee_cache_path(checkpoint_dir)``) persists the launch
shapes ``backend="auto"`` resolves (`kernels.api.resolve_tile`) across
restarts: loaded at construction, saved after each `generate` / `serve`
that resolved a new one. As in the reference, `serve()` and
`ServeSession` need a pool (`ValueError`), a paged MLA or cross-attention
stack raises `NotImplementedError`, and the engine feeds tokens only: a
cross-attention stack (llama-3.2-vision-11b: no image embeddings) fails
in `pad_caches` with `ValueError`, an external-embedding one
(musicgen-medium) in the prefill with `KeyError`.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import api
from repro_torch.models import Model
from repro_torch.models.common import flatten
from repro_torch.models.transformer import check_state, pad_caches
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.paged_decode import (MODES, PagedKVState,
                                            build_fused_step,
                                            extract_prefill_pages,
                                            paged_decode_step, sample)
from repro_torch.serve.paged_state import StateLayout, supports_paged_layout
from repro_torch.serve.preemption import LRUVictimPolicy, RequestView
from repro_torch.serve.prefix_cache import RadixPrefixCache
from repro_torch.serve.scheduler import (Admission, Request, Scheduler,
                                         effective_speculate,
                                         prefix_page_hashes)
from repro_torch.serve.sharding import ServePlan, ShardedModel
from repro_torch.serve.speculative import SpecStats, make_draft
from repro_torch.serve.steps import prefill_all_positions

__all__ = ["Admission", "Request", "ServeEngine", "ServeSession",
           "StreamEvent", "SwapInError"]


class ServeEngine:
    """Engine over one model. ``params`` is a flat state dict (e.g. from
    `repro_torch.convert.params_from_numpy`); without it the weights are
    drawn from ``seed`` on ``device``. ``backend`` picks the kernels'
    implementation (`repro_torch.kernels.api.run`): prefill's flash
    attention and the decode step's paged attention. ``speculate`` is the
    engine's default tokens per step (`Request.speculate` wins); ``draft``
    is ``"ngram[:N]"``, ``"self"`` or any ``propose(history, n)``
    object. ``mesh`` (`launch.mesh.make_serve_mesh`) serves through a
    `ServePlan` over its devices (``device`` is then unused; a mesh of one
    position is the unsharded engine on its device): the config must
    split over its model axis (`ServePlan.check_config`); without
    ``kv_pool`` it generates from dense caches over the plan. Only the
    fused mode runs under a plan: eager and numpy serve unsharded on the
    mesh's first device. ``decode_mode`` None means ``"fused"`` with
    ``device_gather``, else ``"numpy"``."""

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None,
                 seed: int = 0, kv_pool: Optional[PagedKVPool] = None,
                 device="cuda", backend: str = "auto",
                 device_gather: bool = True,
                 decode_mode: Optional[str] = None, knee_cache=None,
                 speculate: int = 0, draft="ngram", mesh=None):
        if decode_mode is None:
            decode_mode = "fused" if device_gather else "numpy"
        if decode_mode not in MODES:
            raise ValueError(f"decode_mode {decode_mode!r} not in {MODES}")
        self.decode_mode = decode_mode
        self.cfg = cfg
        # only the fused step runs under a plan (eager and numpy are the
        # one-device references)
        self.plan = ServePlan.from_mesh(mesh) if decode_mode == "fused" \
            else None
        if self.plan is None:
            # a mesh of one position serves unsharded on its device
            self.device = torch.device(device if mesh is None
                                       else mesh.devices.flat[0])
            self.model = Model(cfg, device=self.device, seed=seed,
                               state=params)
        else:
            self.plan.check_config(cfg)
            self.device = self.plan.device(0, 0)
            if params is None:
                # the weights the unsharded engine draws from `seed` on
                # the controller's device, sharded, then dropped
                full = Model(cfg, device=self.device, seed=seed)
                self.model = ShardedModel(cfg, self.plan, flatten(full.params))
                del full
            else:
                self.model = ShardedModel(cfg, self.plan,
                                          check_state(cfg, params))
        self.kv_pool = kv_pool
        self.backend = backend
        self.knee_cache = knee_cache
        if knee_cache is not None:
            api.load_knee_cache(knee_cache)
        self.layout = StateLayout(cfg, kv_pool.page_tokens) \
            if kv_pool is not None else None
        self.speculate = int(speculate)
        self._draft_arg = draft
        self._draft = None
        self._next_seq = 0           # pool seq ids are engine-lifetime unique
        self._fused_cache: dict = {}
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0,
                      "decode_steps": 0}
        self.last_request_stats: list[dict] = []
        # the last generate()/serve() call's recurrent-store slot traffic
        self.last_rec_store = {"writes": 0, "reads": 0}

    @property
    def draft(self):
        if self._draft is None:
            self._draft = make_draft(self._draft_arg, self.model,
                                     backend=self.backend)
        return self._draft

    @property
    def _hybrid(self) -> bool:
        """True when the stack holds any non-global-attention mixer
        (recurrent slots or ring pages) — served fused-only."""
        return self.layout.has_rec or self.layout.has_ring

    def _require_paged(self):
        if self.kv_pool is None:
            raise ValueError("continuous serving decodes from a page pool — "
                             "construct the engine with kv_pool=")
        if not supports_paged_layout(self.cfg):
            raise NotImplementedError(
                f"{self.cfg.name}: paged serving needs a stack of "
                f"attn/local_attn/ssd/rglru mixers")
        if self._hybrid and self.decode_mode != "fused":
            raise NotImplementedError(
                f"{self.cfg.name}: recurrent/ring layers serve through the "
                f"fused paged step only; decode_mode="
                f"{self.decode_mode!r} stays the global-attention "
                f"reference")

    def _check_spec_width(self, k: int):
        """A k-token verify step needs the page pool, the fused mode (eager
        and numpy stay the one-token references) and k <= page_tokens (one
        step may cross at most one page boundary)."""
        if k <= 1:
            return
        if self.kv_pool is None:
            raise ValueError("speculative decode verifies against the "
                             "page pool — construct the engine with "
                             "kv_pool=")
        if self.decode_mode != "fused":
            raise ValueError(
                f"speculative decode (k={k}) runs over the fused verify "
                f"step; decode_mode={self.decode_mode!r} stays the "
                f"1-token reference")
        t = self.kv_pool.page_tokens
        if k > t:
            raise ValueError(
                f"speculate={k} exceeds page_tokens={t}: one verify "
                f"step may cross at most one page boundary")

    def _resolve_spec(self, requests) -> tuple[int, list[int]]:
        """Effective per-request k (Request.speculate, falling back to the
        engine default) and the verify-step width (their max)."""
        ks = [effective_speculate(r, self.speculate) for r in requests]
        k = max(ks, default=1)
        self._check_spec_width(k)
        return k, ks

    def _new_state(self, capacity: int, batch_hint: int,
                   tail_slots: int = 1) -> PagedKVState:
        cfg = self.cfg
        return PagedKVState(self.kv_pool, capacity, self.layout,
                            cfg.num_kv_heads, cfg.head_dim,
                            mode=self.decode_mode, batch_hint=batch_hint,
                            tail_slots=tail_slots, device=self.device,
                            plan=self.plan)

    def _fused_step_fn(self, slots: int, greedy: bool, temperature: float,
                       k: int = 1):
        key = (slots, greedy, float(temperature), k)
        fn = self._fused_cache.get(key)
        if fn is None:
            fn = build_fused_step(self.model, slots, k=k,
                                  backend=self.backend, greedy=greedy,
                                  temperature=temperature,
                                  layout=self.layout, plan=self.plan)
            self._fused_cache[key] = fn
        return fn

    def _maybe_save_knees(self):
        """Persist the knees resolved since the last save, when the engine
        has a knee cache."""
        if self.knee_cache is not None and api.knees_dirty():
            api.save_knee_cache(self.knee_cache)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _prefill_all(self, toks: np.ndarray, shard: int = 0):
        """All-position logits and caches of one prompt (no padding); under
        a plan on data shard `shard`, the one its sequence is bound to."""
        return prefill_all_positions(
            self.model, torch.from_numpy(toks[None]).to(self.device),
            backend=self.backend, shard=shard)

    def _spec_step(self, state: PagedKVState, step_fn, k: int, rows,
                   generator):
        """One k-row verify step over the current batch rows.

        ``rows``: per batch row, ``None`` (dead/padded) or a dict with
        ``seq`` (pool id), ``history`` (int32 array: prompt + emitted
        tokens, whose last entry is the token this step feeds), ``pos``
        (absolute position of that token), ``eff_k`` (the request's
        tokens per step), ``limit`` (tokens still allowed before max_new,
        >= 1), ``eos`` (stop token or None) and ``stats`` (`SpecStats`).
        Proposes drafts, runs the step, and advances the state by exactly
        the per-row kept counts — the accepted prefix + bonus token,
        clamped by limit/eos; everything else rolls back. Returns the
        per-row kept-token lists.

        A row may instead carry a prefill CHUNK (``{"seq", "pos",
        "chunk", "final"}``): up to k true prompt tokens fed through the
        same step, always kept. Columns past the chunk repeat its last
        token (their K/V rows are phantom). A ``final`` chunk keeps one
        token — the sample after the last prompt token, the request's
        first generated token; earlier chunks keep nothing.

        On a recurrent stack each row also names the state checkpoint the
        step commits: a chunk row exactly its chunk length, a verify row
        ``min(accepted, proposed) + 1`` (pad drafts never advance the
        state)."""
        b = len(rows)
        toks = np.zeros((b, k), np.int32)
        seq_ids = [-1] * b
        pos = np.zeros(b, np.int32)
        proposed = [0] * b
        keep_fixed = np.ones(b, np.int32)
        keep_cap = np.zeros(b, np.int32)
        for i, r in enumerate(rows):
            if r is None:
                continue
            seq_ids[i] = r["seq"]
            pos[i] = r["pos"]
            chunk = r.get("chunk")
            if chunk is not None:
                m = len(chunk)
                toks[i, :m] = chunk
                keep_fixed[i] = m
                if m < k:               # pad: repeat the last true token
                    toks[i, m:] = chunk[-1]
                continue
            hist = r["history"]
            toks[i, 0] = hist[-1]
            n_d = min(r["eff_k"], k) - 1
            if n_d > 0:
                drafts = np.asarray(self.draft.propose(hist, n_d), np.int32)
                proposed[i] = len(drafts)
                toks[i, 1:1 + len(drafts)] = drafts
            if proposed[i] < k - 1:     # pad: repeat the last filled token
                toks[i, 1 + proposed[i]:] = toks[i, proposed[i]]
            keep_fixed[i] = -1
            keep_cap[i] = proposed[i]
        verdict = state.run_spec(step_fn, toks, seq_ids, pos, generator,
                                 keep_fixed=keep_fixed, keep_cap=keep_cap)
        kept = [None] * b
        advanced = [0] * b
        for i, r in enumerate(rows):
            if r is None:
                continue
            chunk = r.get("chunk")
            if chunk is not None:
                m = len(chunk)
                kept[i] = [int(verdict[i, m - 1])] if r["final"] else []
                advanced[i] = m
                continue
            # padding columns never count as accepted (a non-speculative
            # row always keeps exactly its 1 bonus token)
            n_acc = min(int(verdict[i, k]), proposed[i])
            cand = [int(x) for x in verdict[i, :n_acc + 1][:r["limit"]]]
            eos = r["eos"]
            if eos is not None and eos in cand:
                cand = cand[:cand.index(eos) + 1]
            kept[i] = cand
            advanced[i] = len(cand)
            st = r.get("stats")
            if st is not None:
                st.steps += 1
                st.proposed += proposed[i]
                st.accepted += min(len(cand), n_acc)
                st.tokens += len(cand)
        state.end_step(seq_ids, advanced)
        return kept

    # ------------------------------------------------------------------
    # Static lockstep batch
    # ------------------------------------------------------------------
    def generate(self, requests: list[Request], greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 free_pages: bool = False) -> list[np.ndarray]:
        """Static lockstep decode. Per-request ``eos_token`` truncates the
        returned tokens (eos inclusive); the lockstep batch still decodes
        ``max_new_tokens`` steps (speculative rows advance at their own
        accept rates). The batch's pages stay live after the call unless
        ``free_pages=True``. Deadlines and priorities play no part in a
        static batch (as in the reference). An engine without a pool
        decodes from dense caches (`_generate_dense`)."""
        spec_k, eff_ks = self._resolve_spec(requests)
        b = len(requests)
        plen = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        prompts = np.zeros((b, plen), np.int32)
        for i, r in enumerate(requests):
            prompts[i, plen - len(r.prompt):] = r.prompt   # left-pad
        if self.kv_pool is None:
            outs = self._generate_dense(prompts, max_new, greedy,
                                        temperature, seed)
            self._maybe_save_knees()
            return self._finish_generate(outs, requests, [SpecStats()
                                                          for _ in requests],
                                         max_new)
        self._require_paged()

        plan = self.plan
        # a plan decodes n_rows >= b rows so that every data shard gets an
        # equal block; the extra rows are seq -1 padding (trash slots)
        n_rows = plan.pad_rows(b) if plan is not None else b
        t0 = time.perf_counter()
        tokens = torch.from_numpy(prompts).to(self.device)
        if plan is None:
            logits, caches = self.model.forward_prefill(
                tokens, backend=self.backend)
        else:
            # each row prefills on the data shard that decodes it
            logits, caches = self.model.forward_prefill(
                tokens, backend=self.backend,
                row_shards=[plan.shard_of_row(i, n_rows) for i in range(b)])
        seq_ids = list(range(self._next_seq, self._next_seq + b))
        self._next_seq += b
        state = self._new_state(plen + max_new, batch_hint=n_rows,
                                tail_slots=2 if spec_k > 1 else 1)
        if plan is not None:
            # bind each sequence to its row's data shard BEFORE any
            # prefill write, so its pages land where it decodes
            for i, seq in enumerate(seq_ids):
                state.bind_seq(seq, plan.shard_of_row(i, n_rows))
        extract_prefill_pages(self.model, caches, state, seq_ids)
        self.stats["prefill_s"] += time.perf_counter() - t0

        gen = self._generator(seed)
        tok = sample(logits, greedy, temperature, gen)
        outs = [[int(x)] for x in tok.cpu().numpy()]
        observe = getattr(self.kv_pool.policy, "observe", None)
        spec_stats = [SpecStats() for _ in requests]
        t0 = time.perf_counter()
        if spec_k > 1:
            self._generate_spec(requests, eff_ks, spec_k, state, seq_ids,
                                outs, spec_stats, plen, greedy, temperature,
                                gen, observe)
        else:
            fused = self.decode_mode == "fused"
            step_fn = self._fused_step_fn(state.slots, greedy, temperature) \
                if fused else None
            step_seqs = seq_ids + [-1] * (n_rows - b)
            if n_rows > b:       # device-side pad: no extra upload
                tok = torch.cat([tok, tok.new_zeros(n_rows - b)])
            for step in range(max_new - 1):
                hits0 = (self.kv_pool.stats["fast_hits"],
                         self.kv_pool.stats["slow_hits"])
                g0 = state.gather_s
                if fused:
                    # steady state: one control upload, one token
                    # download — `tok` stays on the device
                    tok_host, tok = state.run_fused(step_fn, tok, step_seqs,
                                                    plen + step, gen)
                else:
                    logits = paged_decode_step(
                        self.model, tok.cpu().numpy(), state, seq_ids,
                        plen + step, backend=self.backend)
                    tok = sample(logits, greedy, temperature, gen)
                    tok_host = tok.cpu().numpy()
                if observe is not None:
                    observe(state.gather_s - g0,
                            self.kv_pool.stats["fast_hits"] - hits0[0],
                            self.kv_pool.stats["slow_hits"] - hits0[1])
                for i in range(b):
                    outs[i].append(int(tok_host[i]))
                self.stats["decode_steps"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        self.last_transfers = state.transfer_counts()
        self.last_rec_store = state.rec_store_counts()
        if free_pages:
            for seq in seq_ids:
                state.free_seq(seq)
        self._maybe_save_knees()
        return self._finish_generate(outs, requests, spec_stats, max_new)

    def _generate_dense(self, prompts: np.ndarray, max_new: int,
                        greedy: bool, temperature: float, seed: int):
        """The reference's dense-cache lockstep decode: prefill, pad every
        layer's cache to ``plen + max_new`` rows, then ``max_new - 1``
        `Model.forward_decode` steps at the position the batch shares.
        Returns each row's tokens (untrimmed)."""
        plen = prompts.shape[1]
        t0 = time.perf_counter()
        tokens = torch.from_numpy(prompts).to(self.device)
        if self.plan is None:
            logits, caches = self.model.forward_prefill(
                tokens, backend=self.backend)
            caches = pad_caches(caches, plen + max_new, self.cfg)
            decode = self.model.forward_decode
        else:
            # over a plan: rows over the data shards, each model shard its
            # own caches (`ShardedModel.forward_prefill_dense`)
            logits, caches = self.model.forward_prefill_dense(
                tokens, plen + max_new, backend=self.backend)
            decode = self.model.forward_decode_dense
        self.stats["prefill_s"] += time.perf_counter() - t0
        gen = self._generator(seed)
        tok = sample(logits, greedy, temperature, gen)
        outs = [[int(x)] for x in tok.cpu().numpy()]
        t0 = time.perf_counter()
        for step in range(max_new - 1):
            logits = decode(tok[:, None], caches, plen + step)
            tok = sample(logits, greedy, temperature, gen)
            for i, x in enumerate(tok.cpu().numpy()):
                outs[i].append(int(x))
            self.stats["decode_steps"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        self.last_rec_store = {"writes": 0, "reads": 0}
        return outs

    def _finish_generate(self, outs, requests, spec_stats, max_new):
        """Trim each row to its request's ``max_new_tokens`` and eos, and
        record ``stats["tokens"]`` and ``last_request_stats``."""
        def trim(o, r):
            o = o[:r.max_new_tokens]
            if r.eos_token is not None and r.eos_token in o:
                o = o[:o.index(r.eos_token) + 1]   # eos inclusive, as serve
            return np.array(o)

        results = [trim(o, r) for o, r in zip(outs, requests)]
        self.stats["tokens"] += sum(len(o) for o in results)
        self.last_request_stats = []
        for res, st in zip(results, spec_stats):
            if st.steps == 0:               # non-speculative lockstep rows
                st.steps = max(1, max_new - 1)
                st.tokens = max(0, len(res) - 1)
            d = st.as_dict()
            d["tokens"] = len(res)          # eos-trimmed, prefill token incl.
            self.last_request_stats.append(d)
        return results

    def _generate_spec(self, requests, eff_ks, spec_k, state, seq_ids,
                       outs, spec_stats, plen, greedy, temperature, gen,
                       observe):
        """Static-batch speculative loop: rows advance at their own accept
        rates, finished rows turn into seq -1 padding until every row has
        reached its max_new/eos."""
        step_fn = self._fused_step_fn(state.slots, greedy, temperature,
                                      k=spec_k)
        hist = [np.concatenate([np.asarray(r.prompt, np.int32),
                                np.asarray(o, np.int32)])
                for r, o in zip(requests, outs)]

        def is_done(i):
            r = requests[i]
            return (len(outs[i]) >= r.max_new_tokens
                    or (r.eos_token is not None
                        and outs[i][-1] == r.eos_token))

        done = [is_done(i) for i in range(len(requests))]
        while not all(done):
            rows = []
            for i, r in enumerate(requests):
                if done[i]:
                    rows.append(None)
                    continue
                rows.append({"seq": seq_ids[i], "history": hist[i],
                             "pos": plen + len(outs[i]) - 1,
                             "eff_k": eff_ks[i],
                             "limit": r.max_new_tokens - len(outs[i]),
                             "eos": r.eos_token, "stats": spec_stats[i]})
            # a plan's padding rows (seq -1) up to the equal-block count
            rows.extend([None] * (state.batch_hint - len(rows)))
            hits0 = (self.kv_pool.stats["fast_hits"],
                     self.kv_pool.stats["slow_hits"])
            g0 = state.gather_s
            kept = self._spec_step(state, step_fn, spec_k, rows, gen)
            self.stats["decode_steps"] += 1
            if observe is not None:
                observe(state.gather_s - g0,
                        self.kv_pool.stats["fast_hits"] - hits0[0],
                        self.kv_pool.stats["slow_hits"] - hits0[1])
            for i in range(len(requests)):
                if rows[i] is None:
                    continue
                outs[i].extend(kept[i])
                hist[i] = np.concatenate(
                    [hist[i], np.asarray(kept[i], np.int32)])
                done[i] = is_done(i)

    # ------------------------------------------------------------------
    # Continuous batching
    # ------------------------------------------------------------------
    def serve(self, requests: list[Request], max_active: int = 4,
              greedy: bool = True, temperature: float = 1.0, seed: int = 0,
              prefix_cache: bool = True, metrics=None,
              chunked_prefill: Optional[bool] = None,
              prefill_budget: int = 1,
              radix: Optional[bool] = None,
              preempt: bool = True,
              preempt_policy=None) -> list[Optional[np.ndarray]]:
        """Continuous-batching decode: requests join free rows mid-flight
        and retire at their own lengths; finished requests' pages are
        freed. Returns outputs in submission order; a request that can
        never fit, or is shed for its deadline, is rejected (its slot is
        None, its `Admission` verdict in ``last_rejections``, its
        ``last_request_stats`` entry carries ``rejected=<reason>``).
        ``chunked_prefill`` and ``radix`` default on, as in the reference;
        ``preempt`` (default on) lets a strictly more urgent request park
        an active one on the host tier, ranked by ``preempt_policy``;
        ``metrics`` takes a `serve.metrics.MetricsRegistry` (see
        `ServeSession`)."""
        if not requests:
            self.last_rejections = []
            return []
        self._require_paged()
        spec_k, _ = self._resolve_spec(requests)
        if len({id(r) for r in requests}) != len(requests):
            raise ValueError("duplicate Request objects in one serve() call")
        cap = max(len(r.prompt) + r.max_new_tokens for r in requests)
        session = ServeSession(self, capacity=cap, max_active=max_active,
                               speculate=spec_k, greedy=greedy,
                               temperature=temperature, seed=seed,
                               prefix_cache=prefix_cache, metrics=metrics,
                               chunked_prefill=chunked_prefill,
                               prefill_budget=prefill_budget, radix=radix,
                               preempt=preempt,
                               preempt_policy=preempt_policy)
        self.last_rejections = []
        for r in requests:
            verdict = session.submit(r)
            self.last_rejections.append(None if verdict else verdict)
        while not session.done:
            session.step()
        self.last_peak_active = session.sched.peak_active
        self.last_transfers = session.state.transfer_counts()
        self.last_rec_store = session.state.rec_store_counts()
        self.last_steady_transfers = list(session.steady_transfers)
        self.last_prefix_hit_rate = session.prefix_hit_rate
        self.last_request_stats = [session.request_stats(r)
                                   for r in requests]
        session.close()    # drop radix pins: the pool tracks live work
        self._maybe_save_knees()
        return [session.result(r) for r in requests]


# ---------------------------------------------------------------------------
# Step-granular continuous batching
# ---------------------------------------------------------------------------
class _Active:
    """One occupied decode row of the continuous batch. A chunked-prefill
    row starts with ``pending`` prompt tokens still to stream into the
    pool (``prefilled`` counts tokens already resident, adopted prefix
    included) and an empty ``outs``; it joins decode once its final
    chunk produces its first token."""

    __slots__ = ("req", "seq", "plen", "outs", "eff_k", "stats", "pending",
                 "prefilled", "hashes")

    def __init__(self, req: Request, seq: int, plen: int, eff_k: int = 1):
        self.req, self.seq, self.plen = req, seq, plen
        self.outs: list[int] = []
        self.eff_k = eff_k
        self.stats = SpecStats()
        self.pending: Optional[np.ndarray] = None
        self.prefilled = 0
        self.hashes: Optional[list] = None

    @property
    def pos(self) -> int:
        """Absolute position of the token being fed this step."""
        return self.plen + len(self.outs) - 1

    @property
    def prefilling(self) -> bool:
        return self.pending is not None and len(self.pending) > 0

    @property
    def finished(self) -> bool:
        if not self.outs:               # still prefilling: no token yet
            return False
        return (len(self.outs) >= self.req.max_new_tokens
                or self.outs[-1] == self.req.eos_token)


class SwapInError(RuntimeError):
    """A parked sequence's host pages could not be restored to the device
    (injected via ``REPRO_SERVE_FAULT=swap_fail:p`` for testing). The
    session converts it into a structured per-request error event — the
    victim's pages free, the rest of the batch is untouched."""


class StreamEvent:
    """Per-request outcome of one `ServeSession.step`: the tokens the
    request emitted this step (the admission prefill token included) and
    whether it just finished. The streamed tokens are already eos/max_new
    clamped — concatenating a request's events reproduces its final
    output exactly. ``error`` names a late rejection or a structured
    mid-flight failure (e.g. ``"swap_fail"``) on a terminal event; the
    tokens streamed before it stand as the partial result."""

    __slots__ = ("request", "tokens", "done", "error")

    def __init__(self, request: Request, tokens: list, done: bool = False,
                 error: Optional[str] = None):
        self.request, self.tokens, self.done = request, tokens, done
        self.error = error


class _SessionRec:
    """One request's lifecycle record inside a `ServeSession`."""

    __slots__ = ("req", "status", "admission", "active", "row", "result",
                 "stats", "metrics")

    def __init__(self, req: Request, admission: Admission, metrics):
        self.req = req
        self.admission = admission
        self.metrics = metrics
        # waiting|active|preempted|done|cancelled|rejected|error
        self.status = "waiting"
        self.active: Optional[_Active] = None
        self.row = -1
        self.result: Optional[np.ndarray] = None
        self.stats: Optional[dict] = None


class ServeSession:
    """Resumable, step-granular continuous-batching loop: ``submit``
    queues a request and returns its `Admission` verdict, ``step`` runs
    one admission round plus one fused step over the live rows and
    returns per-request `StreamEvent`s, ``cancel`` retires a request.
    ``capacity`` (in tokens) sizes the page table for the session's
    lifetime — a longer request is rejected with reason ``capacity``.
    ``speculate`` fixes the verify-step width; a request whose k exceeds
    it is rejected with reason ``speculate``.

    ``chunked_prefill`` (default on) streams prompts in page-sized chunks
    through the widened verify step — up to ``prefill_budget`` chunk rows
    per step — while decode rows keep decoding in the same step; off, a
    prompt prefills in one pass at admission. ``radix`` (default: as
    ``prefix_cache``) keeps a `RadixPrefixCache` that pins finished
    prompts' pages so later requests adopt the cached prefix instead of
    prefilling it. A hybrid stack (recurrent or ring layers) always
    prefills in chunks, with no radix cache and no prefix hashing, as in
    the reference: ``chunked_prefill=False`` raises `ValueError`. Chunked
    prefill rides the fused step: an eager or numpy engine's session
    prefills each prompt in one pass at admission (``chunked_prefill=
    True`` raises `ValueError`) and decodes through
    `paged_decode.paged_decode_step`.

    Overload: requests may carry a ``deadline`` and a ``priority``. When
    an admission round leaves a strictly more urgent head blocked and
    ``preempt`` is on (the default), the session parks an eligible active
    row — the scheduler's deterministic eligibility, ``preempt_policy``
    (default `LRUVictimPolicy`) ranking the candidates — by swapping its
    KV pages, tail rows and recurrent state to the pool's host tier
    (`preempt`), and resumes it at a later admission round (or `resume`)
    bit-identically. ``metrics`` (a `serve.metrics.MetricsRegistry`)
    collects queue wait, TTFT, per-token latency, preempt/resume spans
    and SLO outcomes per request. The reference's test hooks hold here:
    ``REPRO_SERVE_FAULT=swap_fail:p`` fails a resume's swap-in with
    probability p (the victim ends as a structured ``swap_fail`` error
    event, the batch decodes on) and ``REPRO_SERVE_DEBUG`` checks the
    pool invariants after every step.

    ``steady_transfers`` lists the (host->device, device->host) transfers
    of every step that fed its tokens back on the device and neither
    synced nor read back a page: the steady state, one control upload and
    one token download. A swap marks the rows dirty, so the step after it
    is not a steady one; swap traffic itself is counted in the pool's
    ``swap_out_bytes`` / ``swap_in_bytes`` stats."""

    def __init__(self, engine: ServeEngine, capacity: int,
                 max_active: int = 4, speculate: Optional[int] = None,
                 greedy: bool = True, temperature: float = 1.0,
                 seed: int = 0, prefix_cache: bool = True, metrics=None,
                 chunked_prefill: Optional[bool] = None,
                 prefill_budget: int = 1, radix: Optional[bool] = None,
                 preempt: bool = True, preempt_policy=None):
        engine._require_paged()
        k = max(1, engine.speculate if speculate is None else int(speculate))
        engine._check_spec_width(k)
        self.engine = engine
        self.pool = engine.kv_pool
        self.capacity = int(capacity)
        self.spec_k = k
        self.max_active = max_active
        self.greedy, self.temperature = greedy, float(temperature)
        self.metrics = metrics
        fused = engine.decode_mode == "fused"
        if chunked_prefill and not fused:
            raise ValueError(
                f"chunked prefill rides the fused verify step; "
                f"decode_mode={engine.decode_mode!r} stays monolithic")
        hybrid = engine._hybrid
        if hybrid and chunked_prefill is not None and not chunked_prefill:
            # the monolithic prefill of a session cannot hand a recurrent
            # state over — hybrid stacks stream their prompts in chunks
            raise ValueError(
                f"{engine.cfg.name}: recurrent/ring stacks prefill through "
                f"chunked prefill only; drop chunked_prefill=False")
        self.chunked = fused if chunked_prefill is None \
            else bool(chunked_prefill)
        self.prefill_budget = max(1, int(prefill_budget))
        # a recurrent state is not content-addressable: no radix adoption
        self.radix = False if hybrid else \
            (bool(prefix_cache) if radix is None else bool(radix))
        self.prefix_cache = False if hybrid else prefix_cache
        plan = engine.plan
        # under a plan the decode batch carries an equal block of rows per
        # data shard; admission fills rows (and page budget) per shard, so
        # the rows round max_active up to a multiple of dp
        n_rows = plan.pad_rows(max_active) if plan is not None \
            else max_active
        dp = plan.dp if plan is not None else 1
        self.prefix_index = RadixPrefixCache(
            self.pool, engine.layout.n_kv, on_release=self._release_pinned,
            shards=dp) if self.radix else None
        self.sched = Scheduler(self.pool, engine.layout,
                               max_active=max_active,
                               default_speculate=engine.speculate,
                               prefix_index=self.prefix_index,
                               data_shards=dp, rows_per_shard=n_rows // dp)
        # a chunk-fill step uses the spill slot (decode rows riding a wide
        # step may cross their page boundary), so chunked sessions need the
        # second tail slot even at k == 1
        self.state = engine._new_state(
            self.capacity, batch_hint=n_rows,
            tail_slots=2 if (k > 1 or self.chunked) else 1)
        # prefix-cache hit accounting (pages adopted / adoptable pages)
        # and the per-token wall time of decode work that shared a step
        # with a prefill chunk ("decode p99 during admission")
        self.pages_adopted_total = 0
        self.pages_needed_total = 0
        self.prefill_step_decode_ms: list[float] = []
        self._rows: list[Optional[_Active]] = [None] * n_rows
        self._recs: dict[int, _SessionRec] = {}
        self._gen = engine._generator(seed)
        self._observe = getattr(self.pool.policy, "observe", None)
        self._fused = fused
        self._step_fn = engine._fused_step_fn(self.state.slots, greedy,
                                              temperature, k=k) \
            if fused else None
        self._tok_dev = None      # device-resident (n_rows,) last tokens
        self._rows_dirty = True   # host-known token entered/left a row
        self.steps = 0
        self.chunk_steps = 0      # steps that carried a prompt chunk
        self.peak_live_pages = 0
        self.steady_transfers: list[tuple[int, int]] = []
        # SLO-aware preemption: when the admission round leaves a
        # strictly-more-urgent head blocked, park an eligible active row
        # (swap its state to the host tier) to free a seat. Eligibility
        # is the scheduler's deterministic rule; the policy only ranks.
        self.preempt_enabled = bool(preempt)
        self.preempt_policy = preempt_policy if preempt_policy is not None \
            else LRUVictimPolicy()
        # per-step reward feedback of a learned policy: a no-op for LRU
        self._preempt_observe = getattr(self.preempt_policy, "observe",
                                        None)
        self.preemptions = 0      # rows parked to the host tier
        self.resumes = 0          # parked rows re-placed
        self._step_misses = 0     # deadline misses since last policy reward
        self._pending_events: list[StreamEvent] = []
        # fault injection (tests): REPRO_SERVE_FAULT=swap_fail:p makes a
        # resume's swap-in fail with probability p — the victim surfaces
        # a structured error event, the batch keeps decoding
        self._fault: Optional[tuple[str, float]] = None
        fault = os.environ.get("REPRO_SERVE_FAULT")
        if fault:
            kind, _, p = fault.partition(":")
            self._fault = (kind, float(p) if p else 1.0)
        self._fault_rng = np.random.default_rng(seed ^ 0x5EED)
        self._debug = bool(os.environ.get("REPRO_SERVE_DEBUG"))

    # -- lifecycle ----------------------------------------------------------
    @property
    def done(self) -> bool:
        """True when nothing is waiting and no decode row is occupied."""
        return self.sched.done

    @property
    def queue_depth(self) -> int:
        return len(self.sched.waiting)

    @property
    def n_active(self) -> int:
        return sum(a is not None for a in self._rows)

    def submit(self, req: Request) -> Admission:
        """Queue a request (in urgency order). Returns the structured
        admission verdict; on rejection the request is fully accounted
        (result ``None``, stats carry the reason) but never does work."""
        if id(req) in self._recs:
            raise ValueError("Request object already submitted to this "
                             "session")
        t = self.pool.page_tokens
        tail = 2 if (self.spec_k > 1 or self.chunked) else 1
        need_tokens = len(req.prompt) + req.max_new_tokens
        lay = self.engine.layout
        pages = -(-need_tokens // t)
        if lay.has_ring:                # ring layers recycle: O(window)
            pages = min(pages, lay.ring_pages())
        eff_k = effective_speculate(req, self.engine.speculate)
        if lay.n_kv and pages + tail > self.state.slots:
            verdict = Admission(
                False, reason="capacity",
                pages_needed=self.engine.layout.pages_needed(
                    need_tokens, tail_slots=tail),
                pages_budget=self.sched._budget(),
                detail=f"request spans {need_tokens} KV tokens = {pages} "
                       f"pages + {tail} tail slot(s), beyond the session "
                       f"page table of {self.state.slots} slots "
                       f"({self.state.slots * t} tokens); raise the "
                       f"session capacity")
        elif eff_k > self.spec_k:
            verdict = Admission(
                False, reason="speculate",
                detail=f"request speculates {eff_k} tokens/step but the "
                       f"session verify graph is {self.spec_k} wide")
        else:
            verdict = self.sched.submit(req)
        m = self.metrics.submit() if self.metrics is not None else None
        if m is not None:
            m.deadline_s = req.deadline
        rec = _SessionRec(req, verdict, m)
        self._recs[id(req)] = rec
        if not verdict:
            rec.status = "rejected"
            rec.stats = {"rejected": verdict.reason, "tokens": 0,
                         **verdict.as_dict()}
            if m is not None:
                m.on_reject(verdict.reason)
        return verdict

    def cancel(self, req: Request) -> bool:
        """Cancel a submitted request: a waiting one leaves the queue; an
        active one retires — its row and reservation free immediately and
        its pool pages drop their refs (prefix-shared and pinned pages
        survive through their other holders); a parked one frees its
        host-tier pages and parked tail. The tokens streamed so far
        become its partial result. Returns False if it already finished
        or was never submitted."""
        rec = self._recs.get(id(req))
        if rec is None or rec.status in ("done", "cancelled", "rejected",
                                         "error"):
            return False
        outs: list = []
        stats = SpecStats()
        if rec.status == "waiting":
            self.sched.remove_waiting(req)
        elif rec.status == "preempted":
            # a swapped-out sequence: it sits in the waiting queue
            # (parked) and holds no row — free its host-tier pages and
            # parked tail, drop the scheduler's parked bookkeeping
            act = rec.active
            outs, stats = act.outs, act.stats
            self.sched.remove_waiting(req)
            self.state.free_seq(act.seq)
        else:
            act = rec.active
            outs, stats = act.outs, act.stats
            self.state.free_seq(act.seq)
            self._rows[rec.row] = None
            self.sched.retire(req)
            self._rows_dirty = True
        rec.status = "cancelled"
        rec.active = None
        rec.result = np.array(outs[:req.max_new_tokens], np.int64)
        d = stats.as_dict()
        d["tokens"] = len(rec.result)
        d["cancelled"] = True
        rec.stats = d
        if rec.metrics is not None:
            rec.metrics.on_cancel()
        return True

    def result(self, req: Request) -> Optional[np.ndarray]:
        """Final (or partial, if cancelled) output tokens; None while the
        request is queued or decoding, and None forever if rejected."""
        rec = self._recs.get(id(req))
        return None if rec is None else rec.result

    def request_stats(self, req: Request) -> Optional[dict]:
        rec = self._recs.get(id(req))
        return None if rec is None else rec.stats

    def admission(self, req: Request) -> Optional[Admission]:
        rec = self._recs.get(id(req))
        return None if rec is None else rec.admission

    def transfer_counts(self) -> tuple[int, int]:
        return self.state.transfer_counts()

    def _release_pinned(self, pid: int):
        # a radix-tree unpin destroyed a pool page: recycle its device slot
        self.state.release_page(pid)

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        """Pages adopted / adoptable prompt pages across the session's
        admissions; None before any admission counted one."""
        if self.pages_needed_total == 0:
            return None
        return self.pages_adopted_total / self.pages_needed_total

    def close(self):
        """Release the session's cross-request state: unpin every radix
        tree node (pages whose last holder was the tree are destroyed and
        their device slots recycled), so a drained, closed session leaves
        ``pool.live_pages == 0``."""
        if self.prefix_index is not None:
            self.prefix_index.clear()

    def check_invariants(self):
        """The pool's and the device mirror's structural invariants, with
        the radix tree's pins as the pool's external references."""
        pins = self.prefix_index.pin_counts() \
            if self.prefix_index is not None else None
        self.pool.check_invariants(pins=pins)
        if self.state._device is not None:
            self.state._device.check_invariants()
        if self.state._rec is not None:
            self.state._rec.check_invariants()

    # -- the step -----------------------------------------------------------
    def _finish(self, rec: _SessionRec):
        act = rec.active
        if rec.req.deadline is not None and self.sched.overdue(rec.req):
            # finished past its SLO: feeds the preemption policy's
            # per-step miss penalty (a learned victim ranking)
            self._step_misses += 1
        self.state.free_seq(act.seq)
        self._rows[rec.row] = None
        self.sched.retire(rec.req)
        rec.status = "done"
        rec.active = None
        rec.result = np.array(act.outs[:rec.req.max_new_tokens], np.int64)
        d = act.stats.as_dict()
        d["tokens"] = len(rec.result)   # eos-trimmed, prefill token incl.
        rec.stats = d
        if rec.metrics is not None:
            rec.metrics.on_finish(len(rec.result),
                                  accept_rate=d.get("accept_rate"))

    # -- preemption / resume ------------------------------------------------
    def preempt(self, req: Request) -> bool:
        """Park an active request: its KV pages swap to the host tier,
        its row and reservation free for more urgent work, and it
        re-enters the waiting queue at its urgency position. Resuming
        (automatic at a later admission round, or explicit via `resume`)
        restores its state bit-identically, so its greedy output is
        token-for-token what the never-preempted run produces. Returns
        False unless the request is currently active."""
        rec = self._recs.get(id(req))
        if rec is None or rec.status != "active":
            return False
        self._preempt_rec(rec)
        return True

    def resume(self, req: Request) -> bool:
        """Explicitly un-park a preempted request now (the admission loop
        also resumes parked requests by urgency order on its own).
        Returns False if it is not parked or no row / page headroom is
        free yet."""
        rec = self._recs.get(id(req))
        if rec is None or rec.status != "preempted":
            return False
        if not self.sched.try_resume(req):
            return False
        return self._place_resumed(rec, self._pending_events)

    def _preempt_rec(self, rec: _SessionRec):
        act = rec.active
        self.state.swap_out(act.seq)
        self._rows[rec.row] = None
        rec.row = -1
        rec.status = "preempted"
        self.sched.preempt(rec.req)
        self._rows_dirty = True
        self.preemptions += 1
        if rec.metrics is not None:
            rec.metrics.on_preempt()

    def _place_resumed(self, rec: _SessionRec, events: list) -> bool:
        """Give a just-re-reserved parked request a decode row back and
        swap its state in. A failed swap-in (fault injection) surfaces as
        a structured terminal error event: the scheduler reservation and
        every page the victim held free, nothing else in the batch is
        touched."""
        req, act = rec.req, rec.active
        row_i = self._free_row(self.sched.assigned_shard(req))
        try:
            if self._fault is not None and self._fault[0] == "swap_fail" \
                    and self._fault_rng.random() < self._fault[1]:
                # fires BEFORE any state changes: the sequence is still
                # cleanly parked, so free_seq below releases exactly its
                # host pages + parked tail
                raise SwapInError(
                    f"injected swap-in fault for seq {act.seq}")
            self.state.swap_in(act.seq)
        except SwapInError as e:
            self.sched.retire(req)
            self.state.free_seq(act.seq)
            rec.status = "error"
            rec.active = None
            rec.result = np.array(act.outs[:req.max_new_tokens], np.int64)
            d = act.stats.as_dict()
            d["tokens"] = len(rec.result)
            d["error"] = "swap_fail"
            d["detail"] = str(e)
            rec.stats = d
            if rec.metrics is not None:
                rec.metrics.on_error("swap_fail")
            events.append(StreamEvent(req, [], done=True,
                                      error="swap_fail"))
            return False
        self._rows[row_i] = act
        rec.row = row_i
        rec.status = "active"
        self._rows_dirty = True
        self.resumes += 1
        if rec.metrics is not None:
            rec.metrics.on_resume()
        return True

    def _free_row(self, shard: int) -> int:
        """A free decode row in `shard`'s block of rows."""
        rps = len(self._rows) // self.sched.data_shards
        return next(i for i in range(shard * rps, (shard + 1) * rps)
                    if self._rows[i] is None)

    def _maybe_preempt(self) -> bool:
        """One preemption pass after a blocked admission round: if the
        waiting head strictly outranks some active row (the scheduler's
        deterministic eligibility), ask the policy which eligible victim
        to park and park it. Returns True when a row was freed (the
        caller re-runs admission). Candidates shrink every pass, so the
        admit/preempt loop terminates."""
        if not self.preempt_enabled:
            return False
        sched = self.sched
        head = sched.head_blocked()
        if head is None:
            return False
        # a parked head resumes only on its own shard: victims on other
        # shards free nothing it can use
        need_shard = sched.assigned_shard(head) if sched.is_parked(head) \
            else None
        cands = [rec for rec in self._recs.values()
                 if rec.status == "active" and sched.preempts(head, rec.req)
                 and (need_shard is None
                      or sched.assigned_shard(rec.req) == need_shard)]
        if not cands:
            return False
        now = sched._clock()

        def slack(r):
            if r.deadline is None:
                return None
            sub = sched._submit_s.get(id(r))
            return None if sub is None else sub + r.deadline - now

        views = []
        for rec in cands:
            act = rec.active
            views.append(RequestView(
                priority=rec.req.priority,
                deadline_slack_s=slack(rec.req),
                tokens_done=len(act.outs),
                tokens_left=rec.req.max_new_tokens - len(act.outs),
                prefilling=act.prefilling,
                pages=len(self.pool.seq_pages(act.seq)),
                admit_seq=sched._order.get(id(rec.req), 0)))
        head_view = RequestView(
            priority=head.priority, deadline_slack_s=slack(head),
            tokens_left=head.max_new_tokens,
            queue_depth=len(sched.waiting))
        pick = self.preempt_policy.pick(head_view, views)
        if pick is None:
            return False
        self._preempt_rec(cands[pick])
        return True

    def _reject_late(self, events: list):
        """Surface the scheduler's late rejections: a queue head that can
        never fit even after full pin eviction, a head whose deadline
        expired while it waited, or a parked request no batch can
        re-host. A never-admitted request is accounted like a
        submit-time rejection; a shed *parked* one already did work — its
        swapped state frees and it terminates as a structured error with
        its partial result."""
        for req, verdict in self.sched.late_rejections:
            rec = self._recs[id(req)]
            rec.admission = verdict
            if rec.active is not None:       # shed while parked
                act = rec.active
                self.state.free_seq(act.seq)
                rec.status = "error"
                rec.active = None
                rec.result = np.array(act.outs[:req.max_new_tokens],
                                      np.int64)
                d = act.stats.as_dict()
                d["tokens"] = len(rec.result)
                d["error"] = verdict.reason
                d.update(verdict.as_dict())
                rec.stats = d
                if rec.metrics is not None:
                    rec.metrics.on_error(verdict.reason)
                events.append(StreamEvent(req, [], done=True,
                                          error=verdict.reason))
                continue
            rec.status = "rejected"
            rec.stats = {"rejected": verdict.reason, "tokens": 0,
                         **verdict.as_dict()}
            if rec.metrics is not None:
                rec.metrics.on_reject(verdict.reason)
            events.append(StreamEvent(req, [], done=True,
                                      error=verdict.reason))
        self.sched.late_rejections.clear()

    def _admit(self, events: list):
        eng = self.engine
        t = self.pool.page_tokens
        while True:
            # loop: an admitted request finishing at its very first token
            # frees its row + reservation, unblocking the queue head
            # again; a blocked round may park an eligible active row
            # (preemption) and retry
            batch = self.sched.admit()
            self._reject_late(events)
            if not batch:
                if self._maybe_preempt():
                    continue
                return
            for req in batch:
                rec = self._recs[id(req)]
                if rec.status == "preempted":
                    # a parked request the scheduler just re-reserved:
                    # swap its state back in and rejoin mid-decode
                    self._place_resumed(rec, events)
                    continue
                seq = eng._next_seq
                eng._next_seq += 1
                # the scheduler picked the request's data shard: take a row
                # in its block and bind the sequence before any write, so
                # its pages land on the shard that decodes it
                shard = self.sched.assigned_shard(req)
                row_i = self._free_row(shard)
                self.state.bind_seq(seq, shard)
                toks = np.asarray(req.prompt, np.int32)
                plen = len(toks)
                act = _Active(req, seq, plen,
                              eff_k=effective_speculate(req, eng.speculate))
                if self.chunked:
                    # adopt the radix-cached prefix (the exact pages the
                    # admission gate credited) and queue the suffix for
                    # page-sized chunk fills riding the decode steps — no
                    # prefill work happens at admission
                    hashes = self.sched._prompt_hashes(req) \
                        if self.radix else \
                        (prefix_page_hashes(toks, t)
                         if self.prefix_cache else [])
                    match = self.sched.take_match(req) \
                        if self.radix else None
                    adopted = match.pages if match is not None else 0
                    self.state.adopt_prefix(
                        seq, match.groups if match is not None else (),
                        pending_hashes=hashes[adopted:])
                    act.pending = toks[adopted * t:]
                    act.prefilled = adopted * t
                    act.hashes = hashes
                    self.pages_adopted_total += adopted
                    self.pages_needed_total += self.sched.adopt_cap(req)
                    self._rows[row_i] = act
                    rec.active, rec.row, rec.status = act, row_i, "active"
                    self._rows_dirty = True
                    if rec.metrics is not None:
                        rec.metrics.on_admit()
                    continue
                t0 = time.perf_counter()
                logits_all, caches = eng._prefill_all(toks, shard)
                want_hashes = self.prefix_cache or self.radix
                hashes = [prefix_page_hashes(toks, t)] if want_hashes \
                    else None
                # adopt the radix-cached prefix pages by reference (the
                # prefill still runs full-length for the logits, but the
                # cached pages are not written again)
                match = self.sched.take_match(req) if self.radix else None
                adopted = match.pages if match is not None else 0
                if adopted:
                    self.state.adopt_prefix(seq, match.groups)
                    self.pages_adopted_total += adopted
                self.pages_needed_total += self.sched.adopt_cap(req)
                extract_prefill_pages(eng.model, caches, self.state, [seq],
                                      page_hashes=hashes,
                                      skip_pages=[adopted])
                if self.radix and hashes:
                    # pin the prompt's full pages for later requests
                    self.prefix_index.insert(hashes[0], shard=shard)
                eng.stats["prefill_s"] += time.perf_counter() - t0
                tok = int(sample(logits_all[:, plen - 1], self.greedy,
                                 self.temperature, self._gen)[0])
                eng.stats["tokens"] += 1
                act.outs.append(tok)
                self._rows[row_i] = act
                rec.active, rec.row, rec.status = act, row_i, "active"
                self._rows_dirty = True
                if rec.metrics is not None:
                    rec.metrics.on_admit()
                    rec.metrics.on_tokens(1)
                done = act.finished
                if done:
                    self._finish(rec)
                events.append(StreamEvent(req, [tok], done=done))

    def step(self) -> list[StreamEvent]:
        """One admission round + one step over the live rows. Returns the
        per-request token events (admission prefill tokens included); an
        idle session returns an empty list.

        While chunked-prefill rows are live the step widens to
        ``max(speculate, page_tokens)`` columns: up to ``prefill_budget``
        chunk rows stream one prompt page each through the verify step
        while every decode row keeps decoding in the same step."""
        events: list[StreamEvent] = list(self._pending_events)
        self._pending_events.clear()
        self._admit(events)
        rows = self._rows
        if all(a is None for a in rows):
            if not self.sched.done:   # unreachable: submit() rejects instead
                raise RuntimeError("scheduler stalled with waiting "
                                   "requests and no active rows")
            return events
        eng, pool, state = self.engine, self.pool, self.state
        t = pool.page_tokens
        chunk_rows: dict[int, tuple[int, bool]] = {}   # row -> (m, final)
        wide = any(a is not None and a.prefilling for a in rows)
        spec = self.spec_k > 1 or wide
        t0 = time.perf_counter()
        hits0 = (pool.stats["fast_hits"], pool.stats["slow_hits"])
        g0 = state.gather_s
        if spec:
            # verify step: k rows per live request, mixed freely with
            # plain (eff_k = 1) rows and prefill chunk rows; tokens ride
            # in the control block, so no device-token feedback
            k = max(self.spec_k, t) if wide else self.spec_k
            step_fn = eng._fused_step_fn(state.slots, self.greedy,
                                         self.temperature, k=k) \
                if wide else self._step_fn
            budget = self.prefill_budget
            srows: list[Optional[dict]] = []
            for act in rows:
                if act is None:
                    srows.append(None)
                    continue
                if act.prefilling:
                    if budget <= 0:
                        srows.append(None)   # over budget: wait a step
                        continue
                    budget -= 1
                    # fill to the page boundary, never across it: one
                    # chunk completes at most one page, so end_step sees
                    # whole pages exactly as decode does
                    m = min(t - act.prefilled % t, len(act.pending))
                    final = m == len(act.pending)
                    chunk_rows[len(srows)] = (m, final)
                    srows.append({"seq": act.seq, "pos": act.prefilled,
                                  "chunk": act.pending[:m], "final": final})
                    continue
                srows.append({
                    "seq": act.seq,
                    "history": np.concatenate(
                        [np.asarray(act.req.prompt, np.int32),
                         np.asarray(act.outs, np.int32)]),
                    "pos": act.pos, "eff_k": act.eff_k,
                    "limit": act.req.max_new_tokens - len(act.outs),
                    "eos": act.req.eos_token, "stats": act.stats})
            kept = eng._spec_step(state, step_fn, k, srows, self._gen)
            self.chunk_steps += bool(chunk_rows)
            # the verify step did not refresh the 1-token device feedback
            # vector — rebuild it on the next plain step
            self._rows_dirty = True
            self._tok_dev = None
        elif not self._fused:
            # eager / numpy: the per-layer step over host tokens
            pos = np.zeros(len(rows), np.int32)
            seq_ids = [-1] * len(rows)
            tokens = np.zeros(len(rows), np.int32)
            for i, act in enumerate(rows):
                if act is not None:
                    pos[i], seq_ids[i] = act.pos, act.seq
                    tokens[i] = act.outs[-1]
            logits = paged_decode_step(eng.model, tokens, state, seq_ids,
                                       pos, backend=eng.backend)
            toks = sample(logits, self.greedy, self.temperature,
                          self._gen).cpu().numpy()
        else:
            pos = np.zeros(len(rows), np.int32)
            seq_ids = [-1] * len(rows)
            for i, act in enumerate(rows):
                if act is not None:
                    pos[i], seq_ids[i] = act.pos, act.seq
            tok_in = self._tok_dev
            fed_back = not (self._rows_dirty or tok_in is None)
            if not fed_back:
                # an admission or a retirement changed the rows — upload
                # the token vector once; steady-state steps feed the
                # previous step's device tokens back
                tok_in = np.zeros(len(rows), np.int32)
                for i, act in enumerate(rows):
                    if act is not None:
                        tok_in[i] = act.outs[-1]
                self._rows_dirty = False
            before = state.transfer_counts()
            pool_io = (state._device.writes, state._device.reads)
            toks, self._tok_dev = state.run_fused(self._step_fn, tok_in,
                                                  seq_ids, pos, self._gen)
            after = state.transfer_counts()
            if fed_back and pool_io == (state._device.writes,
                                        state._device.reads):
                self.steady_transfers.append((after[0] - before[0],
                                              after[1] - before[1]))
        dt = time.perf_counter() - t0
        eng.stats["decode_s"] += dt
        eng.stats["decode_steps"] += 1
        self.steps += 1
        self.sched.observe_step(dt)   # service-rate EMA (deadline sheds)
        if self._observe is not None:
            self._observe(state.gather_s - g0,
                          pool.stats["fast_hits"] - hits0[0],
                          pool.stats["slow_hits"] - hits0[1])
        decode_tokens = 0
        for i, act in enumerate(rows):
            if act is None:
                continue
            rec = self._recs[id(act.req)]
            if i in chunk_rows:
                m, final = chunk_rows[i]
                act.prefilled += m
                act.pending = act.pending[m:]
                if not final:
                    continue        # mid-prefill: nothing to stream yet
                tok = int(kept[i][0])    # first generated token
                act.outs.append(tok)
                act.pending = None
                eng.stats["tokens"] += 1
                if self.radix and act.hashes:
                    # prompt fully resident: pin its full pages so later
                    # requests adopt them
                    self.prefix_index.insert(
                        act.hashes, shard=self.sched.assigned_shard(act.req))
                if rec.metrics is not None:
                    rec.metrics.on_tokens(1)
                done = act.finished
                if done:
                    self._finish(rec)
                events.append(StreamEvent(act.req, [tok], done=done))
                continue
            if spec:
                if kept[i] is None:      # over-budget prefill row idled
                    continue
                new = [int(x) for x in kept[i]]
                act.outs.extend(new)
            else:
                new = [int(toks[i])]
                act.outs.append(new[0])
                act.stats.steps += 1
                act.stats.tokens += 1
            decode_tokens += len(new)
            eng.stats["tokens"] += len(new)
            if rec.metrics is not None:
                rec.metrics.on_tokens(len(new))
            done = act.finished
            if done:
                self._finish(rec)
            events.append(StreamEvent(act.req, new, done=done))
        if chunk_rows and decode_tokens:
            self.prefill_step_decode_ms.append(dt * 1e3 / decode_tokens)
        if self._preempt_observe is not None:
            # per-step reward for a learned victim ranking: decode
            # latency + the deadline misses the finishes above counted
            self._preempt_observe(dt, self._step_misses)
            self._step_misses = 0
        if self._debug:     # REPRO_SERVE_DEBUG: per-step pool invariants
            self.check_invariants()
        self.peak_live_pages = max(self.peak_live_pages, pool.live_pages)
        return events
