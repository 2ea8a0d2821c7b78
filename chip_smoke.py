#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --only kernel   # or exact | serve | chunked |
                                          # spec | overload | families |
                                          # hybrid | train | napel |
                                          # stencil | sibyl | mesh |
                                          # examples

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. device  — the card, ``nvidia-smi``'s name and power limit, versions.
   Builds the CUDA kernels from the sources in the checkout (into
   ``build/kernels/``) and prints what ``ptxas -v`` reported, per paged
   route with the dynamic shared memory its launch asks for, per scan
   kernel with the SSD wgmma route's chunk-scan shared memory.
2. kernel  — each kernel against its plain PyTorch version on its spec's
   cases (paged attention: flat and layer-stacked pools; bf16 inputs
   against the fp32 plain version, held to the spec's tolerance), then
   at starcoder2-7b's shapes with the same inputs on both sides, held per
   element to 2 ulps of |want| in the output dtype: paged attention at
   b=4, hq=36, hkv=4, d=128, T=128, L=32 (mixed fast/slow pages, one dead
   row) with 1, 4 and 128 query rows per sequence, each row checking the
   route it took (`route`: split, wgmma or simt) and timed by
   `device_ms` beside SDPA's; at k = 1 and 128 in bf16 three broken
   plain variants (K's float tier in one bf16 piece, the last split
   dropped, the int8 scale left off) must exceed the limit, and the
   kernel before the redesign (the simt route) and the new route run in
   10 alternating pairs; then edge shapes through the wgmma route (d =
   64, 128, 256, a ragged block of rows, length 1, a dead row, 16-token
   pages, bf16 pools) and the split route (g = 9 at lengths 1, 129, 384,
   a page, 16-token pages with bf16 pools). Flash
   attention:
   every spec case cast to bf16 and five edge shapes (sq != skv, one
   position, b=3 at d=256) through the route each takes (`route`: wgmma
   or simt), then b=1, s = 2048, 1000 (ragged) and 600, causal and
   not, and recurrentgemma-2b's local-attention prefill (the generate
   prefill's b=2, s = 2300, hq=10, hkv=1, d=256, window 2048), each row
   checking its route and timed by `device_ms` beside SDPA's; at s =
   2048 two broken plain variants (P rounded to bf16 once, the last
   128-key tile dropped) must exceed the limit, and at s = 2048 and at
   recurrentgemma's shape the kernel bf16 took before the redesign (the
   simt route) and the wgmma route run in 10 alternating pairs. The SSD
   scan (5 spec cases, on the simt route; five edge shapes on the wgmma
   route: S < the chunk, S = 1, G = 2, N = 64, B = 3 ragged; then
   mamba2-780m's B=1, S=2048, H=48, P=64, G=1, N=128 in bf16 (wgmma)
   and fp32 (simt), ragged S=1000 and the generate prefill's B=3,
   S=1536; y and the final state) and the RG-LRU scan (5 spec cases,
   serial at S = 1 and 4, chunked above; three edge shapes on the
   chunked route; then W=2560 at S=2048, ragged S=1000 and the generate
   prefill's B=2, S=2300), each row checking the route it took and
   timed by `device_ms`. The SSD scan chunks differently from its plain
   version, so it is held to a limit scaled by max |want| and sqrt(S)
   (`ssd_limit`), which deliberately broken loops must exceed: the simt
   route's 64-chunk loop (`ssd_chunk_loop`) without an inter-chunk term
   or the ragged chunk, the wgmma route's arithmetic (`ssd_wgmma_loop`)
   with a chunk left out of the state pass or the scores or w . x in
   one bf16 piece (h_prev in one piece is recorded: the limit does not
   reject it). The RG-LRU scan is held to 2 ulps, which the chunked
   loop with a dropped carry (`rglru_chunked_loop`) must exceed. At the
   generate prefills' shapes the kernel before the redesign (simt,
   serial) and the new route run in 10 alternating pairs. Times kernel,
   plain version and one PyTorch call (``scaled_dot_product_attention``;
   none computes either scan) in alternation within one run. Then the
   tile sweeps (`tile_sweeps`): every tile of the paged, flash, SSD and
   RG-LRU tune spaces at shapes the phase times, held to the phase's
   limit, the broken variants over it at each tile, each tile timed
   beside the knee, the fastest tile and the launch before tiles.
3. exact   — starcoder2-7b at full width, 2 layers, fp32, seeded weights:
   identical greedy tokens with the kernels and with the plain versions
   for ``generate``, monolithic ``serve``, the default chunked + radix
   ``serve`` and k = 4 speculative ``serve``; preempt / resume through
   ``ServeSession`` (one request parked mid chunk fill, one mid decode, a
   k = 4 speculative row mid decode) giving the never-preempted run's
   tokens; then mamba2-780m (2 layers) and recurrentgemma-2b (3 layers,
   one of each kind) at full width, fp32: identical tokens for
   ``generate``, the default ``serve`` and k = 4 ``serve``, and the
   reference's swap protocol (the sequence parked at decode step 6, its
   recurrent slot and ring pages restored) giving the uninterrupted
   stream; the ``eager`` and ``numpy`` decode modes' fp32 tokens equal
   the ``fused`` step's for ``generate`` and ``serve`` (`exact_modes`).
4. serve   — the main path: starcoder2-7b, 16 of 32 layers, bf16, seeded
   weights made on the card, a 128-token page pool with every other page
   in the int8 tier; ``serve`` 5 requests (prompts 120..600, 32 new
   tokens) with ``max_active=2`` and one prefill pass per prompt. Checks
   outputs, an empty pool, paged-attention launches == decode steps x
   layers, flash-attention launches == prefills x layers and 2 transfers
   per steady token, every flash launch on the wgmma route and every
   paged launch on the split route. Then 16 decode steps of the same
   model (2 rows, 500-token context) timed bare and under
   ``torch.profiler``: device busy share, kernels per step, the largest
   kernels. Then the three decode modes in turns (`serve_modes`), the
   profile at the knee and at the launch before tiles in the order knee,
   fixed, fixed, knee, and the knee cache's round trip
   (`knee_round_trip`).
5. chunked — the default ``serve`` path (chunked prefill + radix prefix
   cache) on 6 prompts sharing a 512-token head: prefix hit rate, chunk
   and decode step times, time to first token, an empty pool after
   ``close``, the chunk-fill (k = 128) steps' paged launches on the wgmma
   route and the others' on split; then 4 chunk-fill steps of 2 rows
   traced (the paged kernel's share of the device's busy time).
6. spec    — k = 4 speculative ``serve`` with n-gram drafts on the serve
   phase's prompts: accept rate, tokens per verify step; verify steps on
   the split route, chunk-fill steps on wgmma.
7. overload — the main path under load: the reference's ``overload``
   traffic mix (16 requests, three deadline classes, priorities 0 / 1)
   replayed open-loop through ``traffic.run_trace`` and the async front
   end over the serve phase's model, prompts 120-600 and 16-32 new
   tokens, arrivals at `ARRIVAL_X_SERVICE` times the serve phase's
   measured service rate, deadlines at `DEADLINE_X_STEP` times its decode
   step; the pool's invariants checked after every step
   (``REPRO_SERVE_DEBUG``). Checks every request's outcome, preemptions
   with swap traffic both ways, an empty pool, decode / verify launches
   on the split route and chunk fills on wgmma, 2 transfers per steady
   token; prints the latency summary (queue wait, TTFT, TPOT p50 / p99,
   SLO attainment) and the swap-out / swap-in ms (CUDA events). Then a
   ``REPRO_SERVE_FAULT=swap_fail:1`` pass (the victim ends as a
   ``swap_fail`` error, the rest finish) and one recurrentgemma-2b
   request at full depth parked and resumed.
8. hybrid  — the hybrid stacks, bf16, seeded weights: mamba2-780m (12 of
   48 layers) ``generate`` (prompts 256/700/1536, 32 new tokens) and
   the default ``serve`` (3 prompts of 200-350 tokens), recurrentgemma-2b
   ``generate`` (prompts 2300 and 1000, 40 new tokens: a ring page drops
   during decode) and the default ``serve`` (3 short prompts). Checks
   SSD / RG-LRU / flash launches per prefill (SSD and flash on the wgmma
   route, RG-LRU on the chunked route), no scan launch from ``serve``
   (its prompts stream through the one-token cores, as in the
   reference), 2 transfers per steady token, no recurrent-store
   readback, live ring pages within ``ring_pages()``.
9. stencil — NERO's COSMO stencils, hdiff (routes tma and simt) and
   vadvc (prefetch and simt): every spec case and the edge grids of
   `STENCIL_EDGE_GRIDS` (ragged against every tile; rows not a multiple
   of 16 bytes, which hdiff sends to simt; vadvc's nz = 1, 2, 3) on each
   route the grid can take, at every tile of the tune space the route
   launches at, held to the plain version to the bit, the wrapper's route
   checked; at the COSMO grid (64 x 256 x 256; hdiff fp32 and bf16,
   vadvc fp32) the knee tile on the new route against the plain version
   to the bit and a deliberately broken variant (`hdiff_variant`,
   `vadvc_variant`) shown to differ; device times at every tile beside
   the Hopper cost model's estimate (inputs rotated through copies larger
   than L2), the plain version's time and the bound; the first port
   (simt; hdiff at PR 14's knee) against the new route in 10 alternating
   pairs; one launch's device time; then the main path,
   `weather_stencil.main` at the COSMO grid with the counts set to 0 just
   before it, every launch on the new routes, its hdiff sweep equal to
   the same sweep through the plain version on the card; then the same
   call once more under cProfile, its top host functions on a line of
   their own. `hdiff_tiled_loop` and `vadvc_prefetch_loop` restate the
   new routes' blocking in plain PyTorch for the CPU tests.
10. sibyl  — Sibyl (thesis Ch. 7) on the card, one JSON line per part:
   ``storage``: `launch.sibyl_storage.main` (rsrch_0, 10,000 requests,
   H&L, FastOnly / CDE / HPS / the DQN), latencies normalised to
   fast_only (the simulator's NVMe + HDD model, not times of the card),
   migrations, top features; the same run with the agent on the CPU
   and the first decision where the two differ; the card's agent held
   to a CPU agent from one state (Q over 256 buffered states, one
   training step) at `tests/test_torch_sibyl.py`'s tolerance; host ms
   per act and per training step. ``serve``: the serve phase's workload
   with `SibylPlacement` on the card and SIBYL_FAST_PAGES fast pages
   (below the run's peak live pages, printed), in turns with
   `EveryOtherSlow`: outputs, both tiers used, LRU demotion, no pending
   decision, an empty pool, paged launches = steps x layers on split, 2
   transfers per steady token, decode ms/step, TTFT and the policy's
   host ms per prefill and per decode step. ``exact``: starcoder2-7b at
   full width, 2 layers, fp32, the kernel run's Sibyl decisions replayed
   in the plain-version run: identical tokens for ``generate``,
   monolithic and default ``serve``. ``overload``: the overload phase's
   replay with `SibylPreemption` ranking victims beside the LRU policy:
   every outcome, decisions, no pending transition, an empty pool, SLO
   attainment. ``decode_trace``: the serve run's pool events
   (`DecodeTraceRecorder`) replayed through `HssEnv` for the heuristics
   and the DQN.
11. families — the remaining model families (it runs after the serve
   block and before ``hybrid``). ``kernel`` rows: paged attention at
   each paged family's heads (g = 1 / d 128 codeqwen1.5-7b, g = 3 / d 64
   granite-moe-3b-a800m, g = 8 / d 128 qwen3-moe-30b-a3b) at k = 1 and 4
   (split) and 128 (wgmma), flash attention at each family's prefill (s =
   600: musicgen-medium, codeqwen, granite-moe, llama-3.2-vision-11b,
   qwen3-moe at its generate batch of 5), bf16, held to 2 ulps and timed
   by `device_ms` beside SDPA's. ``qwen3-moe-30b-a3b``: 12 of 48 layers,
   bf16, seeded weights on the card (61 GB at 48), a 128-token pool with every
   other page int8: the serve workload through the default ``serve()``
   and one monolithic ``generate``: decode ms/step, TTFT, prefill ms,
   launches by route, 2 transfers per steady token, 8 traced decode steps
   (device busy share, the MoE layers' share through `moe_span`), peak
   memory. The other five at published widths, 4 layers (llama-vision
   5, one group with its cross layer): codeqwen and granite-moe through
   ``serve()``, minicpm3-4b (MLA) through the dense-cache ``generate``,
   llama-vision and musicgen at the ``Model`` level with seeded image /
   frame embeddings (prefill of 2 x 600, 8 dense decode steps).
   ``exact``: 2 layers, fp32, kernels against ``backend="ref"``:
   identical tokens for the three paged families (``generate``, k = 4
   ``serve``), llama-vision's and musicgen's prefill logits within 2
   ulps, minicpm3's tokens.
12. train — training on the card (it runs after ``hybrid``), one JSON
   line per part. ``exact`` (fp32, TF32 off): starcoder2-7b (2 layers),
   mamba2-780m (2) and recurrentgemma-2b (3, one group, 2560 positions
   past its 2048 window) at full width, remat on: the loss and every
   parameter's gradient through the kernels' autograd Functions against
   the same step on ``backend="ref"``, each leaf within
   `TRAIN_GRAD_LIMIT` of max |g_plain|, launches per step as
   `expected_train_launches`; the two broken backwards of
   `train_broken_variants` (RG-LRU's reverse scan without the shift of
   a, flash's recompute without the window) over the limit. ``functions``:
   each Function's backward at full width against autograd of its plain
   version (flash at starcoder2-7b b=2 s=2048 and recurrentgemma-2b's
   s=4096 window 2048, bf16; SSD at mamba2-780m B=4 S=2048, bf16; RG-LRU
   at W=2560 S=4096, fp32) with the broken variants over the limit,
   forward + backward timed beside the plain version's and SDPA's.
   ``full`` (bf16 params, fp32 master, m and v; `TRAIN_FULL`):
   mamba2-780m (12 of 48 layers, batch 4 x 2048), recurrentgemma-2b (26,
   1 x 4096) and starcoder2-7b (2 of 32 layers, 2 x 2048) through
   `Trainer`,
   4 steps: mamba2 and starcoder2 2 steps and the trainer's checkpoint, a
   new trainer resuming for 2 more (mamba2's params equal to a straight
   4-step run's to the bit); recurrentgemma in one run, its 49.7 GB
   checkpoint being more than a call of the card's machine may write;
   step ms, tokens/s, peak memory beside the state's bytes, launches by
   kernel and route (flash and SSD on ``wgmma``, RG-LRU ``chunked``)
   equal to 4 steps of `expected_train_launches`, finite losses and grad
   norms, every parameter moved; for mamba2 and starcoder2 kernel and
   plain steps in turns and one traced step (device busy share, top
   device ops, the backward's recompute share). ``mesh`` (training on a
   dp x tp plan, `train.sharding`; position i on cuda:i when there is a
   card for each, else all on cuda:0): ``collectives``, the plan's
   reductions over the mesh's devices against the same on cuda:0
   (`compressed_psum`, the replicas' max, the seam forward and
   backward); ``exact``, fp32, starcoder2-7b
   (2 layers), mamba2-780m (2), recurrentgemma-2b (3) and minicpm3-4b
   (2: MLA, latents whole, heads split) at plans 1x2, 2x1 and 2x2,
   starcoder2-7b also at 1x8 (36 q heads: attention whole on every
   shard) and qwen3-moe-30b-a3b (2 layers, 16 of its 128 experts) at 1x8
   (32 q / 4 kv heads: each q block reads one kv head), 2 steps each
   against the 1x1 trainer on the same weights and batches (`TRAIN_MESH_RULE`: step 0's gradient per leaf
   within `TRAIN_GRAD_LIMIT`, losses and grad norms within 1e-5, each
   leaf's update within 1e-2 of 1x1's in norm), launches as
   every shard's `expected_train_launches`, and every per-shard launch
   shape of flash, SSD and RG-LRU held to its plain version forward (the
   kernel phase's rules; recurrentgemma's flash and RG-LRU by
   `magnitude_limit`) and backward (`TRAIN_GRAD_LIMIT`); ``full``,
   `Trainer(mesh=)` at 2x2 on `TRAIN_MESH_FULL` (starcoder2-7b at 2 of
   32 layers, 2 x 2048; mamba2-780m at 12, 4 x 2048), bf16, 4 steps after
   the 1x1 trainer of the same shapes: step ms and tokens/s, the state
   bytes each shard holds equal to `plan_rescale`'s, peak memory,
   launches by route, every step's loss and step 0's grad norm against
   the 1x1 trainer's (`TRAIN_MESH_FULL_RTOL`), one traced step (device
   busy share, kernels), every per-shard launch shape held forward and
   backward as in ``exact``, then 2x2 and 1x1 steps in turns on one
   batch (2x2, 1x1, 1x1, 2x2; the idle trainer's state on the host).
   The ``full`` trainers' and the plans' launches join the ``kernels``
   line's counts.
13. napel — the thesis's data-driven models (Ch. 5-6) on the cost
   counter (`repro_torch.core.hlo_cost`), one JSON line per part; the
   meta counts first, in `NAPEL_EARLY_WORKERS` processes started with
   phase ``train`` and running beside it (in `NAPEL_WORKERS` here when
   ``train`` does not run). ``dryrun``: every
   arch x shape cell of `launch.dryrun` at mesh 1x1 on ``meta`` (status,
   counted flops and bytes, live bytes, fits, bottleneck, wall s), then
   the same 32 cells per device of the 16 x 16 pod (one line each
   mesh); an error whose reason `DRYRUN_KNOWN_ERRORS` (and PERF.md) do
   not list fails. ``mesh_count``: `NAPEL_MESH_COUNT`'s train step
   (starcoder2-7b, 2 layers, bf16) at 2x2 and 1x8 with every position on
   cuda:0, counted on the card; its counts of positions (0, 0) and (0,
   1) equal the one-position counts on ``meta`` in flops by class, fused
   bytes, kernel entries by route and collectives. ``count``: the train steps of `NAPEL_TRAIN` (mamba2-780m 12
   layers 4 x 2048, recurrentgemma-2b 26 layers 1 x 4096, starcoder2-7b 2
   of 32 layers 2 x 2048) and the prefill of `NAPEL_PREFILL`
   (starcoder2-7b, 16 layers, 1 x 600), each counted on ``meta`` and on
   the card: flops by class, both byte counts and every kernel entry
   equal, each kernel's launches equal to its entries; the step's ms
   (median of 3 after a warm step), the counted bound on `H100_SXM` and
   the shares, the counted live bytes beside
   ``torch.cuda.max_memory_allocated``, the top 10 ops by bytes.
   ``energy``: NVML's energy counter (ctypes, ``libnvidia-ml.so.1``)
   over 1.5 s idle, a bf16 matmul loop and an HBM copy loop of at least
   `ENERGY_LOOP_S` each: pJ per flop and per HBM byte. ``corpus``:
   NAPEL's RF / ANN / DT on the DoE points' counts, MRE on the test
   points, predict µs against the count's wall time; the train step of
   the `NAPEL_CARD_POINTS` cheapest points whose counted live bytes fit
   `NAPEL_CARD_BYTES`, ms and joules beside NAPEL's predictions.
   ``leaper``: the h100 platform fitted (copy bandwidth, empty launches,
   matmuls of rising K), base learners on its labels of every corpus
   point, `Leaper.transfer` on 1, 3 and 5 shots of the measured step
   times beside a forest from scratch and the platform model alone. The
   counted and timed steps' launches join the ``kernels`` line.
14. mesh  — serving across devices (`serve.sharding.ServePlan`) with
   every shard on the one card (``make_serve_mesh(d, m, devices=
   ["cuda:0"] * n)``; it runs in the serve block, over the serve phase's
   model), one JSON line per part. ``exact``: starcoder2-7b at full
   width, `MESH_EXACT_LAYERS` layers, fp32, at plans 1x2, 2x1, 2x2 and
   1x4: ``generate``, the default ``serve`` (chunked + radix) and k = 4
   ``generate`` give the 1x1 engine's tokens, ``generate``'s transfers
   are the 1x1 engine's and every steady step costs one upload and one
   download; mamba2-780m (2 layers) at 2x2 and recurrentgemma-2b (3: its
   local-attention layer's one kv head replicates) at 2x1 and 1x2
   through ``generate`` and ``serve``; minicpm3-4b (2 layers, MLA) through
   the dense-cache ``generate`` at 1x2 and 2x2 (`MESH_MLA`), tokens equal
   to 1x1's; recurrentgemma's 10 heads refuse the paged path at 1x4 with
   `ValueError`. Every launch shape the plans gave a kernel
   (paged and flash attention at hq / tp heads, the scans at a shard's
   width) is held to its plain version on the recorded inputs, paged /
   flash / RG-LRU to 2 ulps, SSD to `ssd_limit`; recurrentgemma-2b's fp32
   flash (d = 256, window) and RG-LRU launches, which miss 2 ulps at 1x1
   as at every plan because of the order of their sums, to
   `magnitude_limit` instead, beside the plain loops in the kernels'
   orders and broken variants read over that limit. ``serve``: starcoder2-7b
   at full width and `MESH_SERVE_LAYERS` (8) of its 32 layers (cut
   to keep the whole run within its time limit), bf16, on a
   2x2 plan beside a 1x1 engine over the same weights: the weight bytes
   each holds, counted from the spec before the run and equal to what
   the shards hold; the serve workload (monolithic prefill) in turns
   1x1, 2x2, 2x2, 1x1: decode ms/step, paged launches per step (= 4
   shards x the layers, split route), flash launches (= 2 model shards x
   the layers a prompt, wgmma), 2 transfers per steady token, peak memory, bf16 token
   agreement with 1x1 (reported, not required: the seam sums two
   partial products); the per-shard paged (b = 1, hq = 18, hkv = 2) and
   flash (s = 600, hq = 18) launches held to 2 ulps and timed by
   `device_ms` beside their bounds and SDPA; 16 traced decode steps
   (`phase_profile`: device busy share, kernels per step). ``plan``:
   `launch.dryrun.serve_plan_main` on `H100_SXM`, every arch at 1x1,
   1x2, 2x2, 1x4 and 2x4, no device work. A plan lays position i on
   cuda:i when the machine has a card for every position (the seams are
   then NCCL all-reduces), else every position on cuda:0; the rows say
   which.

15. examples — the JAX package's four remaining ``examples/`` scripts as
   the port runs them (`repro_torch.examples`), each through its
   ``main`` with ``--device cuda``, in process, the launch counts set to
   0 just before it and read just after: ``serve_stream`` (starcoder2-7b
   smoke, 8-token pages: a 6-request ``prefix_heavy`` trace through the
   async front end equal to `serve()`, a cancel after 2 tokens, the pool
   empty; throughput, TTFT / TPOT p50 and p99), ``serve_lm`` (llama3-405b
   smoke: Sibyl placement over a 16-page fast tier, the decode trace's
   replay through the HSS simulator, k = 4 n-gram tokens equal to
   `generate`'s; transitions, the replay's average and p99 latency, the
   accept rate), ``quickstart`` (codeqwen1.5-7b smoke: 40 steps, a
   checkpoint every 20, `generate`; the loss falls) and ``train_100m``
   (135,313,152 fp32 parameters at seq 256 x batch 8 under `Supervisor`,
   `EXAMPLES_TRAIN_STEPS` steps for the run's time and disk,
   `EXAMPLES_STEPS_NOTE`;
   no restart, the loss finite and falling; median step ms, tokens/s).
   These launch the paged kernel at head dim 16 with 8-token pages (split
   at k * g <= 64 rows, simt above) and flash in fp32 (simt); every
   launch is recorded (`recording`), its route checked against its
   shapes and held to its plain version at the tile it ran at
   (`check_recorded`, 2 ulps; train_100m's fp32 flash launches at d 64,
   s 256, which miss 2 ulps by the order of their sums, by
   `magnitude_limit`, beside their 2-ulp reading, the loop in the
   kernel's order and the broken variants over that limit). The
   launches join the ``kernels`` line.

Each phase ends with a ``disk`` line: its writes from ``/proc/self/io``
(`io_counts`: bytes passed to write calls, bytes sent to storage) and
the run's so far. Then the ``knees`` line (`knee_audit`: every knee the main path
resolved, beside the launch before tiles, timed where no sweep confirmed
it), the ``disk`` line of the whole run against the 45 GiB a call may
write, the ``kernels`` line and, last, ``{"ok": true, "device": ...}``.
Needs one CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "paged_attention": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:110"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:72"),
    "ssd_scan": (
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_scan.py:60"),
    "rglru_scan": (
        "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan/rglru_scan.py:37"),
    "hdiff": (
        "src/repro_torch/kernels/hdiff/csrc/hdiff.cu",
        "src/repro/kernels/hdiff/hdiff.py:49"),
    "vadvc": (
        "src/repro_torch/kernels/vadvc/csrc/vadvc.cu",
        "src/repro/kernels/vadvc/vadvc.py:83"),
}

# routes whose kernel lives in a header the library's source includes
ROUTE_SOURCES = {
    ("paged_attention", "split"):
        "src/repro_torch/kernels/paged_attention/csrc/paged_split.cuh",
    ("paged_attention", "simt"):
        "src/repro_torch/kernels/paged_attention/csrc/paged_simt.cuh",
    ("flash_attention", "simt"):
        "src/repro_torch/kernels/flash_attention/csrc/flash_simt.cuh",
    ("ssd_scan", "simt"):
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_simt.cuh",
    ("rglru_scan", "serial"):
        "src/repro_torch/kernels/rglru_scan/csrc/rglru_serial.cuh",
    ("hdiff", "simt"): "src/repro_torch/kernels/hdiff/csrc/hdiff_simt.cuh",
    ("vadvc", "simt"): "src/repro_torch/kernels/vadvc/csrc/vadvc_simt.cuh",
}


PEAKS = {"bf16": BF16_FLOPS, "fp32": FP32_FLOPS}


def work_of(kernel: str, *args, **kwargs) -> dict:
    """The kernel's spec `work` on these inputs: {"bytes", "flops": {rate
    class: flops}}, the function's work whatever runs it."""
    import importlib
    spec = importlib.import_module(f"repro_torch.kernels.{kernel}.spec")
    return spec.work(*args, **kwargs)


def rglru_bytes_and_flops(a, b):
    """a, b and h each once, 2 flops an element: the spec's `work`."""
    w = work_of("rglru_scan", a, b)
    return w["bytes"], sum(w["flops"].values())


RUN_T0 = time.perf_counter()


def emit(obj):
    """One JSON line on stdout; on stderr, the run's seconds so far beside
    the line's phase and part (or case), so a stopped run shows where its
    time went."""
    print(json.dumps(obj), flush=True)
    where = " ".join(str(obj[k])[:60] for k in ("phase", "part", "case")
                     if k in obj)
    print(f"chip_smoke {time.perf_counter() - RUN_T0:8.1f} s  {where}",
          file=sys.stderr, flush=True)


def cuda_ms(fns: dict, warmup: int = 5, rounds: int = 30) -> dict:
    """Time several functions in alternation: each round times every
    function once with CUDA events (the order rotating from round to
    round), so all of them see the same state of the card and the host.
    Returns, per name, the median event time and the median host time of
    the call alone (the time to enqueue its work; where it comes near the
    event time, the host's launches set the pace, not the device)."""
    names = list(fns)
    for _ in range(warmup):
        for name in names:
            fns[name]()
    torch.cuda.synchronize()
    dev = {n: [] for n in names}
    host = {n: [] for n in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fns[name]()
            host[name].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            dev[name].append(start.elapsed_time(end))
    return {n: (statistics.median(dev[n]), statistics.median(host[n]))
            for n in names}


def same_input_limit(want):
    """Per-element limit for a kernel and its plain version run on the
    same inputs: both compute in fp32 and differ only in the order of
    their sums and in the final rounding, so 2 ulps of |want| in the
    output dtype, plus 1e-6 for entries near 0."""
    mant = {torch.float32: 23, torch.bfloat16: 7}[want.dtype]
    a = want.float().abs().clamp_min(2.0 ** -126)
    return 2.0 * torch.exp2(torch.floor(torch.log2(a)) - mant) + 1e-6


SSD_LIMIT_RULE = ("per tensor (y, final state): 256 * 2^-23 * sqrt(S) * "
                  "max |want|")


def ssd_limit(want, s_len: int) -> float:
    """Limit for the SSD scan against its plain version on the same
    inputs, for one output tensor (y or the final state) of a sequence
    of `s_len` positions. Both compute in fp32, but the kernel chunks by
    64 positions and the plain version by 256 (or the whole sequence when
    256 does not divide it): the sums and the state carry run in other
    orders, and the error grows with the magnitudes summed and about
    with sqrt(S). A correct 64-chunk loop (`ssd_chunk_loop`) stays within
    1/16 of this limit on the CPU at the spec's cases and at S = 300,
    1000, 2048; one that drops a chunk's inter-chunk term or skips the
    ragged last chunk exceeds it 50-fold or more."""
    scale = max(want.float().abs().max().item(), 2.0 ** -126)
    return 256.0 * 2.0 ** -23 * s_len ** 0.5 * scale


def ssd_chunk_loop(x, b_mat, c_mat, dt, a, fault=None):
    """The ssd_scan kernel's algorithm in plain PyTorch: chunks of 64
    positions, the last one ragged, the state carried chunk to chunk.
    ``fault`` breaks it on purpose, to show that `ssd_limit` catches
    such a kernel: "drop_inter" drops chunk 1's inter-chunk term C
    exp(cum) @ state, "skip_ragged" skips a ragged last chunk (its y
    stays 0, the state is not updated)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import CHUNK
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    rep = H // G
    xf, dtf, af = x.float(), dt.float(), a.float()
    bh = b_mat.float().repeat_interleave(rep, 2)
    ch = c_mat.float().repeat_interleave(rep, 2)
    state = torch.zeros(B, H, P, N, device=x.device)
    y = torch.zeros(B, S, H, P, device=x.device)
    for ci, c0 in enumerate(range(0, S, CHUNK)):
        q = min(CHUNK, S - c0)
        if fault == "skip_ragged" and q < CHUNK:
            break
        dtc = dtf[:, c0:c0 + q]
        cum = torch.cumsum(dtc * af, dim=1)                  # (B, q, H)
        xc, bc, cc = xf[:, c0:c0 + q], bh[:, c0:c0 + q], ch[:, c0:c0 + q]
        ii = torch.arange(q, device=x.device)[:, None]
        jj = torch.arange(q, device=x.device)[None, :]
        diff = torch.where((ii >= jj)[None, :, :, None],
                           cum[:, :, None, :] - cum[:, None, :, :],
                           float("-inf"))
        s = torch.einsum("bihn,bjhn->bhij", cc, bc) \
            * torch.exp(diff).permute(0, 3, 1, 2) \
            * dtc.permute(0, 2, 1)[:, :, None, :]
        inter = torch.einsum("bihn,bhpn->bihp", cc, state) \
            * torch.exp(cum)[..., None]
        if fault == "drop_inter" and ci == 1:
            inter = torch.zeros_like(inter)
        y[:, c0:c0 + q] = torch.einsum("bhij,bjhp->bihp", s, xc) + inter
        w = torch.exp(cum[:, -1:] - cum) * dtc
        state = state * torch.exp(cum[:, -1])[..., None, None] \
            + torch.einsum("bjhn,bjhp->bhpn", bc, xc * w[..., None])
    return y, state


def over_ssd_limit(got, want) -> float:
    """max over y and the final state of max |got - want| / `ssd_limit`."""
    s_len = want[0].shape[1]
    return max((g.float() - w.float()).abs().max().item()
               / ssd_limit(w, s_len) for g, w in zip(got, want))


def bf16_pieces(t, n: int):
    """fp32 `t` as n bf16 pieces (returned as fp32 tensors): each the bf16
    rounding of what the pieces before it left, as the kernels'
    `split_pieces` cuts an operand for the tensor cores."""
    out, rest = [], t.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def ssd_wgmma_loop(x, b_mat, c_mat, dt, a, *, chunk=None, pieces=None,
                   score_pieces=None, wx_pieces=None, state_pieces=None,
                   fault=None):
    """The ssd_scan kernel's wgmma route in plain PyTorch: chunks of
    `chunk` positions (the last one short), all chunks at once; the chunk
    states (w . x)^T B with w . x in `wx_pieces` bf16 pieces; the state
    pass over the chunks in fp32; y = exp(cum_i) C_i . h_prev (h_prev in
    `state_pieces` pieces) + s . x, the scores s in `score_pieces` pieces.
    Each product of pieces is exact in fp32 (bf16 x bf16), as on the
    tensor cores; x, B and C are taken as given (bf16 on the route).
    Unset piece counts are `pieces`, by default the route's. ``fault``
    breaks it on purpose, in the design's own way: "skip_state_chunk"
    leaves chunk 1's state out of the state pass, "one_piece_state" takes
    h_prev in one bf16 piece."""
    from repro_torch.kernels.ssd_scan.ssd_scan import WGMMA_CHUNK, \
        WGMMA_PIECES
    Q = chunk or WGMMA_CHUNK
    pieces = pieces or WGMMA_PIECES
    score_pieces = score_pieces or pieces
    wx_pieces = wx_pieces or pieces
    state_pieces = 1 if fault == "one_piece_state" else \
        (state_pieces or pieces)
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    rep = H // G
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):
        t = t.float()
        t = torch.cat([t, t.new_zeros((B, pad) + t.shape[2:])], dim=1)
        return t.reshape((B, nc, Q) + t.shape[2:])

    xc, bc, cc, dtc = chunks(x), chunks(b_mat), chunks(c_mat), chunks(dt)
    bh = bc.repeat_interleave(rep, dim=3)                 # (B, nc, Q, H, N)
    ch = cc.repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dtc * a.float(), dim=2)            # (B, nc, Q, H)
    last = cum[:, :, -1:]
    # 1. chunk states
    wx = (torch.exp(last - cum) * dtc)[..., None] * xc    # (B, nc, Q, H, P)
    states = sum(torch.einsum("bcqhp,bcqhn->bchpn", piece, bh)
                 for piece in bf16_pieces(wx, wx_pieces))
    # 2. state pass
    decay = torch.exp(last[:, :, 0])                      # (B, nc, H)
    h = torch.zeros(B, H, P, N, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        add = 0.0 if fault == "skip_state_chunk" and c == 1 else states[:, c]
        h = h * decay[:, c, :, None, None] + add
    h_prev = torch.stack(h_prev, dim=1)                   # (B, nc, H, P, N)
    # 3. chunk scan
    inter = sum(torch.einsum("bcqhn,bchpn->bcqhp", ch, piece)
                for piece in bf16_pieces(h_prev, state_pieces))
    y = inter * torch.exp(cum)[..., None]
    cb = torch.einsum("bcihn,bcjhn->bchij", ch, bh)
    ii = torch.arange(Q, device=x.device)[:, None]
    jj = torch.arange(Q, device=x.device)[None, :]
    diff = torch.where((ii >= jj)[None, None, None],
                       cum.permute(0, 1, 3, 2)[..., :, None]
                       - cum.permute(0, 1, 3, 2)[..., None, :],
                       float("-inf"))
    s = cb * torch.exp(diff) * dtc.permute(0, 1, 3, 2)[..., None, :]
    y = y + sum(torch.einsum("bchij,bcjhp->bcihp", piece, xc)
                for piece in bf16_pieces(s, score_pieces))
    return y.reshape(B, nc * Q, H, P)[:, :S], h


RGLRU_FAULTS = ("drop_carry",)


def rglru_chunked_loop(a, b, chunk=None, fault=None):
    """The rglru_scan kernel's chunked route in plain PyTorch, step for
    step (a product, then a sum, each rounded to fp32): per chunk of
    `chunk` positions the product of its a's and its scan from zero, the
    carry chained over the chunks, then each chunk's recurrence from its
    carry. ``fault`` "drop_carry" sets the carry entering the middle chunk
    to 0, to show that `same_input_limit` catches such a kernel."""
    from repro_torch.kernels.rglru_scan.rglru_scan import CHUNK
    L = chunk or CHUNK
    B, S, W = a.shape
    nc = -(-S // L)
    pad = nc * L - S
    ac = torch.cat([a.float(), a.new_ones(B, pad, W)], 1).reshape(B, nc, L, W)
    bc = torch.cat([b.float(), b.new_zeros(B, pad, W)], 1).reshape(B, nc, L,
                                                                   W)
    local = torch.zeros(B, nc, W, device=a.device)
    prod = torch.ones(B, nc, W, device=a.device)
    for t in range(L):
        local = ac[:, :, t] * local + bc[:, :, t]
        prod = prod * ac[:, :, t]
    carry = [torch.zeros(B, W, device=a.device)]
    for c in range(1, nc):
        carry.append(prod[:, c - 1] * carry[-1] + local[:, c - 1])
    if fault == "drop_carry":
        carry[nc // 2] = torch.zeros_like(carry[0])
    h = torch.stack(carry, dim=1)                          # (B, nc, W)
    out = torch.empty(B, nc, L, W, device=a.device)
    for t in range(L):
        h = ac[:, :, t] * h + bc[:, :, t]
        out[:, :, t] = h
    return out.reshape(B, nc * L, W)[:, :S]


# ---------------------------------------------------------------------------
# 1. device + build
# ---------------------------------------------------------------------------
def ptxas_by_kernel(log: str) -> dict:
    """`ptxas -v`'s report per entry function (mangled name): registers,
    stack frame and spill bytes."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
    return out


def paged_ptxas(log: str) -> dict:
    """Registers, spills and dynamic shared memory of each paged route's
    kernels (ptxas reports only static shared memory; the dynamic size
    is what the launch asks for at starcoder2-7b's shapes: d = 128, fp32
    pools, k * g = 9 and 36 rows on split)."""
    from repro_torch.kernels.paged_attention.paged_attention import _lib
    lib = _lib()
    smem = {"split": {f"rows={kg}": lib.paged_attention_split_smem(kg, 128, 0)
                      for kg in (9, 36)},
            "wgmma": {"d=128": lib.paged_attention_wgmma_smem(128, 0)}}
    out = {}
    for name, info in ptxas_by_kernel(log).items():
        kind = ("split" if "split_kernel" in name else
                "wgmma" if "wgmma_kernel" in name else "simt")
        out.setdefault(kind, {"kernels": {}, "dynamic_smem": smem.get(kind)})
        out[kind]["kernels"][name] = info
    return out


def scan_ptxas(build) -> dict:
    """Registers and spills of each scan kernel (`ptxas -v`), the
    warpgroup arrives ptxas added to the SSD kernels, and the
    dynamic shared memory of the SSD wgmma route's chunk-scan block (its
    largest) at its chunk and pieces, N = 128 and 64."""
    from repro_torch.kernels.ssd_scan.ssd_scan import _lib
    logs = {name: (build.BUILD_DIR / f"{name}.log").read_text()
            for name in ("ssd_scan", "rglru_scan")}
    out = {name: ptxas_by_kernel(log) for name, log in logs.items()}
    # ptxas note C7519: a warpgroup.arrive it added before a wgmma that
    # reads registers written since the last one
    for fn in re.findall(r"C7519\).*in function '([^']+)'", logs["ssd_scan"]):
        entry = out["ssd_scan"].setdefault(fn, {})
        entry["wgmma_arrives_added"] = entry.get("wgmma_arrives_added", 0) + 1
    out["ssd_wgmma_scan_smem"] = {
        f"N={n} chunk={q}": _lib().ssd_scan_wgmma_smem(n, q)
        for n in (128, 64) for q in (128, 64)}
    return out


def stencil_ptxas(build) -> dict:
    """Registers and spills of each stencil kernel (`ptxas -v`; hdiff's
    tma route has one entry per built tile and dtype) and the dynamic
    shared memory of a tma block at each built tile, fp32 and bf16, as
    the library reports it: it must equal the wrapper's
    `tma_smem_bytes`, which the cost model prices."""
    from repro_torch.kernels.hdiff.hdiff import _lib, tma_smem_bytes, \
        tma_tiles
    out = {name: ptxas_by_kernel(
        (build.BUILD_DIR / f"{name}.log").read_text())
        for name in ("hdiff", "vadvc")}
    lib, smem = _lib(), {}
    for t in tma_tiles():
        tile = (t["tile_x"], t["tile_y"], t["block_z"])
        got = [lib.hdiff_tma_smem(*tile, bf16) for bf16 in (0, 1)]
        mine = [tma_smem_bytes(*tile, b) for b in (4, 2)]
        if got != mine:
            raise AssertionError(f"hdiff tma smem at {tile}: library {got}, "
                                 f"wrapper {mine}")
        smem["x".join(map(str, tile))] = got
    out["hdiff_tma_smem"] = smem
    return out


def phase_device() -> dict:
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    smi = cards[0]
    print(smi, flush=True)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in
                    (build.BUILD_DIR / f"{name}.log").read_text().splitlines()
                    if ("registers" in ln or "spill" in ln)
                    and "C7519" not in ln]
             for name in libs if (build.BUILD_DIR / f"{name}.log").exists()
             and name not in ("hdiff", "vadvc")}
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "nvidia_smi_cards": cards,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "build_s": build_s,
            "ptxas": ptxas, "paged_ptxas": paged_ptxas(
                (build.BUILD_DIR / "paged_attention.log").read_text()),
            "scan_ptxas": scan_ptxas(build),
            "stencil_ptxas": stencil_ptxas(build)}
    emit(info)
    return info


# ---------------------------------------------------------------------------
# 2. kernel vs plain version
# ---------------------------------------------------------------------------
def _cast(x, dtype):
    return x if not x.is_floating_point() else x.to(dtype)


def quantize(raw):
    """The serve tier's int8 format (`quant.quantize_page`) on the card."""
    amax = raw.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(raw / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def decode_inputs(gen, *, b, hq, hkv, d, t, n_layers, lengths, dead,
                  q_dtype, rows=1):
    """Layer-stacked mixed-tier pool (odd page ids slow) on the card, each
    row with its own pages; `dead` rows have length 1 and a zero table.
    ``rows`` > 1 gives q (b, rows, hq, d): consecutive query rows of a
    verify or chunk-fill step, row j seeing lengths + j positions."""
    dev = "cuda"
    slots = max(-(-(n + rows - 1) // t) for n in lengths)
    pages = b * slots
    shape = (n_layers, pages, t, hkv, d)
    slow = (torch.arange(pages, device=dev) % 2 == 1)[None, :, None, None]

    def pool():
        raw = torch.randn(shape, generator=gen, device=dev)
        q8, sc = quantize(raw)
        fast = torch.where(slow[..., None], 0.0, raw)
        q8 = torch.where(slow[..., None], q8, torch.zeros_like(q8))
        sc = torch.where(slow, sc, 0.0)
        return fast, q8, sc

    kf, kq, ks = pool()
    vf, vq, vs = pool()
    table = torch.randperm(pages, generator=gen, device=dev) \
        .reshape(b, slots).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for i in dead:
        table[i] = 0
        lens[i] = 1
    q_shape = (b, hq, d) if rows == 1 else (b, rows, hq, d)
    q = torch.randn(q_shape, generator=gen, device=dev).to(q_dtype)
    return [q, kf, vf, kq, vq, ks, vs, table, lens]


def bytes_and_flops(args):
    """Least bytes the function must move (q, out, and for every position
    a row can see the float, int8 and scale entries of K and V) and its
    flops, from this call's inputs: the spec's `work`, the yardstick the
    cost counter reads too."""
    w = work_of("paged_attention", *args)
    return w["bytes"], sum(w["flops"].values())


def sdpa_yardstick(args, layer, rows: int = 1):
    """`scaled_dot_product_attention` over K/V gathered and dequantized
    beforehand (untimed), masked to each row's length. It omits the
    page gather and the dequant the kernel does."""
    from repro_torch.kernels.paged_attention.ref import dequantize_pool
    q, kf, vf, kq, vq, ks, vs, table, lens = args
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    t, hkv = kf.shape[-3], kf.shape[-2]
    tab = table.long()
    k = dequantize_pool(kf[layer][tab], kq[layer][tab], ks[layer][tab])
    v = dequantize_pool(vf[layer][tab], vq[layer][tab], vs[layer][tab])
    s = tab.shape[1] * t
    k = k.reshape(b, s, hkv, d).transpose(1, 2).to(q.dtype).contiguous()
    v = v.reshape(b, s, hkv, d).transpose(1, 2).to(q.dtype).contiguous()
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    limit = lens[:, None].long() + torch.arange(rows, device=q.device)
    mask = torch.arange(s, device=q.device)[None, None, :] < limit[..., None]
    mask = mask[:, None]                                # (b, 1, rows, s)
    qq = q.reshape(b, rows, hq, d).transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


# bf16 products the wgmma route issues per 64-position tile, by the part
# of the tile that holds a nonzero value (a part that is zero throughout
# the tile is skipped)
WGMMA_PRODUCTS = {"k_float": 3, "k_int8": 1, "v_float": 6, "v_int8": 3}


def paged_tc_products(args, layer, rows: int):
    """The bf16 products the wgmma route issues on these inputs, and
    their flops: per block (128 rows, kv head, sequence) and tile of 64
    positions (16 at d = 256) up to the last position its last row sees,
    `WGMMA_PRODUCTS` for each part of K and V holding a nonzero value;
    each a 64-row product per warpgroup, 2 warpgroups a block, 2 * 64 *
    tile * d flops."""
    q, kf, vf, kq, vq = args[:5]
    table, lens = args[7], args[8]
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    t, hkv = kf.shape[-3], kf.shape[-2]
    g, bn = hq // hkv, 64 if d <= 128 else 16
    kg = rows * g
    tab = table.long()
    span = tab.shape[1] * t

    def nonzero(pool):                        # (b, positions, hkv)
        return (pool[layer][tab] != 0).any(-1).reshape(b, span, hkv)

    parts = [(nonzero(x), WGMMA_PRODUCTS[n]) for x, n in (
        (kf, "k_float"), (kq, "k_int8"), (vf, "v_float"), (vq, "v_int8"))]
    total = 0
    for bi, n in enumerate(lens.tolist()):
        for r0 in range(0, kg, 128):
            end = min(n + (min(r0 + 128, kg) - 1) // g, span)
            tiles = -(-end // bn)
            for nz, w in parts:
                m = torch.zeros(tiles * bn, hkv, dtype=torch.bool,
                                device=nz.device)
                m[:end] = nz[bi, :end]
                total += w * int(m.view(tiles, bn, hkv).any(1).sum())
    products = 2 * total
    return products, products * 2 * 64 * bn * d


PAGED_FAULTS = ("k_one_piece", "drop_last_split", "no_int8_scale")


def paged_variant(args, layer, rows: int = 1, *, fault,
                  pages_per_block: int = 0):
    """The plain version broken on purpose, to show that
    `same_input_limit` tells a right paged kernel from a wrong one:
    "k_one_piece" rounds K's float tier to bf16 once (the wgmma route with
    one piece of K), "drop_last_split" leaves out each sequence's
    positions from the start of the split (`split_plan` at
    ``pages_per_block``) that holds its last row's last position,
    "no_int8_scale" reads the int8 tier of K without its scale."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        _sm_count, split_plan)
    from repro_torch.kernels.paged_attention.ref import dequantize_pool
    q, kf, vf, kq, vq, ks, vs, table, lens = args
    kf, vf, kq, vq, ks, vs = (x[layer] for x in (kf, vf, kq, vq, ks, vs))
    if fault == "k_one_piece":
        kf = kf.to(torch.bfloat16).float()
    if fault == "no_int8_scale":
        ks = torch.ones_like(ks)
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    t, hkv = kf.shape[-3], kf.shape[-2]
    g = hq // hkv
    tab = table.long()
    span = tab.shape[1] * t
    k = dequantize_pool(kf[tab], kq[tab], ks[tab]).reshape(b, span, hkv, d)
    v = dequantize_pool(vf[tab], vq[tab], vs[tab]).reshape(b, span, hkv, d)
    qg = q.reshape(b, rows, hkv, g, d).float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bkhgd,bshd->bhkgs", qg, k)
    pos = torch.arange(span, device=q.device)
    limit = lens.long()[:, None] + torch.arange(rows, device=q.device)
    ok = pos[None, None, :] < limit[..., None]              # (b, rows, S)
    if fault == "drop_last_split":
        _, chunk = split_plan(b, hkv, span, d, _sm_count(q.device.index),
                              page_tokens=t, pages_per_block=pages_per_block)
        last = (lens.long() + rows - 2) // chunk * chunk    # (b,)
        ok &= (pos[None, :] < last[:, None])[:, None, :] | (last == 0)[
            :, None, None]
    s = torch.where(ok[:, None, :, None, :], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhkgs,bshd->bkhgd", p, v)
    return out.reshape(q.shape).to(q.dtype)


def paged_broken_variants(args, layer, rows, label) -> dict:
    """Each `paged_variant` against the plain version on the same inputs:
    its error over `same_input_limit` must exceed 1."""
    from repro_torch.kernels import api
    want = api.run("paged_attention", *args, layer, backend="ref")
    out = {}
    for fault in PAGED_FAULTS:
        err, tol, over = ulp_check(paged_variant(args, layer, rows,
                                                 fault=fault), want)
        out[fault] = over
        emit({"phase": "kernel", "case": f"{label} broken: {fault}",
              "kernel": "paged_attention", "fault": fault,
              "max_abs_err": err, "max_err_over_limit": over})
        if not over > 1.0:
            raise AssertionError(f"{label}: the {fault} variant passes the "
                                 f"limit ({over:.2f}x)")
    return out


def paged_before_after(args, layer, rows, label, pairs: int = 10) -> dict:
    """The redesign against the kernel it replaced, on one card: the same
    inputs through the simt route (the first kernel, unchanged, which
    every call took before the redesign) and through
    the route `route` picks, `pairs` pairs of `device_ms`, alternating
    which runs first. Launched through the library directly, so no
    launch counts."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        LOG2E, _lib, route, split_scratch)
    lib = _lib()
    q, kf = args[0], args[1]
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    pages, t, hkv = kf.shape[-4], kf.shape[-3], kf.shape[-2]
    slots = args[7].shape[1]
    kg = rows * (hq // hkv)
    scale = 1.0 / math.sqrt(d)
    q_bf16 = int(q.dtype == torch.bfloat16)
    pool_bf16 = int(kf.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
    shape = (b, rows, hq, hkv, d, pages, t, slots, layer)
    new = route(q.dtype, kg, d)
    stream = torch.cuda.current_stream().cuda_stream

    def simt():
        if lib.paged_attention_launch(*ptrs, *shape, scale, q_bf16,
                                      pool_bf16, stream):
            raise RuntimeError("simt launch failed")

    if new == "split":
        splits, chunk, *scratch, _keep = split_scratch(
            q.device, b, hkv, kg, d, slots * t)

        def after():
            if lib.paged_attention_split_launch(
                    *ptrs, *scratch, *shape, scale, splits, chunk, q_bf16,
                    pool_bf16, stream):
                raise RuntimeError("split launch failed")
    else:
        def after():
            if lib.paged_attention_wgmma_launch(
                    *ptrs, *shape, scale * LOG2E, pool_bf16, stream):
                raise RuntimeError("wgmma launch failed")

    times = {"simt": [], new: []}
    for i in range(pairs):
        for name, fn in ((("simt", simt), (new, after)) if i % 2 == 0
                         else ((new, after), ("simt", simt))):
            times[name].append(device_ms(fn, calls=5, reps=3))
    q1, q3 = np.percentile(times["simt"], [25, 75])
    row = {"phase": "kernel", "case": f"{label}: simt (before) vs {new}",
           "kernel": "paged_attention", "pairs": pairs, "device_ms": times,
           "median_ms": {n: statistics.median(v) for n, v in times.items()},
           "simt_iqr_ms": q3 - q1,
           "new_route_wins": sum(w < s for w, s in zip(times[new],
                                                       times["simt"]))}
    emit(row)
    if row["new_route_wins"] != pairs:
        raise AssertionError(f"{label}: the {new} route won "
                             f"{row['new_route_wins']} of {pairs} pairs")
    return row


# shapes in bf16 that reach the wgmma route (k * g > 64) and no spec case
# has: d = 64, 128, 256; a ragged last block of rows; a row of length 1;
# a dead row (length 1, zero table); pages shorter than a tile; bf16
# pools; and split-route shapes at g = 9: lengths 1, a split edge, a
# page + 1. (shape, rows, route, pools in bf16)
PAGED_EDGE_CASES = (
    (dict(b=3, hq=18, hkv=2, d=64, t=64, n_layers=2, lengths=[300, 1, 77],
          dead=[1]), 40, "wgmma", False),
    (dict(b=2, hq=36, hkv=4, d=128, t=128, n_layers=2, lengths=[1, 900],
          dead=[]), 13, "wgmma", False),
    (dict(b=2, hq=20, hkv=2, d=256, t=32, n_layers=2, lengths=[200, 1],
          dead=[]), 13, "wgmma", False),
    (dict(b=2, hq=9, hkv=1, d=128, t=16, n_layers=2, lengths=[150, 33],
          dead=[]), 8, "wgmma", False),
    (dict(b=2, hq=36, hkv=4, d=128, t=128, n_layers=2, lengths=[600, 1],
          dead=[1]), 8, "wgmma", True),
    (dict(b=3, hq=36, hkv=4, d=128, t=128, n_layers=2,
          lengths=[1, 129, 384], dead=[0]), 1, "split", False),
    (dict(b=2, hq=36, hkv=4, d=128, t=128, n_layers=2, lengths=[128, 1],
          dead=[1]), 4, "split", False),
    (dict(b=2, hq=36, hkv=4, d=128, t=16, n_layers=2, lengths=[300, 17],
          dead=[]), 1, "split", True),
)


def paged_edge_cases():
    """`PAGED_EDGE_CASES` through the route each must take, held to the
    plain version on the same inputs by `same_input_limit`."""
    from repro_torch.kernels import api
    gen = torch.Generator(device="cuda").manual_seed(2)
    for i, (shape, rows, expect, pool_bf16) in enumerate(PAGED_EDGE_CASES):
        args = decode_inputs(gen, q_dtype=torch.bfloat16, rows=rows,
                             **shape)
        if pool_bf16:
            for j in (1, 2, 5, 6):
                args[j] = args[j].to(torch.bfloat16)
        got = {}
        taken = route_taken("paged_attention", lambda: got.setdefault(
            "out", api.run("paged_attention", *args, 1,  # noqa: B023
                           backend="cuda")))
        want = api.run("paged_attention", *args, 1, backend="ref")
        err, tol, over = ulp_check(got["out"], want)
        emit({"phase": "kernel", "kernel": "paged_attention",
              "case": f"edge {i}", "dtype": "bfloat16", "rows": rows,
              "shape": shape, "pools": "bfloat16" if pool_bf16 else
              "float32", "route": taken, "max_abs_err": err,
              "tol": tol, "tol_rule": ULP_RULE, "max_err_over_limit": over})
        if taken != expect or not over <= 1.0:
            raise AssertionError(f"paged edge {shape} k={rows}: route "
                                 f"{taken} (want {expect}), {over:.2f}x "
                                 f"the limit")


ULP_RULE = ("per element: 2 ulps of |want| in the output dtype + 1e-6; "
            "tol is the limit at the element of the largest error")


def ulp_check(got, want):
    """`same_input_limit` per element: (max abs error, the limit at that
    element, max error / limit)."""
    diff = (got.float() - want.float()).abs()
    limit = same_input_limit(want)
    worst = int(torch.argmax(diff))
    return (diff.flatten()[worst].item(), limit.flatten()[worst].item(),
            (diff / limit).max().item())


def ssd_check(got, want):
    """`ssd_limit` over y and the final state: (max abs error, y's limit,
    max error / limit)."""
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    return err, ssd_limit(want[0], want[0].shape[1]), \
        over_ssd_limit(got, want)


def ssd_bf16_intra_checks(mamba: dict) -> list:
    """``ssm_bf16_intra``'s launch (`ssd_scan.launch(bf16_intra=True)`:
    the intra-chunk scores in one bf16 piece on the wgmma route, scores
    and x rounded on the simt route) at mamba2-780m's shapes, bf16 and
    fp32, against the plain version's bf16-intra form at the route's
    chunk (`ref.ssd_chunked(bf16_intra=True)`) within `ssd_limit`; the
    flag must move the output (the launch without it differs). Not the
    main path's launches: counted nowhere."""
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as sd
    rows, bad = [], []
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        shape = dict(B=1, S=2048, **mamba)
        args = ssd_inputs(shape, dtype, seed=7)
        B, S, H, P = args[0].shape
        N = args[1].shape[3]
        kind = sd.route(dtype, S, P, N, args[1].shape[2])
        chunk = sd.WGMMA_CHUNK if kind == "wgmma" else sd.CHUNK
        outs = {}
        for flag in (True, False):
            y = torch.empty(B, S, H, P, device="cuda")
            st = torch.empty(B, H, P, N, device="cuda")
            sd.launch(*args, y, st, kind, bf16_intra=flag)
            outs[flag] = (y, st)
        torch.cuda.synchronize()
        want = sref.ssd_chunked(*args, chunk=chunk, bf16_intra=True)
        err, tol, over = ssd_check(outs[True], want)
        moved = (outs[True][0] - outs[False][0]).abs().max().item()
        row = {"phase": "kernel", "kernel": "ssd_scan",
               "case": f"bf16_intra mamba2-780m B=1 S=2048 {name}",
               "route": kind, "plain_chunk": chunk, "rule": SSD_LIMIT_RULE,
               "max_abs_err": err, "tol": tol, "max_err_over_limit": over,
               "flag_moves_y_by": moved}
        emit(row)
        rows.append(row)
        if not over <= 1.0 or not moved > 0.0:
            bad.append(row)
        del args, outs, want
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"ssd_scan bf16_intra: past the limit or the "
                             f"flag without effect: {bad}")
    return rows


def compare_and_time(label, kernel, plain, library, nbytes, flops, peak,
                     extra, check=ulp_check, rule=ULP_RULE,
                     device: bool = False) -> dict:
    """Hold a kernel to its plain version on the same inputs with
    `check` (default: per element to 2 ulps of |want| in the output
    dtype), then time kernel, plain version and library call (None when
    no PyTorch call computes the function) in alternation. With
    ``device`` the kernel's and the library call's ``kernel_ms`` and
    ``library_ms`` (and so the bound share) are `device_ms`, the card's
    time without the host's enqueue; the event times stay beside them as
    ``event_ms``. Returns the row, with the bound from this call's bytes
    and flops."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, tol, over = check(got, want)
    del got, want
    if not over <= 1.0:
        raise AssertionError(f"{label}: error {err} beyond the limit "
                             f"({over:.2f}x; {rule})")
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    fns = {"kernel": kernel, "plain": plain}
    if library is not None:
        fns["library"] = library
    times = cuda_ms(fns, rounds=20)
    row = {"phase": "kernel", "case": label, **extra,
           "max_abs_err": err, "tol": tol, "tol_rule": rule,
           "max_err_over_limit": over,
           "kernel_ms": times["kernel"][0], "plain_ms": times["plain"][0],
           "library_ms": times["library"][0] if library else None,
           "host_ms": {k: v[1] for k, v in times.items()},
           "timing": "cuda events, one call",
           "bytes": nbytes, "flops": flops,
           "bound_ms": max(t_bytes, t_flops),
           "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
    if device:
        row["event_ms"] = {"kernel": row["kernel_ms"],
                           "library": row["library_ms"]}
        row["kernel_ms"] = device_ms(kernel)
        if library is not None:
            row["library_ms"] = device_ms(library)
        row["timing"] = ("device_ms: 20 calls queued behind a sleep, "
                         "median of 5")
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    emit(row)
    return row


def spec_cases(name, run_case):
    """Every case of a kernel's spec: the kernel on the case's dtype
    against the plain version on fp32 inputs, held to the spec's tol."""
    from repro_torch.kernels import api, registry
    spec = registry.get(name)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for i, case in enumerate(spec.cases):
        inputs = spec.example_inputs(shape=dict(case.shape))
        args = [torch.from_numpy(v).cuda() for v in inputs.values()]
        want = api.run(name, *args, backend="ref", **case.kwargs)
        errs = run_case(spec, case, args, want, dtypes[case.dtype])
        taken = errs.pop("route", None)
        tol = spec.tol[case.dtype]
        err = max(errs.values())
        emit({"phase": "kernel", "kernel": name, "case": i,
              "shape": dict(case.shape), "kwargs": dict(case.kwargs),
              "dtype": case.dtype, "max_abs_err": errs, "tol": tol,
              "ok": err <= tol, **({"route": taken} if taken else {})})
        if not err <= tol:
            raise AssertionError(f"{name} case {i}: error {err} > tol {tol}")


def _paged_case(spec, case, args, want, dtype):
    """Flat pools, and a layer-stacked pool with the case's pool as layer
    1 of 3."""
    from repro_torch.kernels import api
    others = [spec.example_inputs(shape=dict(case.shape), seed=s)
              for s in (1, 2)]
    names = spec.arg_names[1:7]
    stacked = [torch.stack([torch.from_numpy(others[0][n]).cuda(), a,
                            torch.from_numpy(others[1][n]).cuda()])
               for n, a in zip(names, args[1:7])]
    errs = {}
    for form, pools, layer in (("flat", args[1:7], None),
                               ("stacked", stacked, 1)):
        kargs = [_cast(a, dtype) for a in [args[0], *pools, args[7], args[8]]]
        extra = () if layer is None else (layer,)
        got = api.run(spec.name, *kargs, *extra, backend="cuda")
        torch.cuda.synchronize()
        errs[form] = (got.float() - want.float()).abs().max().item()
    return errs


def _flash_case(spec, case, args, want, dtype):
    from repro_torch.kernels import api
    got = api.run(spec.name, *[a.to(dtype) for a in args], backend="cuda",
                  **case.kwargs)
    torch.cuda.synchronize()
    return {"kernel": (got.float() - want.float()).abs().max().item()}


def _ssd_case(spec, case, args, want, dtype):
    """y and the final state of the kernel against the plain version,
    through the route the case takes (fp32: simt)."""
    from repro_torch.kernels import api
    from repro_torch.kernels.ssd_scan.ssd_scan import route
    got = {}
    taken = route_taken("ssd_scan", lambda: got.setdefault(
        "out", api.run(spec.name, *args, backend="cuda")))
    B, S, H, P = args[0].shape
    expect = route(args[0].dtype, S, P, args[1].shape[3], args[1].shape[2])
    if taken != expect:
        raise AssertionError(f"ssd_scan {dict(case.shape)}: route {taken}, "
                             f"want {expect}")
    return {"route": taken, **{part: (g - w).abs().max().item()
                               for part, g, w in zip(("y", "state"),
                                                     got["out"], want)}}


def _rglru_case(spec, case, args, want, dtype):
    """The kernel against the plain version through the route the case
    takes (S up to one chunk: serial, else chunked)."""
    from repro_torch.kernels import api
    from repro_torch.kernels.rglru_scan.rglru_scan import route
    got = {}
    taken = route_taken("rglru_scan", lambda: got.setdefault(
        "out", api.run(spec.name, *args, backend="cuda")))
    if taken != route(args[0].shape[1]):
        raise AssertionError(f"rglru_scan {dict(case.shape)}: route {taken}")
    return {"route": taken, "h": (got["out"] - want).abs().max().item()}


def ssd_inputs(shape, dtype, seed):
    """The spec's generator (numpy, seeded) at a full-width shape: x, B
    and C in `dtype`, dt and a fp32, on the card."""
    from repro_torch.kernels.ssd_scan.spec import example_inputs
    inp = example_inputs(shape=shape, seed=seed)
    return [torch.from_numpy(v).cuda().to(dtype if n in ("x", "b_mat",
                                                         "c_mat")
                                          else torch.float32)
            for n, v in inp.items()]


def ssd_bytes_and_flops(args):
    """Bytes of x, B, C, dt, a, y and the final state, each once, and the
    operations the chunked form needs, by type: {peak rate: flops} — the
    spec's `work` (the causal half of each chunk of `ssd_scan.CHUNK`;
    C Bt on the tensor cores when B and C are bf16)."""
    w = work_of("ssd_scan", *args)
    return w["bytes"], {PEAKS[c]: f for c, f in w["flops"].items()}


def routes(kernel: str) -> dict:
    """A kernel wrapper's launch counts by route ("wgmma", "simt", ...)."""
    return dict(_counters()[kernel].launches_by_route)


def route_taken(kernel: str, fn) -> str:
    """Run `fn`, which must launch `kernel` once, and return the route
    whose count rose."""
    before = routes(kernel)
    fn()
    torch.cuda.synchronize()
    after = routes(kernel)
    taken = [r for r in after if after[r] != before[r]]
    if len(taken) != 1 or after[taken[0]] != before[taken[0]] + 1:
        raise AssertionError(f"{kernel} routes {before} -> {after}: want one "
                             f"launch")
    return taken[0]


FLASH_FAULTS = ("bf16_p", "drop_last_tile")


def flash_variant(q, k, v, *, causal=True, window=0, fault,
                  block_k: int = 128):
    """The plain version broken on purpose, to show that
    `same_input_limit` tells a right flash kernel from a wrong one:
    "bf16_p" rounds P to bf16 once before P V (the JAX model's
    `attention_core` form; l stays the fp32 sum), "drop_last_tile" leaves
    out the keys of the last `block_k`-key tile."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    if fault == "drop_last_tile":
        ok &= k_pos < (skv - 1) // block_k * block_k
    s = torch.where(ok, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    if fault == "bf16_p":
        p = p.to(torch.bfloat16).float()
    acc = torch.einsum("bhgqs,bshd->bhgqd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


# shapes the kernels take that no spec case has, each row seeing at least
# one key: sq != skv (causal, windowed), one position, batch > 1 at d = 256
FLASH_EDGE_CASES = (
    ({"b": 1, "sq": 1, "skv": 1, "hq": 2, "hkv": 1, "d": 64}, {}),
    ({"b": 2, "sq": 5, "skv": 300, "hq": 4, "hkv": 2, "d": 128}, {}),
    ({"b": 1, "sq": 300, "skv": 77, "hq": 9, "hkv": 1, "d": 128}, {}),
    ({"b": 3, "sq": 129, "skv": 129, "hq": 6, "hkv": 3, "d": 256},
     {"window": 64}),
    ({"b": 1, "sq": 200, "skv": 333, "hq": 2, "hkv": 2, "d": 64},
     {"causal": False, "window": 100}),
)


def flash_cases_bf16():
    """Every flash spec case cast to bf16, then `FLASH_EDGE_CASES`, through
    the route each takes (`route`: wgmma at d = 64, 128, 256, simt at
    d = 32), held to the plain version on the same bf16 inputs by
    `same_input_limit`."""
    from repro_torch.kernels import api, registry
    from repro_torch.kernels.flash_attention.flash_attention import route
    spec = registry.get("flash_attention")
    cases = [(dict(c.shape), dict(c.kwargs), [
        torch.from_numpy(v).cuda().to(torch.bfloat16)
        for v in spec.example_inputs(shape=dict(c.shape)).values()])
        for c in spec.cases]
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases += [(shape, kw, flash_inputs(gen, dtype=torch.bfloat16, **shape))
              for shape, kw in FLASH_EDGE_CASES]
    for i, (shape, kw, args) in enumerate(cases):
        got = {}
        taken = route_taken("flash_attention", lambda: got.setdefault(
            "out", api.run("flash_attention", *args,  # noqa: B023
                           backend="cuda", **kw)))  # noqa: B023
        want = api.run("flash_attention", *args, backend="ref", **kw)
        err, tol, over = ulp_check(got["out"], want)
        expect = route(torch.bfloat16, shape["d"])
        emit({"phase": "kernel", "kernel": "flash_attention",
              "case": i if i < len(spec.cases) else f"edge {i}",
              "dtype": "bfloat16", "shape": shape, "kwargs": kw,
              "route": taken, "max_abs_err": err, "tol": tol,
              "tol_rule": ULP_RULE, "max_err_over_limit": over})
        if taken != expect or not over <= 1.0:
            raise AssertionError(f"flash {shape} {kw} in bf16: route {taken} "
                                 f"(want {expect}), {over:.2f}x the limit")


def flash_broken_variants(q, k, v, label, **kw) -> dict:
    """Each `flash_variant` against the plain version on the same inputs:
    its error over `same_input_limit` must exceed 1."""
    from repro_torch.kernels import api
    want = api.run("flash_attention", q, k, v, backend="ref", **kw)
    out = {}
    for fault in FLASH_FAULTS:
        err, tol, over = ulp_check(flash_variant(q, k, v, fault=fault, **kw),
                                   want)
        out[fault] = over
        emit({"phase": "kernel", "case": f"{label} broken: {fault}",
              "kernel": "flash_attention", "fault": fault,
              "max_abs_err": err, "max_err_over_limit": over})
        if not over > 1.0:
            raise AssertionError(f"{label}: the {fault} variant passes the "
                                 f"limit ({over:.2f}x)")
    return out


def flash_before_after(q, k, v, label, pairs: int = 10, **kw) -> dict:
    """The redesign against the kernel it replaced, on one card: bf16
    inputs through the simt route (the first prefill slice's kernel,
    unchanged, which bf16 took before the wgmma route existed) and the
    wgmma route, `pairs` pairs of `device_ms`, alternating which runs
    first. Launched through the library directly, so no launch counts."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        LOG2E, _lib, fixed_tile
    lib = _lib()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    causal, window = int(kw.get("causal", True)), kw.get("window", 0)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, hq, hkv, d, causal, window)

    def simt():
        if lib.flash_attention_launch(
                *args, scale, 1, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("simt launch failed")

    def wgmma():
        if lib.flash_attention_wgmma_launch(
                *args, scale * LOG2E, *fixed_tile(d).values(),
                torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("wgmma launch failed")

    times = {"simt": [], "wgmma": []}
    for i in range(pairs):
        for name, fn in ((("simt", simt), ("wgmma", wgmma)) if i % 2 == 0
                         else (("wgmma", wgmma), ("simt", simt))):
            times[name].append(device_ms(fn, calls=5, reps=3))
    q1, q3 = np.percentile(times["simt"], [25, 75])
    row = {"phase": "kernel", "case": f"{label}: simt (before) vs wgmma",
           "kernel": "flash_attention", "pairs": pairs, "device_ms": times,
           "median_ms": {n: statistics.median(t) for n, t in times.items()},
           "simt_iqr_ms": q3 - q1,
           "wgmma_wins": sum(w < s for w, s in zip(times["wgmma"],
                                                   times["simt"]))}
    emit(row)
    return row


def flash_inputs(gen, *, b, sq, skv, hq, hkv, d, dtype):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def flash_bytes_and_flops(q, k, v, window: int = 0, causal: bool = True):
    """Bytes of q, k, v and out, each once; 4 d flops per (query, key) pair
    the mask lets through: with `causal` kp <= qp, with `window`
    kp > qp - window (queries and keys aligned at 0) — the spec's
    `work`."""
    w = work_of("flash_attention", q, k, v, causal=causal, window=window)
    return w["bytes"], sum(w["flops"].values())


def phase_kernel() -> dict:
    spec_cases("paged_attention", _paged_case)
    spec_cases("flash_attention", _flash_case)
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = {}
    full.update(paged_full_width(gen))
    paged_edge_cases()
    flash_cases_bf16()
    full.update(flash_full_width(gen))
    full.update(scan_kernels())
    torch.cuda.empty_cache()
    tile_sweeps(gen)
    torch.cuda.empty_cache()
    return full


# the launch each kernel took before its tile could be chosen (the
# wrappers' defaults: ``backend="cuda"`` with no tile)
def tile_sweep(label, kernel, args, kw=None, check=ulp_check,
               rule=ULP_RULE, broken=None) -> dict:
    """Every tile of `kernel`'s tune space at these inputs: a tile the
    spec's cost model calls unlaunchable must be refused before any
    launch; every other one is launched (``backend="cuda"``), held to the
    plain version by `check` (the phase's limit for the row) and timed by
    `device_ms`, beside the model's estimate. ``broken(tile, want)``
    gives the broken variants' error over the limit at that tile (None
    where a variant does not apply); each must exceed 1. Then the knee
    (`api.resolve_tile`, the model's choice), the fastest tile, the launch
    before tiles (``spec.fixed_tile``) and their ratios, and the rank
    correlation of estimate and measurement."""
    from repro_torch.core import autotune
    from repro_torch.kernels import api, registry
    kw = kw or {}
    spec = registry.get(kernel)
    grid = tuple(int(n) for n in spec.grid_of(*args))
    dtype = str(args[0].dtype).removeprefix("torch.")
    SWEPT.add((kernel, grid, dtype))
    want = api.run(kernel, *args, backend="ref", **kw)
    rows = []
    for tile, cost in autotune.space_costs(spec, grid, dtype):
        def fn(t=tile):
            return api.run(kernel, *args, backend="cuda", tile=t, **kw)
        if cost is None:
            try:
                fn()
            except ValueError:
                rows.append({"tile": tile, "launchable": False})
                continue
            raise AssertionError(f"{label}: {tile} launched, but the cost "
                                 f"model calls it unlaunchable")
        got = fn()
        torch.cuda.synchronize()
        err, _, over = check(got, want)
        del got
        if not over <= 1.0:
            raise AssertionError(f"{label} at {tile}: error {err}, {over:.2f}"
                                 f"x the limit ({rule})")
        row = {"tile": tile, "launchable": True, "smem": cost[0],
               "est_ms": cost[1] * 1e3, "max_err_over_limit": over}
        if broken is not None:
            faults = {f: v for f, v in broken(tile, want).items()
                      if v is not None}
            if any(not v > 1.0 for v in faults.values()):
                raise AssertionError(f"{label} at {tile}: a broken variant "
                                     f"passes the limit: {faults}")
            row["broken_over_limit"] = faults
        row["device_ms"] = device_ms(fn)
        rows.append(row)
    ok = [r for r in rows if r["launchable"]]
    knee = api.resolve_tile(kernel, args)
    fixed = spec.fixed_tile(grid)
    by_tile = {tuple(sorted(r["tile"].items())): r for r in ok}
    knee_row = by_tile[tuple(sorted(knee.items()))]
    fixed_row = by_tile[tuple(sorted(fixed.items()))]
    fastest = min(ok, key=lambda r: r["device_ms"])
    out = {"phase": "kernel", "case": f"{label}: tile sweep",
           "kernel": kernel, "grid": list(grid), "dtype": dtype,
           "tol_rule": rule, "tiles": rows, "knee": knee,
           "knee_ms": knee_row["device_ms"], "fastest": fastest["tile"],
           "fastest_ms": fastest["device_ms"],
           "knee_over_fastest": knee_row["device_ms"] / fastest["device_ms"],
           "fixed": fixed, "fixed_ms": fixed_row["device_ms"],
           "knee_over_fixed": knee_row["device_ms"] / fixed_row["device_ms"],
           "est_vs_ms_rank_corr": spearman(
               [r["est_ms"] for r in ok], [r["device_ms"] for r in ok])
           if len(ok) > 2 else None,
           "timing": "device_ms: 20 calls queued behind a sleep, median of "
                     "5"}
    emit(out)
    return out


# (kernel, grid, dtype) of every tile sweep, and every knee of the
# serving and prefill kernels that `api.resolve_tile` gave after the
# kernel phase (`keep_knees`); the stencils' knees are the stencil
# phase's, which sweeps every tile at the grid its main path runs
SWEPT: set = set()
MAIN_KNEES: dict = {}
AUDITED = ("paged_attention", "flash_attention", "ssd_scan", "rglru_scan")


def keep_knees():
    """From here on keep every knee `api.resolve_tile` gives a kernel of
    `AUDITED` in `MAIN_KNEES`, keyed as the knee cache keys it: the
    launch shapes the main path took at ``backend="auto"`` (the paged
    step's, once a step; each flash, SSD and RG-LRU call's)."""
    from repro_torch.kernels import api
    resolve = api.resolve_tile

    def kept(kernel, args):
        tile = resolve(kernel, args)
        spec = api.as_spec(kernel)
        if spec.name in AUDITED:
            MAIN_KNEES[(spec.name, tuple(int(n) for n in spec.grid_of(
                *args)), str(args[0].dtype).removeprefix("torch."))] = tile
        return tile
    api.resolve_tile = kept


def _grid_inputs(gen, kernel, grid, dtype) -> tuple:
    """(args, kw) of a call at a knee's grid, made on the card: paged
    attention with every sequence at the table's capacity (what the cost
    model sees), flash attention causal, the scans as the kernel phase
    makes them."""
    dt = DTYPES[dtype]
    if kernel == "paged_attention":
        b, t, slots, hq, hkv, d, k = grid
        args = decode_inputs(gen, b=b, hq=hq, hkv=hkv, d=d, t=t,
                             n_layers=1, lengths=[slots * t - k + 1] * b,
                             dead=[], q_dtype=dt, rows=k)
        return args + [0], {}
    if kernel == "flash_attention":
        b, sq, skv, hq, hkv, d = grid
        return flash_inputs(gen, b=b, sq=sq, skv=skv, hq=hq, hkv=hkv, d=d,
                            dtype=dt), {"causal": True}
    if kernel == "ssd_scan":
        return ssd_inputs(dict(zip(("B", "S", "H", "P", "G", "N"), grid)),
                          dt, seed=grid[1]), {}
    a = torch.rand(grid, generator=gen, device="cuda") * 0.149 + 0.85
    return [a, torch.randn(grid, generator=gen, device="cuda") * 0.1], {}


def knee_audit(smi: str) -> dict:
    """Every knee the main path resolved (`MAIN_KNEES`) beside the launch
    before tiles: a grid the kernel phase swept (`SWEPT`: every tile
    held and timed there); the launch before tiles; a route that reads
    no tile (the cost model flat in it); else the model's word only, and
    then the knee and the launch before tiles are both timed by
    `device_ms` on inputs made at that grid (`_grid_inputs`). These
    launches are not the main path's and count nowhere; the replays of
    the recorded launches held each main-path launch at its tile."""
    from repro_torch.core import autotune
    from repro_torch.kernels import api
    gen = torch.Generator(device="cuda").manual_seed(27)
    rows = []
    for (kernel, grid, dtype), knee in sorted(MAIN_KNEES.items(),
                                              key=lambda kv: str(kv[0])):
        fixed = api.as_spec(kernel).fixed_tile(grid)
        row = {"kernel": kernel, "grid": list(grid), "dtype": dtype,
               "knee": knee, "fixed": fixed, "confirmed_by": None}
        costs = {c[1] for _, c in autotune.space_costs(
            api.as_spec(kernel), grid, dtype) if c is not None}
        if (kernel, grid, dtype) in SWEPT:
            row["confirmed_by"] = "the kernel phase's sweep"
        elif len(costs) <= 1:
            row["confirmed_by"] = "a route that reads no tile"
        elif knee == fixed:
            row["confirmed_by"] = "the launch before tiles"
        else:
            args, kw = _grid_inputs(gen, kernel, grid, dtype)
            for name, tile in (("knee", knee), ("fixed", fixed)):
                row[f"{name}_ms"] = device_ms(
                    lambda t=tile: api.run(kernel, *args,  # noqa: B023
                                           backend="cuda", tile=t, **kw))
            row["knee_over_fixed"] = row["knee_ms"] / row["fixed_ms"]
            del args
        rows.append(row)
    torch.cuda.empty_cache()
    by: dict = {}
    for r in rows:
        key = r["confirmed_by"] or "the model's word only (timed here)"
        by[key] = by.get(key, 0) + 1
    out = {"phase": "knees", "nvidia_smi": smi,
           "resolved_on_the_main_path": len(rows), "by": by,
           "model_only": [r for r in rows if r["confirmed_by"] is None],
           "timing": "device_ms: 20 calls queued behind a sleep, median of "
                     "5", "rows": rows}
    emit(out)
    return out


def tile_sweeps(gen) -> list:
    """The tile sweep (`tile_sweep`) of each tunable serving and prefill
    kernel at shapes the phase already times: paged attention's split
    route in bf16 at starcoder2-7b's decode (k = 1 and the k = 4 verify,
    b = 4) and at a 2x2 plan's shard (b = 1, 18 / 2 heads, 121
    positions), the broken variant "drop_last_split" at each tile where
    a row's positions cross into a second split; flash attention in bf16
    at starcoder2-7b's s = 2048, 600 and 250 causal prefills,
    musicgen-medium's d = 64 prefill (b = 2, s = 600, 24 heads) and
    recurrentgemma-2b's windowed d = 256 prefill, "drop_last_tile" at each
    tile's key-tile size; the SSD scan's wgmma route at mamba2-780m's B =
    1, S = 2048 and B = 3, S = 1536 (`ssd_limit`; a chunk left out of the
    state pass and the scores in one piece at each chunk); the RG-LRU
    scan at B = 2, S = 2300 and B = 1, S = 2048, W = 2560 (2 ulps; the
    dropped carry at each chunk, and the kernel equal to
    `rglru_chunked_loop` at its chunk). The fp32 flash and paged rows
    take routes that read no tile."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        _sm_count, split_plan)
    out = []
    layer = 17
    for shape, rows in (
            (dict(b=4, hq=36, hkv=4, d=128, t=128, n_layers=32,
                  lengths=[2048, 700, 1, 1500], dead=[2]), 1),
            (dict(b=4, hq=36, hkv=4, d=128, t=128, n_layers=32,
                  lengths=[2048, 700, 1, 1500], dead=[2]), 4),
            (dict(b=1, hq=18, hkv=2, d=128, t=128, n_layers=2,
                  lengths=[121], dead=[]), 1)):
        args = decode_inputs(gen, q_dtype=torch.bfloat16, rows=rows, **shape)
        lay = layer if shape["n_layers"] > layer else 1
        full = list(args) + [lay]
        lens = args[8]
        span = args[7].shape[1] * shape["t"]

        def broken(tile, want, args=args, lay=lay, rows=rows, lens=lens,
                   span=span, shape=shape):
            splits, chunk = split_plan(
                shape["b"], shape["hkv"], span, shape["d"],
                _sm_count(args[0].device.index), page_tokens=shape["t"],
                pages_per_block=tile["pages_per_block"])
            applies = splits > 1 and int(lens.max()) + rows - 1 > chunk
            return {"drop_last_split": ulp_check(paged_variant(
                args, lay, rows, fault="drop_last_split",
                pages_per_block=tile["pages_per_block"]), want)[2]
                if applies else None}

        out.append(tile_sweep(
            f"paged_attention b={shape['b']} hq={shape['hq']} "
            f"hkv={shape['hkv']} k={rows} bfloat16", "paged_attention",
            full, broken=broken))
        del args, full
        torch.cuda.empty_cache()
    for (b, sq, hq, hkv, d), kw in (((1, 2048, 36, 4, 128), {}),
                                    ((1, 600, 36, 4, 128), {}),
                                    ((1, 250, 36, 4, 128), {}),
                                    ((2, 600, 24, 24, 64), {}),
                                    ((2, 2300, 10, 1, 256), {"window": 2048})):
        q, k, v = flash_inputs(gen, b=b, sq=sq, skv=sq, hq=hq, hkv=hkv, d=d,
                               dtype=torch.bfloat16)

        def broken(tile, want, q=q, k=k, v=v, kw=kw):
            return {"drop_last_tile": ulp_check(flash_variant(
                q, k, v, fault="drop_last_tile", block_k=tile["block_k"],
                **kw), want)[2]}

        out.append(tile_sweep(
            f"flash_attention b={b} s={sq} hq={hq} hkv={hkv} d={d}"
            f"{' window=' + str(kw['window']) if kw else ''} causal bfloat16",
            "flash_attention", [q, k, v], kw=kw, broken=broken))
        del q, k, v
        torch.cuda.empty_cache()
    mamba = dict(H=48, P=64, G=1, N=128)
    for b, s_len in ((1, 2048), (3, 1536)):
        args = ssd_inputs(dict(B=b, S=s_len, **mamba), torch.bfloat16,
                          seed=s_len)

        def broken(tile, want, args=args):
            return {fault: over_ssd_limit(ssd_wgmma_loop(
                *args, chunk=tile["chunk"], **extra), want)
                for fault, extra in (
                    ("skip_state_chunk", {"fault": "skip_state_chunk"}),
                    ("one_piece_scores", {"score_pieces": 1}))}

        out.append(tile_sweep(
            f"ssd_scan mamba2-780m B={b} S={s_len} bfloat16", "ssd_scan",
            args, check=ssd_check, rule=SSD_LIMIT_RULE, broken=broken))
        del args
        torch.cuda.empty_cache()
    for b, s_len in ((2, 2300), (1, 2048)):
        a = torch.rand(b, s_len, 2560, generator=gen, device="cuda") \
            * 0.149 + 0.85
        x = torch.randn(b, s_len, 2560, generator=gen, device="cuda") * 0.1

        def broken(tile, want, a=a, x=x):
            from repro_torch.kernels import api
            loop = rglru_chunked_loop(a, x, chunk=tile["chunk"])
            if not torch.equal(api.run("rglru_scan", a, x, backend="cuda",
                                       tile=tile), loop):
                raise AssertionError(f"rglru at {tile}: the kernel is not "
                                     f"the chunked loop at its chunk")
            return {"drop_carry": ulp_check(rglru_chunked_loop(
                a, x, chunk=tile["chunk"], fault="drop_carry"), want)[2]}

        out.append(tile_sweep(
            f"rglru_scan recurrentgemma-2b B={b} S={s_len} W=2560 float32",
            "rglru_scan", [a, x], broken=broken))
        del a, x
    return out


def paged_full_width(gen) -> dict:
    """Paged attention at the starcoder2-7b shapes of the main path (b=4,
    36 query heads over 4 kv heads, d=128, 128-token pages, 32 layers,
    mixed tiers, one dead row): one decode row, a k = 4 verify step (the
    split route) and a k = 128 chunk-fill step (1152 query rows per kv
    head: the wgmma route in bf16, simt in fp32). Each row checks its
    route and is timed by `device_ms` beside SDPA's; the wgmma row adds
    its bound at the bf16 peak and the products it issues. At k = 1 and
    k = 128 in bf16 the broken variants must fail the limit the kernel
    meets, and the simt route (the kernel before the redesign) and the
    new route run in 10 alternating pairs."""
    from repro_torch.kernels import api
    from repro_torch.kernels.paged_attention.paged_attention import route
    rows_out = {}
    shape = dict(b=4, hq=36, hkv=4, d=128, t=128, n_layers=32,
                 lengths=[2048, 700, 1, 1500], dead=[2])
    layer = 17
    for rows, dtypes in ((1, ("bfloat16", "float32")), (4, ("bfloat16",)),
                         (128, ("bfloat16", "float32"))):
        for name in dtypes:
            dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
            args = decode_inputs(gen, q_dtype=dtype, rows=rows, **shape)
            nbytes, flops = bytes_and_flops(args)

            def kernel():
                return api.run("paged_attention", *args, layer,  # noqa: B023
                               backend="cuda")

            taken = route_taken("paged_attention", kernel)
            if taken != route(dtype, rows * 9, 128):
                raise AssertionError(f"paged k={rows} {name}: route {taken}")
            extra = {"kernel": "paged_attention", "rows": rows, "dtype": name,
                     "route": taken, "shape": shape, "layer": layer,
                     "library": "scaled_dot_product_attention over K/V "
                                "gathered and dequantized beforehand "
                                "(omits gather and dequant)"}
            if taken == "wgmma":
                products, tc_flops = paged_tc_products(args, layer, rows)
                extra.update(
                    bound_ms_fp32_peak=max(nbytes / HBM_BYTES_PER_S,
                                           flops / FP32_FLOPS) * 1e3,
                    bound_ms_bf16_peak=max(nbytes / HBM_BYTES_PER_S,
                                           flops / BF16_FLOPS) * 1e3,
                    bf16_products=products,
                    bf16_products_per_tile=WGMMA_PRODUCTS,
                    bf16_product_flops=tc_flops,
                    bf16_product_ms_at_peak=tc_flops / BF16_FLOPS * 1e3)
            label = f"paged_attention starcoder2-7b k={rows} {name}"
            key = ("paged_attention", rows, name)
            rows_out[key] = compare_and_time(
                label, kernel,
                lambda: api.run("paged_attention", *args, layer,  # noqa
                                backend="ref"),
                sdpa_yardstick(args, layer, rows), nbytes, flops,
                FP32_FLOPS, extra, device=True)
            if name == "bfloat16" and rows in (1, 128):
                rows_out[key]["broken_over_limit"] = paged_broken_variants(
                    args, layer, rows, label)
                rows_out[key]["before_after"] = paged_before_after(
                    args, layer, rows, label)
            del args
            torch.cuda.empty_cache()
    return rows_out


def flash_full_width(gen) -> dict:
    """Flash attention at full width: starcoder2-7b's prefill (b=1, 36
    query heads over 4 kv heads, d=128; 600 is the serve phase's longest
    prompt), causal and not, and recurrentgemma-2b's local-attention
    prefill at the hybrid phase's `generate` batch (2 prompts padded to
    2300: MQA, 10 query heads, d=256, window 2048; SDPA takes the window
    as a boolean mask). Each row checks the route its launch took and is
    timed by `device_ms`; at s = 2048 the two broken variants must fail
    the limit the kernel meets."""
    from repro_torch.kernels import api
    from repro_torch.kernels.flash_attention.flash_attention import route
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    rows = {}
    shapes = [(2048, True, ("bfloat16", "float32")),
              (2048, False, ("bfloat16",)),
              (1000, True, ("bfloat16", "float32")),
              (1000, False, ("bfloat16",)),
              (600, True, ("bfloat16",)), (600, False, ("bfloat16",))]
    for sq, causal, names in shapes:
        for name in names:
            dtype = dtypes[name]
            q, k, v = flash_inputs(gen, b=1, sq=sq, skv=sq, hq=36, hkv=4,
                                   d=128, dtype=dtype)
            nbytes, flops = flash_bytes_and_flops(q, k, v, causal=causal)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

            def kernel():
                return api.run("flash_attention", q, k, v, causal=causal,
                               backend="cuda")

            taken = route_taken("flash_attention", kernel)
            if taken != route(dtype, 128):
                raise AssertionError(f"s={sq} {name}: route {taken}")
            label = (f"flash_attention starcoder2-7b prefill s={sq} "
                     f"{'causal' if causal else 'non-causal'} {name}")
            key = ("flash_attention", sq, name) + (() if causal
                                                   else ("non-causal",))
            rows[key] = compare_and_time(
                label, kernel,
                lambda: api.run("flash_attention", q, k, v,  # noqa
                                causal=causal, backend="ref"),
                lambda: F.scaled_dot_product_attention(  # noqa
                    qt, kt, vt, is_causal=causal, enable_gqa=True),
                nbytes, flops,
                BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS,
                {"kernel": "flash_attention", "dtype": name, "route": taken,
                 "shape": {"b": 1, "sq": sq, "skv": sq, "hq": 36, "hkv": 4,
                           "d": 128, "causal": causal},
                 "library": f"scaled_dot_product_attention(is_causal="
                            f"{causal}, enable_gqa=True) on (b, h, s, d) "
                            f"copies made beforehand"}, device=True)
            if sq == 2048 and causal and name == "bfloat16":
                rows[key]["broken_over_limit"] = flash_broken_variants(
                    q, k, v, label, causal=True)
                rows[key]["before_after"] = flash_before_after(
                    q, k, v, label, causal=True)
            del q, k, v, qt, kt, vt
    q, k, v = flash_inputs(gen, b=2, sq=2300, skv=2300, hq=10, hkv=1,
                           d=256, dtype=torch.bfloat16)
    nbytes, flops = flash_bytes_and_flops(q, k, v, window=2048)
    pos = torch.arange(2300, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - 2048)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def kernel():
        return api.run("flash_attention", q, k, v, causal=True, window=2048,
                       backend="cuda")

    taken = route_taken("flash_attention", kernel)
    if taken != "wgmma":
        raise AssertionError(f"recurrentgemma flash: route {taken}")
    rows[("flash_attention", "recurrentgemma", "bfloat16")] = \
        compare_and_time(
            "flash_attention recurrentgemma-2b prefill b=2 s=2300 "
            "window=2048 bfloat16", kernel,
            lambda: api.run("flash_attention", q, k, v, causal=True,
                            window=2048, backend="ref"),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            nbytes, flops, BF16_FLOPS,
            {"kernel": "flash_attention", "dtype": "bfloat16",
             "route": taken,
             "shape": {"b": 2, "sq": 2300, "skv": 2300, "hq": 10, "hkv": 1,
                       "d": 256, "causal": True, "window": 2048},
             "library": "scaled_dot_product_attention(attn_mask=causal "
                        "window mask, enable_gqa=True) on (b, h, s, d) "
                        "copies made beforehand"}, device=True)
    flash_before_after(q, k, v, "flash_attention recurrentgemma-2b prefill "
                       "b=2 s=2300 window=2048 bfloat16", causal=True,
                       window=2048)
    return rows


# shapes of the SSD scan's wgmma route that mamba2's prefill does not show:
# S shorter than a chunk, one position, G = 2, N = 64, a chunk and one
# position, B = 3 with a ragged last chunk
SSD_EDGE_CASES = (
    {"B": 1, "S": 50, "H": 4, "P": 64, "G": 1, "N": 128},
    {"B": 1, "S": 1, "H": 4, "P": 64, "G": 1, "N": 128},
    {"B": 2, "S": 300, "H": 6, "P": 64, "G": 2, "N": 128},
    {"B": 2, "S": 129, "H": 4, "P": 64, "G": 1, "N": 64},
    {"B": 3, "S": 1000, "H": 8, "P": 64, "G": 2, "N": 64},
)
# shapes of the RG-LRU scan's chunked route (B, S, W): one position past
# whole chunks (65, 129), W not a multiple of the block, B = 3 ragged
RGLRU_EDGE_CASES = ((1, 65, 100), (3, 1000, 130), (2, 129, 2560))


def ssd_edge_cases():
    """`SSD_EDGE_CASES` in bf16 through the wgmma route, held to the plain
    version on the same inputs by `ssd_limit`."""
    from repro_torch.kernels import api
    for i, shape in enumerate(SSD_EDGE_CASES):
        args = ssd_inputs(shape, torch.bfloat16, seed=100 + i)
        got = {}
        taken = route_taken("ssd_scan", lambda: got.setdefault(  # noqa: B023
            "out", api.run("ssd_scan", *args, backend="cuda")))  # noqa: B023
        err, tol, over = ssd_check(got["out"], api.run("ssd_scan", *args,
                                                      backend="ref"))
        emit({"phase": "kernel", "kernel": "ssd_scan", "case": f"edge {i}",
              "dtype": "bfloat16", "shape": shape, "route": taken,
              "max_abs_err": err, "tol": tol, "tol_rule": SSD_LIMIT_RULE,
              "max_err_over_limit": over})
        if taken != "wgmma" or not over <= 1.0:
            raise AssertionError(f"ssd {shape} in bf16: route {taken}, "
                                 f"{over:.3f}x the limit")


def rglru_edge_cases(gen):
    """`RGLRU_EDGE_CASES` through the chunked route, held to the plain
    version by `same_input_limit`."""
    from repro_torch.kernels import api
    for b, s_len, w in RGLRU_EDGE_CASES:
        a = torch.rand(b, s_len, w, generator=gen, device="cuda") * 0.149 \
            + 0.85
        x = torch.randn(b, s_len, w, generator=gen, device="cuda") * 0.1
        got = {}
        taken = route_taken("rglru_scan", lambda: got.setdefault(  # noqa
            "out", api.run("rglru_scan", a, x, backend="cuda")))  # noqa
        err, tol, over = ulp_check(got["out"],
                                   api.run("rglru_scan", a, x, backend="ref"))
        emit({"phase": "kernel", "kernel": "rglru_scan",
              "case": f"edge B={b} S={s_len} W={w}", "route": taken,
              "max_abs_err": err, "tol": tol, "tol_rule": ULP_RULE,
              "max_err_over_limit": over})
        if taken != "chunked" or not over <= 1.0:
            raise AssertionError(f"rglru B={b} S={s_len} W={w}: route "
                                 f"{taken}, {over:.3f}x the limit")


def ssd_wgmma_products(args) -> dict:
    """The tensor-core work the SSD scan's wgmma route issues at these
    shapes, pieces included: its wgmma instructions (one m64 x n x k16
    bf16 product of a warpgroup each) and their flops; chunk states (w .
    x)^T B, C B^T, C . h_prev^T (chunks after the first) and s . x (the
    k-steps up to each warpgroup's last row)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import WGMMA_CHUNK, \
        WGMMA_PIECES
    q, k = WGMMA_CHUNK, WGMMA_PIECES
    B, S, H, P = args[0].shape
    N = args[1].shape[3]
    nc = -(-S // q)
    wgs = q // 64
    intra = sum(min(q // 16, (64 * wg + 63) // 16 + 1) for wg in range(wgs))
    per = {"chunk_states": (q // 16 * k, 2 * 64 * N * 16),
           "c_bt": (wgs * N // 16, 2 * 64 * q * 16),
           "c_h_prev": (wgs * k * N // 16, 2 * 64 * 64 * 16),
           "s_x": (intra * k, 2 * 64 * 64 * 16)}
    count = {name: B * H * (nc - 1 if name == "c_h_prev" else nc) * n
             for name, (n, _) in per.items()}
    flops = sum(count[name] * f for name, (_, f) in per.items())
    return {"wgmma_instructions": count, "flops": flops,
            "ms_at_bf16_peak": flops / BF16_FLOPS * 1e3,
            "chunk_state_bytes": B * nc * H * P * N * 4}


def scan_before_after(kernel, old, new, launch, label,
                      pairs: int = 10, phase: str = "kernel") -> dict:
    """The redesign against the kernel it replaced, on one card and the
    same inputs: `launch(route)` (the wrapper's `launch`, which counts
    nothing) through route `old` (the first port, unchanged) and route
    `new`, `pairs` pairs of `device_ms`, alternating which runs first."""
    times = {old: [], new: []}
    for i in range(pairs):
        for name in ((old, new) if i % 2 == 0 else (new, old)):
            times[name].append(device_ms(lambda: launch(name),  # noqa: B023
                                         calls=5, reps=3))
    q1, q3 = np.percentile(times[old], [25, 75])
    row = {"phase": phase, "case": f"{label}: {old} (before) vs {new}",
           "kernel": kernel, "pairs": pairs, "device_ms": times,
           "median_ms": {n: statistics.median(t) for n, t in times.items()},
           f"{old}_iqr_ms": q3 - q1,
           f"{new}_wins": sum(w < s for w, s in zip(times[new], times[old]))}
    emit(row)
    return row


def ssd_broken_variants(args, want, label) -> dict:
    """Plain loops broken on purpose against the plain version: the simt
    route's 64-chunk loop without chunk 1's inter-chunk term or without
    the ragged last chunk (`ssd_chunk_loop`), and the wgmma route's
    arithmetic (`ssd_wgmma_loop`) with the scores or w . x in one bf16
    piece or chunk 1's state left out of the state pass: each must exceed
    `ssd_limit`. h_prev in one piece is recorded beside them (the limit
    does not reject it at these shapes; the route keeps two pieces for
    the margin), as are both correct loops, which must meet it."""
    out = {fault: over_ssd_limit(ssd_chunk_loop(*args, fault=fault), want)
           for fault in ("drop_inter", "skip_ragged")}
    out["skip_state_chunk"] = over_ssd_limit(
        ssd_wgmma_loop(*args, fault="skip_state_chunk"), want)
    out["one_piece_scores"] = over_ssd_limit(
        ssd_wgmma_loop(*args, score_pieces=1), want)
    out["one_piece_wx"] = over_ssd_limit(
        ssd_wgmma_loop(*args, wx_pieces=1), want)
    kept = {"one_piece_state": over_ssd_limit(
        ssd_wgmma_loop(*args, fault="one_piece_state"), want),
        "chunk_loop": over_ssd_limit(ssd_chunk_loop(*args), want),
        "wgmma_loop": over_ssd_limit(ssd_wgmma_loop(*args), want)}
    emit({"phase": "kernel", "case": label, "kernel": "ssd_scan",
          "broken_over_limit": out, "recorded_over_limit": kept})
    if not (min(out.values()) > 1.0 >= max(kept["chunk_loop"],
                                           kept["wgmma_loop"])):
        raise AssertionError(f"ssd_limit does not separate broken from "
                             f"correct: {out}, {kept}")
    return {**out, **kept}


def scan_kernels() -> dict:
    """The SSD and RG-LRU scans: spec cases through the route each takes,
    the new routes' edge shapes, then full width against the plain
    versions, each row checking its route and timed by `device_ms` (SSD:
    `ssd_limit`, which the broken loops must exceed; RG-LRU: 2 ulps, which
    the chunked loop with a dropped carry must exceed), and the first
    port's kernel against the new route in 10 alternating pairs at the
    generate prefills' shapes."""
    from repro_torch.kernels import api
    from repro_torch.kernels.rglru_scan import rglru_scan as rg
    from repro_torch.kernels.ssd_scan import ssd_scan as sd
    spec_cases("ssd_scan", _ssd_case)
    spec_cases("rglru_scan", _rglru_case)
    ssd_edge_cases()
    full = {}
    mamba = dict(H=48, P=64, G=1, N=128)
    for (b, s_len), dtypes in (((1, 2048), ("bfloat16", "float32")),
                               ((1, 1000), ("bfloat16",)),
                               ((3, 1536), ("bfloat16",))):
        for name in dtypes:
            dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
            shape = dict(B=b, S=s_len, **mamba)
            args = ssd_inputs(shape, dtype, seed=s_len)
            nbytes, by_rate = ssd_bytes_and_flops(args)
            # one rate that gives the mix's time: flops / rate
            flops = sum(by_rate.values())
            rate = flops / sum(n / r for r, n in by_rate.items())

            def kernel():
                return api.run("ssd_scan", *args, backend="cuda")  # noqa

            taken = route_taken("ssd_scan", kernel)
            if taken != sd.route(dtype, s_len, 64, 128, 1):
                raise AssertionError(f"ssd B={b} S={s_len} {name}: route "
                                     f"{taken}")
            extra = {"kernel": "ssd_scan", "dtype": name, "shape": shape,
                     "route": taken,
                     "flops_by_peak": {f"{r:.3g}": n
                                       for r, n in by_rate.items()},
                     "bound_ms_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "library": "none: no single PyTorch call computes the "
                                "SSD scan"}
            if taken == "wgmma":
                extra["wgmma"] = ssd_wgmma_products(args)
            label = f"ssd_scan mamba2-780m B={b} S={s_len} {name}"
            row = compare_and_time(
                label, kernel,
                lambda: api.run("ssd_scan", *args, backend="ref"),  # noqa
                None, nbytes, flops, rate, extra, check=ssd_check,
                rule=SSD_LIMIT_RULE, device=True)
            if s_len == 1000:
                want = api.run("ssd_scan", *args, backend="ref")
                row["broken_over_limit"] = ssd_broken_variants(
                    args, want, label)
                del want
            if (b, s_len, name) == (3, 1536, "bfloat16"):
                B, S, H, P = args[0].shape
                y = torch.empty(B, S, H, P, device="cuda")
                st = torch.empty(B, H, P, 128, device="cuda")
                scratch = sd.wgmma_scratch(B, S, H, 128, "cuda")
                row["before_after"] = scan_before_after(
                    "ssd_scan", "simt", "wgmma",
                    lambda r: sd.launch(*args, y, st, r,  # noqa: B023
                                        scratch=scratch), label)
                del y, st, scratch
            full[("ssd_scan", b, s_len, name)] = row
            del args
            torch.cuda.empty_cache()
    ssd_bf16_intra_checks(mamba)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rglru_edge_cases(gen)
    for b, s_len in ((1, 2048), (1, 1000), (2, 2300)):
        a = torch.rand(b, s_len, 2560, generator=gen, device="cuda") \
            * 0.149 + 0.85
        x = torch.randn(b, s_len, 2560, generator=gen, device="cuda") * 0.1

        def kernel():
            return api.run("rglru_scan", a, x, backend="cuda")  # noqa

        taken = route_taken("rglru_scan", kernel)
        if taken != rg.route(s_len):
            raise AssertionError(f"rglru S={s_len}: route {taken}")
        label = f"rglru_scan recurrentgemma-2b B={b} S={s_len} W=2560 float32"
        row = compare_and_time(
            label, kernel,
            lambda: api.run("rglru_scan", a, x, backend="ref"),  # noqa
            None, *rglru_bytes_and_flops(a, x), FP32_FLOPS,
            {"kernel": "rglru_scan", "dtype": "float32", "route": taken,
             "chunk": rg.CHUNK, "shape": {"B": b, "S": s_len, "W": 2560},
             "library": "none: no single PyTorch call computes the linear "
                        "recurrence"}, device=True)
        if (b, s_len) == (2, 2300):
            want = api.run("rglru_scan", a, x, backend="ref")
            loop = rglru_chunked_loop(a, x)
            # the kernel takes the loop's operations in the loop's order
            row["kernel_equals_chunked_loop"] = torch.equal(kernel(), loop)
            row["chunked_loop_over_limit"] = ulp_check(loop, want)[2]
            del loop
            row["broken_over_limit"] = {
                fault: ulp_check(rglru_chunked_loop(a, x, fault=fault),
                                 want)[2] for fault in RGLRU_FAULTS}
            emit({"phase": "kernel", "case": label, "kernel": "rglru_scan",
                  "broken_over_limit": row["broken_over_limit"],
                  "chunked_loop_over_limit": row["chunked_loop_over_limit"],
                  "kernel_equals_chunked_loop":
                      row["kernel_equals_chunked_loop"]})
            if not (min(row["broken_over_limit"].values()) > 1.0
                    >= row["chunked_loop_over_limit"]) \
                    or not row["kernel_equals_chunked_loop"]:
                raise AssertionError(f"the 2-ulp limit does not separate "
                                     f"broken from correct: {row}")
            h = torch.empty_like(a)
            row["before_after"] = scan_before_after(
                "rglru_scan", "serial", "chunked",
                lambda r: rg.launch(a, x, h, r), label)  # noqa: B023
            del want, h
        full[("rglru_scan", b, s_len, "float32")] = row
        del a, x
    return full


# ---------------------------------------------------------------------------
# 3. exactness at full width
# ---------------------------------------------------------------------------
class EveryOtherSlow:
    """Placement policy: every other page goes to the slow (int8) tier."""

    def __init__(self):
        self.n = 0

    def place(self, feats):
        self.n += 1
        return "slow" if self.n % 2 == 0 else "fast"


def _requests(vocab, lengths, new, seed):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, vocab, n).astype(np.int32), m)
            for n, m in zip(lengths, new)]


def _shared_prefix_requests(vocab, prefix, suffixes, new, seed):
    """Requests whose prompts share one `prefix`-token head."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, prefix).astype(np.int32)
    return [Request(np.concatenate([head, rng.integers(0, vocab, n)
                                    .astype(np.int32)]), new)
            for n in suffixes]


def _tokens(outs):
    return [None if o is None else o.tolist() for o in outs]


def phase_exact() -> dict:
    """Kernel and plain paths give identical greedy tokens at full width
    (2 layers, fp32) on every path the serving code has: the monolithic
    prefill (flash kernel) of `generate` and of ``serve(chunked_prefill=
    False)``, the default chunked + radix `serve` (k = page_tokens chunk
    fills, adopted prefixes) and a k = 4 speculative `serve`."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    cfg = get_config("starcoder2-7b", num_layers=2, param_dtype="float32",
                     compute_dtype="float32")
    lengths, new = [70, 130, 200, 257], [9, 12, 15, 18]
    v = cfg.vocab_size
    outs = {}
    for backend in ("auto", "ref"):
        def engine(speculate=0):
            return ServeEngine(cfg, seed=0, backend=backend,
                               speculate=speculate, kv_pool=PagedKVPool(
                                   page_tokens=64,
                                   placement_policy=EveryOtherSlow()))
        eng = engine()
        got = {"generate": _tokens(eng.generate(
            _requests(v, lengths, new, 0), free_pages=True))}
        got["serve_monolithic"] = _tokens(eng.serve(
            _requests(v, lengths, new, 1), max_active=2,
            chunked_prefill=False, radix=False))
        got["serve_chunked_radix"] = _tokens(eng.serve(
            _shared_prefix_requests(v, 150, [20, 90, 45, 130], 10, 2),
            max_active=2))
        got["prefix_hit_rate"] = eng.last_prefix_hit_rate
        if eng.kv_pool.live_pages:
            raise AssertionError("pages left in the pool")
        del eng
        eng = engine(speculate=4)
        got["serve_speculative_k4"] = _tokens(eng.serve(
            _requests(v, lengths, new, 3), max_active=2))
        got["spec_stats"] = eng.last_request_stats
        if eng.kv_pool.live_pages:
            raise AssertionError("pages left in the pool")
        outs[backend] = got
        del eng
        torch.cuda.empty_cache()
    paths = ("generate", "serve_monolithic", "serve_chunked_radix",
             "serve_speculative_k4")
    same = {p: outs["auto"][p] == outs["ref"][p] for p in paths}
    row = {"phase": "exact", "config": "starcoder2-7b full width, 2 layers, "
           "fp32", "page_tokens": 64, "prompt_lengths": lengths,
           "max_new": new, "identical_tokens": same,
           "prefix_hit_rate": outs["auto"]["prefix_hit_rate"],
           "spec_accept_rates": [d["accept_rate"] for d in
                                 outs["auto"]["spec_stats"]],
           **{p: outs["auto"][p] for p in paths}}
    emit(row)
    if not all(same.values()) or not outs["auto"]["prefix_hit_rate"]:
        raise AssertionError(f"kernel and plain tokens differ, or no prefix "
                             f"was adopted: {same}, {outs}")
    return row, exact_modes(cfg), exact_preempt(cfg), exact_hybrid(), \
        exact_hybrid_swap()


def exact_modes(cfg) -> dict:
    """The reference's three decode modes at the phase's depth, fp32:
    ``eager`` (each layer's rows back to the host, then into the device
    pool; its kernel launched alone) and ``numpy`` (the pool assembled on
    the host each step and uploaded for the call) give the ``fused``
    step's greedy tokens for `generate` and for continuous `serve()` (one
    prefill pass per prompt, the radix cache's pins on: the non-fused
    modes' default); each decode step of every mode launches the paged
    kernel once a layer (never its plain version); each mode's transfer
    counts are printed."""
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    lengths, new = [70, 130, 200, 257], [9, 12, 15, 18]
    v = cfg.vocab_size
    outs, transfers, launches = {}, {}, {}
    for mode in ("fused", "eager", "numpy"):
        eng = ServeEngine(cfg, seed=0, decode_mode=mode, kv_pool=PagedKVPool(
            page_tokens=64, placement_policy=EveryOtherSlow()))
        reset_launches()
        plain0 = paged_attention.plain_calls
        got = {"generate": _tokens(eng.generate(
            _requests(v, lengths, new, 0), free_pages=True))}
        transfers[mode] = {"generate": list(eng.last_transfers)}
        steps = eng.stats["decode_steps"]
        got["serve"] = _tokens(eng.serve(
            _requests(v, lengths, new, 1), max_active=2,
            chunked_prefill=False))
        transfers[mode]["serve"] = list(eng.last_transfers)
        steps = eng.stats["decode_steps"]
        launches[mode] = {"paged_attention": paged_attention.launches,
                          "decode_steps": steps,
                          "by_route": routes("paged_attention")}
        if paged_attention.plain_calls != plain0 or \
                paged_attention.launches != steps * cfg.num_layers:
            raise AssertionError(f"{mode}: {paged_attention.launches} paged "
                                 f"launches for {steps} steps, plain calls "
                                 f"{paged_attention.plain_calls - plain0}")
        if eng.kv_pool.live_pages:
            raise AssertionError(f"{mode}: pages left in the pool")
        outs[mode] = got
        del eng
        torch.cuda.empty_cache()
    same = {m: outs[m] == outs["fused"] for m in ("eager", "numpy")}
    row = {"phase": "exact", "case": "decode modes",
           "config": f"{cfg.name} full width, {cfg.num_layers} layers, fp32",
           "page_tokens": 64, "prompt_lengths": lengths, "max_new": new,
           "identical_to_fused": same, "transfers": transfers,
           "launches": launches, **outs["fused"]}
    emit(row)
    if not all(same.values()):
        raise AssertionError(f"decode modes disagree with fused: {same}, "
                             f"{outs}")
    return row


def _session_run(eng, reqs, *, park, max_active=2, speculate=None):
    """Drive a `ServeSession` to its end. ``park`` maps a request index to
    the condition on its row (``"chunk"``: still streaming prompt chunks,
    ``"decode"``: decoding, at least 3 tokens out) under which it is
    preempted once; the admission loop resumes it. Returns the tokens and
    the session's preempt / resume counts."""
    from repro_torch.serve.engine import ServeSession
    cap = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    ses = ServeSession(eng, capacity=cap, max_active=max_active,
                       speculate=speculate)
    for r in reqs:
        if not ses.submit(r):
            raise AssertionError(f"rejected: {ses.request_stats(r)}")
    todo = dict(park)
    while not ses.done:
        ses.step()
        for i, when in list(todo.items()):
            act = ses._recs[id(reqs[i])].active
            if act is None:
                continue
            if (when == "chunk" and act.prefilling) or \
                    (when == "decode" and len(act.outs) >= 3):
                if not ses.preempt(reqs[i]):
                    raise AssertionError(f"request {i} did not park")
                del todo[i]
    if todo:
        raise AssertionError(f"never reached the park point: {todo}")
    ses.close()
    if eng.kv_pool.live_pages:
        raise AssertionError("pages left in the pool")
    return {"tokens": [ses.result(r).tolist() for r in reqs],
            "preemptions": ses.preemptions, "resumes": ses.resumes,
            "swap_out_bytes": eng.kv_pool.stats["swap_out_bytes"]}


def exact_preempt(cfg) -> dict:
    """Preempt / resume at full width, fp32 (2 layers): a `ServeSession`
    with one request parked mid chunk fill and one mid decode, and a k = 4
    speculative row parked mid decode, each resumed by the admission loop.
    Greedy tokens equal the never-preempted session's, with the kernels
    and with the plain versions (and kernel equals plain)."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    v = cfg.vocab_size
    cases = {"chunk_and_decode": ({0: "chunk", 1: "decode"}, 0,
                                  [200, 70], [12, 14]),
             "speculative_k4": ({0: "decode"}, 4, [130], [20])}
    out = {}
    for backend in ("auto", "ref"):
        for name, (park, k, lengths, new) in cases.items():
            for parked in (False, True):
                eng = ServeEngine(cfg, seed=0, backend=backend, speculate=k,
                                  kv_pool=PagedKVPool(
                                      page_tokens=64,
                                      placement_policy=EveryOtherSlow()))
                out[(backend, name, parked)] = _session_run(
                    eng, _requests(v, lengths, new, 7),
                    park=park if parked else {}, speculate=k or None)
                del eng
                torch.cuda.empty_cache()
    same = {f"{name} {backend}": out[(backend, name, True)]["tokens"]
            == out[(backend, name, False)]["tokens"]
            for backend in ("auto", "ref") for name in cases}
    same.update({f"{name} kernel vs plain": out[("auto", name, True)]
                 ["tokens"] == out[("ref", name, True)]["tokens"]
                 for name in cases})
    row = {"phase": "exact", "config": "starcoder2-7b full width, 2 layers, "
           "fp32", "path": "ServeSession preempt / resume (host tier)",
           "page_tokens": 64, "identical_tokens": same,
           **{name: {k: out[("auto", name, True)][k] for k in
                     ("tokens", "preemptions", "resumes", "swap_out_bytes")}
              for name in cases}}
    emit(row)
    parks = all(out[("auto", n, True)]["preemptions"] == len(cases[n][0])
                == out[("auto", n, True)]["resumes"] for n in cases)
    if not all(same.values()) or not parks:
        raise AssertionError(f"preempted tokens differ from the "
                             f"never-preempted run's: {same}, {out}")
    return row


def exact_hybrid_swap() -> list:
    """The reference's ``test_swap_out_in_bit_identical`` protocol at full
    width, fp32: mamba2-780m (2 SSD layers) and recurrentgemma-2b (3
    layers: RG-LRU, RG-LRU, local attention) prefill one 200-token prompt,
    decode 12 steps and park the sequence at step 6 — its recurrent slot
    read back whole, its ring pages to the host tier, its tail rows read
    back — while another sequence takes the freed slots; the resumed
    stream equals the uninterrupted one, with the kernels and with the
    plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.paged_decode import (PagedKVState,
                                                build_fused_step,
                                                extract_prefill_pages)
    from repro_torch.serve.paged_state import StateLayout
    from repro_torch.models import Model
    rows = []
    for arch, layers in (("mamba2-780m", 2), ("recurrentgemma-2b", 3)):
        cfg = get_config(arch, num_layers=layers, param_dtype="float32",
                         compute_dtype="float32")
        lay = StateLayout(cfg, 64)
        model = Model(cfg, device="cuda", seed=0)
        prompt = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (1, 200)).astype(np.int32)).cuda()
        out = {}
        for backend in ("auto", "ref"):
            for swap_at in (None, 6):
                pool = PagedKVPool(page_tokens=64,
                                   placement_policy=EveryOtherSlow())
                state = PagedKVState(pool, 256, lay, cfg.num_kv_heads,
                                     cfg.head_dim, device="cuda")
                logits, caches = model.forward_prefill(prompt,
                                                       backend=backend)
                extract_prefill_pages(model, caches, state, [0])
                del caches
                step = build_fused_step(model, state.slots, layout=lay,
                                        backend=backend)
                tok = torch.argmax(logits, -1).to(torch.int32)
                toks, parked = [int(tok[0])], {}
                for s in range(12):
                    if s == swap_at:
                        parked["out_bytes"] = state.swap_out(0)
                        parked["host_pages"] = pool.host_pages
                        state._ensure_rec_slot(99)   # takes the freed slots
                        if lay.n_kv:
                            state._ensure_tail_slot(99)
                        parked["in_bytes"] = state.swap_in(0)
                        tok = torch.tensor([toks[-1]], dtype=torch.int32,
                                           device="cuda")
                    _, tok = state.run_fused(step, tok, [0], 200 + s)
                    toks.append(int(tok[0]))
                for seq in (0, 99):
                    state.free_seq(seq)
                if pool.live_pages:
                    raise AssertionError(f"{arch}: pages left")
                out[(backend, swap_at)] = (toks, parked)
        same = {b: out[(b, 6)][0] == out[(b, None)][0]
                for b in ("auto", "ref")}
        same["kernel vs plain"] = out[("auto", 6)][0] == out[("ref", 6)][0]
        parked = out[("auto", 6)][1]
        row = {"phase": "exact", "config": f"{arch} full width, {layers} "
               "layers, fp32", "path": "PagedKVState swap_out / swap_in "
               "at decode step 6 of 12", "prompt": 200, "page_tokens": 64,
               "identical_tokens": same, "tokens": out[("auto", 6)][0],
               **parked}
        emit(row)
        if not all(same.values()) or not parked["out_bytes"] or \
                (lay.n_kv and not parked["host_pages"]):
            raise AssertionError(f"{arch}: swapped run differs or nothing "
                                 f"moved: {same}, {parked}")
        rows.append(row)
        del model
        torch.cuda.empty_cache()
    return rows


def exact_hybrid() -> list:
    """The hybrid stacks at full width, fp32: mamba2-780m with 2 SSD
    layers, recurrentgemma-2b with 3 (RG-LRU, RG-LRU, local attention).
    Kernel and plain paths give identical greedy tokens for `generate`
    (prefill through the SSD / RG-LRU scans and windowed flash
    attention), the default `serve` (chunked prefill through the
    one-token cores) and k = 4 speculative `serve`."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    lengths, new = [70, 130, 200, 257], [9, 12, 15, 18]
    paths = ("generate", "serve", "serve_speculative_k4")
    rows = []
    for arch, layers in (("mamba2-780m", 2), ("recurrentgemma-2b", 3)):
        cfg = get_config(arch, num_layers=layers, param_dtype="float32",
                         compute_dtype="float32")
        v = cfg.vocab_size
        outs = {}
        for backend in ("auto", "ref"):
            got = {}
            for path in paths:
                eng = ServeEngine(
                    cfg, seed=0, backend=backend,
                    speculate=4 if path == "serve_speculative_k4" else 0,
                    kv_pool=PagedKVPool(page_tokens=64,
                                        placement_policy=EveryOtherSlow()))
                reqs = _requests(v, lengths, new, paths.index(path))
                got[path] = _tokens(
                    eng.generate(reqs, free_pages=True)
                    if path == "generate" else eng.serve(reqs, max_active=2))
                if eng.kv_pool.live_pages:
                    raise AssertionError(f"{arch} {path}: pages left")
                del eng
                torch.cuda.empty_cache()
            outs[backend] = got
        same = {p: outs["auto"][p] == outs["ref"][p] for p in paths}
        row = {"phase": "exact", "config": f"{arch} full width, {layers} "
               f"layers, fp32", "page_tokens": 64, "prompt_lengths": lengths,
               "max_new": new, "identical_tokens": same,
               **{p: outs["auto"][p] for p in paths}}
        emit(row)
        if not all(same.values()):
            raise AssertionError(f"{arch}: kernel and plain tokens differ: "
                                 f"{same}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# 4. the main path at full size
# ---------------------------------------------------------------------------
# the serve phase's depth, which the chunked, spec, overload, sibyl and
# mesh phases share: at all 32 layers an every-phase run took 1,030-1,200
# s of its 1,200 s limit, host launches (2,452 kernels a decode step) most
# of it
SERVE_LAYERS = 16
SERVE_CONFIG = f"starcoder2-7b, {SERVE_LAYERS} of 32 layers, bf16"


def _counters():
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro_torch.kernels.hdiff.hdiff import hdiff
    from repro_torch.kernels.vadvc.vadvc import vadvc
    return {"paged_attention": paged_attention,
            "flash_attention": flash_attention,
            "ssd_scan": ssd_scan, "rglru_scan": rglru_scan,
            "hdiff": hdiff, "vadvc": vadvc}


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_serve() -> dict:
    """The first slice's workload through the monolithic-prefill path (kept
    so its numbers stay comparable): every prompt
    prefills in one pass through the flash-attention kernel, then decodes
    through the paged-attention kernel."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.steps import prefill_all_positions
    cfg = get_config("starcoder2-7b", num_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, seed=0, kv_pool=PagedKVPool(
        page_tokens=128, placement_policy=EveryOtherSlow()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lengths, new = [120, 250, 380, 500, 600], [32] * 5
    reqs = _requests(cfg.vocab_size, lengths, new, 2)
    steps0 = eng.stats["decode_steps"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve(reqs, max_active=2, chunked_prefill=False, radix=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    steps = eng.stats["decode_steps"] - steps0
    for o in outs:
        if o is None or len(o) != 32 or not ((0 <= o) & (o < cfg.vocab_size)).all():
            raise AssertionError(f"bad output {o}")
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
    if launches["paged_attention"] != steps * cfg.num_layers:
        raise AssertionError(f"{launches} launches for {steps} steps")
    if launches["flash_attention"] != len(reqs) * cfg.num_layers:
        raise AssertionError(f"{launches} launches for {len(reqs)} prefills")
    flash = routes("flash_attention")
    if flash != {"wgmma": launches["flash_attention"], "simt": 0}:
        raise AssertionError(f"flash launches by route {flash}: the bf16 "
                             f"prefill must take the wgmma route")
    paged = routes("paged_attention")
    if paged != {"split": launches["paged_attention"], "wgmma": 0,
                 "simt": 0}:
        raise AssertionError(f"paged launches by route {paged}: decode must "
                             f"take the split route")
    steady = eng.last_steady_transfers
    if not steady or any(s != (1, 1) for s in steady):
        raise AssertionError(f"steady-state transfers {steady}")
    decode_tokens = eng.stats["tokens"] - len(reqs)
    # prefill of each prompt with the flash kernel and with the plain
    # version (the materialized fp32 softmax the prefill ran before the
    # kernel), in alternation, synchronized
    ab = {"kernel": [], "plain": []}
    for r in reqs:
        toks = torch.from_numpy(r.prompt[None]).cuda()
        for _ in range(2):
            for name, backend in (("kernel", "auto"), ("plain", "ref")):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                prefill_all_positions(eng.model, toks, backend=backend)
                torch.cuda.synchronize()
                ab[name].append((time.perf_counter() - t1) * 1e3)
    row = {"phase": "serve", "config": SERVE_CONFIG,
           "path": "monolithic prefill (chunked_prefill=False, radix=False)",
           "params": sum(p.numel() for p in eng.model.parameters()),
           "init_s": init_s, "requests": len(reqs), "prompt_lengths": lengths,
           "max_new": 32, "max_active": 2, "page_tokens": 128,
           "wall_s": wall_s, "decode_steps": steps, "launches": launches,
           "flash_launches_by_route": flash,
           "paged_launches_by_route": paged,
           "prefill_ms_per_request": eng.stats["prefill_s"] / len(reqs) * 1e3,
           "prefill_forward_ms_by_prompt": {
               "kernel": [statistics.median(ab["kernel"][2 * i:2 * i + 2])
                          for i in range(len(reqs))],
               "plain": [statistics.median(ab["plain"][2 * i:2 * i + 2])
                         for i in range(len(reqs))]},
           "decode_ms_per_step": eng.stats["decode_s"] / steps * 1e3,
           "decode_tok_s": decode_tokens / eng.stats["decode_s"],
           "steady_steps": len(steady), "transfers_per_steady_token": 2,
           "transfers": eng.last_transfers,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "pool": {k: eng.kv_pool.stats[k] for k in
                    ("fast_hits", "slow_hits", "evictions")}}
    emit(row)
    return row, eng


# the decode modes' workloads: `fused` and `eager` serve the serve phase's
# 5 prompts x 32 new tokens; the numpy mode, which assembles and uploads
# every layer's pool each step, serves a cut, the serve phase's two
# longest prompts x 16 new tokens, beside a fused turn on the same cut
MODES_PROMPTS, MODES_NEW = [500, 600], 16
MODES_TURNS = (("fused", "full"), ("eager", "full"), ("numpy", "cut"),
               ("fused", "cut"))


def serve_modes(eng, rounds: int = 2) -> dict:
    """The three decode modes on the serve workload's model (starcoder2-7b,
    16 layers, bf16, the same weights; a fresh pool of 128-token pages,
    every other one int8, per turn), served continuously with
    ``max_active=2`` and one prefill pass per prompt (the non-fused
    modes' default, and the fused step's with ``chunked_prefill=False``),
    in the turns of `MODES_TURNS`, `rounds` times: ``fused`` and
    ``eager`` on the serve phase's workload (`SERVE_PROMPTS` x 32), the
    numpy mode and a fused turn on the cut (`MODES_PROMPTS` x
    `MODES_NEW`). Per turn: decode ms per step, decode tokens/s, wall
    seconds, transfers, paged launches (one a layer a step, none on the
    plain version); the medians by mode and workload; whether the greedy
    tokens equal the fused turn's on the same workload (bf16: recorded;
    phase ``exact`` holds the modes' fp32 tokens equal)."""
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention
    cfg = eng.cfg
    work = {"full": (list(SERVE_PROMPTS), 32), "cut": (MODES_PROMPTS,
                                                       MODES_NEW)}
    emit({"phase": "serve", "case": "decode modes: the cut",
          "cut": f"numpy: {len(MODES_PROMPTS)} prompts ({MODES_PROMPTS}) x "
                 f"{MODES_NEW} new tokens in place of the serve phase's "
                 f"{len(SERVE_PROMPTS)} x 32 (it assembles and uploads "
                 f"each layer's pool every step); a fused turn on the same "
                 f"cut beside it", "rounds": rounds})
    turns, tokens = [], {}
    for r in range(rounds):
        for mode, w in MODES_TURNS:
            lengths, new = work[w]
            e = _shared_engine(eng, decode_mode=mode)
            reqs = _requests(cfg.vocab_size, lengths, [new] * len(lengths),
                             5)
            reset_launches()
            plain0 = paged_attention.plain_calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = e.serve(reqs, max_active=2, chunked_prefill=False,
                           radix=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = e.stats["decode_steps"]
            if paged_attention.plain_calls != plain0 or \
                    paged_attention.launches != steps * cfg.num_layers:
                raise AssertionError(f"{mode}: paged launches "
                                     f"{paged_attention.launches} for "
                                     f"{steps} steps")
            if any(o is None or len(o) != new for o in outs):
                raise AssertionError(f"{mode} {w}: bad output {outs}")
            tokens.setdefault((mode, w), _tokens(outs))
            decode_tokens = e.stats["tokens"] - len(reqs)
            turns.append({"mode": mode, "workload": w, "round": r,
                          "prompts": len(reqs), "max_new": new,
                          "decode_steps": steps,
                          "decode_ms_per_step":
                              e.stats["decode_s"] / steps * 1e3,
                          "decode_tok_s": decode_tokens / e.stats["decode_s"],
                          "prefill_ms_per_request":
                              e.stats["prefill_s"] / len(reqs) * 1e3,
                          "wall_s": wall, "transfers": list(e.last_transfers),
                          "paged_by_route": routes("paged_attention")})
            emit({"phase": "serve", "case": "decode modes: a turn",
                  **turns[-1]})
            del e
            gc.collect()
            torch.cuda.empty_cache()
    med = {f"{m} {w}": {k: statistics.median(
        t[k] for t in turns if (t["mode"], t["workload"]) == (m, w))
        for k in ("decode_ms_per_step", "decode_tok_s", "wall_s")}
        for m, w in MODES_TURNS}

    def ms(key):
        return med[key]["decode_ms_per_step"]
    same = {f"{m} {w}": tokens[(m, w)] == tokens[("fused", w)]
            for m, w in MODES_TURNS if m != "fused"}
    row = {"phase": "serve", "case": "decode modes",
           "config": SERVE_CONFIG, "page_tokens": 128,
           "workloads": {w: {"prompt_lengths": lengths, "max_new": new}
                         for w, (lengths, new) in work.items()},
           "max_active": 2, "median_by_mode": med,
           "eager_over_fused_ms": ms("eager full") / ms("fused full"),
           "numpy_over_fused_ms": ms("numpy cut") / ms("fused cut"),
           "tokens_equal_to_fused": same, "turns": turns}
    emit(row)
    return row


def knee_round_trip(eng) -> dict:
    """Knees persisted through ``ServeEngine(knee_cache=)``: with nothing
    resolved, a serve run over the serve phase's model writes the launch
    shapes it resolved (the paged kernel's decode knee, the flash
    kernel's prefill knees) to `api.knee_cache_path(build/knees)`; a
    second engine over the same file serves the same requests and
    resolves none (``api.knees_dirty()`` stays false)."""
    import shutil
    from repro_torch.kernels import api
    cfg = eng.cfg
    ckpt = ROOT / "build" / "knees"
    shutil.rmtree(ckpt, ignore_errors=True)
    path = api.knee_cache_path(ckpt)
    api.invalidate_caches()
    reqs = _requests(cfg.vocab_size, MODES_PROMPTS, [8, 8], 6)
    first = _shared_engine(eng, knee_cache=path)
    out1 = first.serve(reqs, max_active=2, chunked_prefill=False,
                       radix=False)
    entries = json.loads(path.read_text())
    dirty_after_first = api.knees_dirty()
    del first
    api.invalidate_caches()
    second = _shared_engine(eng, knee_cache=path)
    loaded = len(api._KNEES)
    out2 = second.serve(_requests(cfg.vocab_size, MODES_PROMPTS, [8, 8], 6),
                        max_active=2, chunked_prefill=False, radix=False)
    row = {"phase": "serve", "case": "knee cache round trip",
           "path": str(path.relative_to(ROOT)), "entries": entries,
           "loaded_by_second_engine": loaded,
           "dirty_after_first_save": dirty_after_first,
           "second_engine_resolved_any": api.knees_dirty(),
           "same_tokens": _tokens(out1) == _tokens(out2)}
    emit(row)
    del second
    kernels = {e["kernel"] for e in entries}
    if not {"paged_attention", "flash_attention"} <= kernels or \
            dirty_after_first or api.knees_dirty() or not loaded or \
            not row["same_tokens"]:
        raise AssertionError(f"knee cache round trip: {row}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return row


def _shared_engine(eng, **kw):
    """A new engine over the same weights (no copy) and a fresh pool."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    return ServeEngine(eng.cfg, params=dict(eng.model.weights
                                            .named_parameters()),
                       kv_pool=PagedKVPool(page_tokens=128,
                                           placement_policy=EveryOtherSlow()),
                       **kw)


def drive_session(eng, reqs, max_active=2, **session_kw) -> dict:
    """A `ServeSession` step by step, by default the reference's default
    serving path (chunked prefill and the radix prefix cache on).
    Returns per-request time to first token and per-step times, split
    into steps that carried a prompt chunk and steps that only decoded,
    and per step its time and the first tokens it gave (`step_log`)."""
    from repro_torch.serve.engine import ServeSession
    cap = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    session = ServeSession(eng, capacity=cap, max_active=max_active,
                           **session_kw)
    t0 = time.perf_counter()
    for r in reqs:
        if not session.submit(r):
            raise AssertionError(f"request rejected: {session.request_stats(r)}")
    ttft, wide_ms, narrow_ms, step_log = {}, [], [], []
    while not session.done:
        chunks0 = session.chunk_steps
        t1 = time.perf_counter()
        events = session.step()
        torch.cuda.synchronize()
        now = time.perf_counter()
        (wide_ms if session.chunk_steps > chunks0 else narrow_ms).append(
            (now - t1) * 1e3)
        first = 0
        for ev in events:
            if ev.tokens and id(ev.request) not in ttft:
                ttft[id(ev.request)] = (now - t0) * 1e3
                first += 1
        step_log.append(((now - t1) * 1e3, first))
    outs = [session.result(r) for r in reqs]
    stats = [session.request_stats(r) for r in reqs]
    hit_rate = session.prefix_hit_rate
    session.close()
    return {"outs": outs, "stats": stats, "hit_rate": hit_rate,
            "ttft_ms": [ttft[id(r)] for r in reqs], "wide_ms": wide_ms,
            "narrow_ms": narrow_ms, "wall_s": time.perf_counter() - t0,
            "steps": session.steps, "chunked": session.chunked,
            "radix": session.radix, "step_log": step_log,
            "peak_live_pages": session.peak_live_pages,
            "steady": list(session.steady_transfers)}


def _check_outs(outs, reqs, vocab):
    for o, r in zip(outs, reqs):
        if o is None or len(o) != r.max_new_tokens or \
                not ((0 <= o) & (o < vocab)).all():
            raise AssertionError(f"bad output {o}")


def check_paged_routes(run, n_layers) -> dict:
    """A session's paged launches by route: its chunk-fill (k = 128) steps
    on the wgmma route, its other steps (decode, k = 4 verify) on split."""
    paged = routes("paged_attention")
    chunk = len(run["wide_ms"])
    want = {"split": (run["steps"] - chunk) * n_layers,
            "wgmma": chunk * n_layers, "simt": 0}
    if paged != want:
        raise AssertionError(f"paged launches by route {paged}, want {want}")
    return paged


def phase_chunked(base) -> dict:
    """The reference's default `serve` path at full width: 6 requests whose
    prompts share a 512-token head (4 pages), prefilled in page-sized
    chunks riding k = 128 verify steps (the row-blocked paged-attention
    kernel: 1152 query rows per kv head), with later requests adopting the
    cached head from the radix prefix tree."""
    eng = _shared_engine(base)
    cfg = eng.cfg
    reqs = _shared_prefix_requests(cfg.vocab_size, 512,
                                   [40, 130, 250, 70, 300, 10], 32, 4)
    reset_launches()
    run = drive_session(eng, reqs)
    launches = read_launches()
    _check_outs(run["outs"], reqs, cfg.vocab_size)
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left after "
                             f"close")
    if not run["hit_rate"]:
        raise AssertionError(f"no prefix hit: {run['hit_rate']}")
    if not run["wide_ms"]:
        raise AssertionError("no chunk-fill (k = 128) step ran")
    if launches["paged_attention"] != run["steps"] * cfg.num_layers or \
            launches["flash_attention"]:
        raise AssertionError(f"{launches} launches for {run['steps']} steps")
    paged = check_paged_routes(run, cfg.num_layers)
    row = {"phase": "chunked", "config": SERVE_CONFIG,
           "path": "default serve: chunked prefill + radix prefix cache",
           "requests": len(reqs), "shared_prefix": 512,
           "prompt_lengths": [len(r.prompt) for r in reqs], "max_new": 32,
           "max_active": 2, "page_tokens": 128, "launches": launches,
           "paged_launches_by_route": paged,
           "steps": run["steps"], "chunk_steps": len(run["wide_ms"]),
           "prefix_hit_rate": run["hit_rate"], "wall_s": run["wall_s"],
           "ttft_ms": run["ttft_ms"],
           "chunk_step_ms_mean": statistics.mean(run["wide_ms"]),
           "prefill_ms_per_request": sum(run["wide_ms"]) / len(reqs),
           "decode_ms_per_step": statistics.mean(run["narrow_ms"]),
           "decode_steps": len(run["narrow_ms"])}
    emit(row)
    row["profile"] = phase_profile(eng, steps=4, k=128)
    return row


def phase_spec(base) -> dict:
    """k = 4 speculative decode with n-gram drafts through the default
    serve path, on the serve phase's workload."""
    eng = _shared_engine(base, speculate=4)
    cfg = eng.cfg
    reqs = _requests(cfg.vocab_size, [120, 250, 380, 500, 600], [32] * 5, 2)
    reset_launches()
    run = drive_session(eng, reqs)
    launches = read_launches()
    _check_outs(run["outs"], reqs, cfg.vocab_size)
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
    if launches["paged_attention"] != run["steps"] * cfg.num_layers:
        raise AssertionError(f"{launches} launches for {run['steps']} steps")
    paged = check_paged_routes(run, cfg.num_layers)
    proposed = sum(d["proposed"] for d in run["stats"])
    accepted = sum(d["accepted"] for d in run["stats"])
    decode_tokens = sum(d["tokens"] - 1 for d in run["stats"])
    verify_steps = sum(d["steps"] for d in run["stats"])
    row = {"phase": "spec", "config": SERVE_CONFIG,
           "path": "default serve, speculate=4, n-gram draft",
           "requests": len(reqs), "max_new": 32, "max_active": 2,
           "launches": launches, "paged_launches_by_route": paged,
           "steps": run["steps"], "chunk_steps": len(run["wide_ms"]),
           "accept_rate": accepted / proposed if proposed else None,
           "tokens_per_step": decode_tokens / verify_steps,
           "per_request": [{k: d[k] for k in ("accept_rate",
                                              "tokens_per_step")}
                           for d in run["stats"]],
           "verify_step_ms_mean": statistics.mean(run["narrow_ms"]),
           "verify_steps": len(run["narrow_ms"]),
           "ttft_ms": run["ttft_ms"], "wall_s": run["wall_s"]}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# 7. overload: the main path under load (SLO scheduling, host swap tier)
# ---------------------------------------------------------------------------
ARRIVAL_X_SERVICE = 2.0             # arrival rate / measured service rate
DEADLINE_X_STEP = (10, 80, 600)     # the mix's 3 deadline classes, in steps
OVERLOAD_PROMPTS = (120, 250, 380, 500, 600)    # the serve phase's range
OVERLOAD_NEW = (16, 24, 32)


class SwapTimer:
    """CUDA events (and the host clock) around every `PagedKVState`
    swap_out / swap_in while installed: the ms each takes on the card's
    stream. A swap-out ends in a host copy, so its events bracket the
    readback; a swap-in's pages upload at the next step's sync, so its
    events bracket the tail rows' and recurrent state's writes only."""

    def __init__(self):
        from repro_torch.serve.paged_decode import PagedKVState
        self.cls = PagedKVState
        self.orig = {n: getattr(PagedKVState, n) for n in ("swap_out",
                                                            "swap_in")}
        self.events = {n: [] for n in self.orig}

    def __enter__(self):
        def wrap(name, fn):
            def timed(state, seq):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                moved = fn(state, seq)
                host = (time.perf_counter() - t0) * 1e3
                end.record()
                self.events[name].append((start, end, host))
                return moved
            return timed
        for name, fn in self.orig.items():
            setattr(self.cls, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)

    def summary(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for name, evs in self.events.items():
            dev = [a.elapsed_time(b) for a, b, _ in evs]
            host = [h for _, _, h in evs]
            out[name] = {"n": len(evs),
                         "ms_median": statistics.median(dev) if dev else None,
                         "ms_max": max(dev) if dev else None,
                         "host_ms_median": statistics.median(host)
                         if host else None}
        return out


def _recording_frontend():
    """A front-end class that keeps every instance, so the phase can read
    the session `traffic.run_trace` built (its step counts)."""
    from repro_torch.serve.frontend import AsyncServeFrontend
    made = []

    class Recorded(AsyncServeFrontend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    return Recorded, made


def phase_overload(base, serve_row, smi: str) -> dict:
    """The main path under load, through the entry points a user calls:
    the reference's ``overload`` mix (16 requests, deadline classes,
    priorities 0 / 1) replayed open-loop by `traffic.run_trace` through
    `AsyncServeFrontend` over the serve phase's weights (starcoder2-7b,
    16 layers, bf16, 128-token pages, every other one int8), with the
    mix's prompt and output lengths scaled to the serve phase's range,
    the arrival rate set to ARRIVAL_X_SERVICE times the service rate the
    serve phase measured and the deadlines to DEADLINE_X_STEP times its
    decode step. ``REPRO_SERVE_DEBUG`` checks the pool invariants after
    every step. Then a fault pass (``REPRO_SERVE_FAULT=swap_fail:1``)
    and one recurrentgemma-2b request parked and resumed at full depth."""
    import os
    from repro_torch.serve import traffic
    from repro_torch.serve.frontend import AsyncServeFrontend
    eng = _shared_engine(base)
    cfg = eng.cfg
    service_rps = serve_row["requests"] / serve_row["wall_s"]
    step_s = serve_row["decode_ms_per_step"] / 1e3
    mix = traffic.MIXES["overload"]
    spec = overload_spec(serve_row)
    recorded, fronts = _recording_frontend()
    traffic.AsyncServeFrontend = recorded
    os.environ["REPRO_SERVE_DEBUG"] = "1"
    reset_launches()
    try:
        with SwapTimer() as timer:
            t0 = time.perf_counter()
            summary = traffic.run_trace(eng, spec, max_active=2,
                                        max_queue=16)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        traffic.AsyncServeFrontend = AsyncServeFrontend
        del os.environ["REPRO_SERVE_DEBUG"]
    launches = read_launches()
    paged = routes("paged_attention")
    ses = fronts[0].session
    if not ses._debug:
        raise AssertionError("the session did not run with "
                             "REPRO_SERVE_DEBUG")
    accounted = sum(summary[k] for k in ("n_done", "n_cancelled",
                                         "n_rejected", "n_errors"))
    want_routes = {"split": (ses.steps - ses.chunk_steps) * cfg.num_layers,
                   "wgmma": ses.chunk_steps * cfg.num_layers, "simt": 0}
    steady = list(ses.steady_transfers)
    pool = eng.kv_pool
    swaps = timer.summary()
    row = {"phase": "overload", "config": SERVE_CONFIG,
           "path": "traffic.run_trace -> AsyncServeFrontend -> ServeSession "
                   "(chunked prefill + radix, preemption on, LRU victims)",
           "nvidia_smi": smi, "mix": "overload", "n_requests": spec.n_requests,
           "prompt_lens": list(spec.prompt_lens),
           "new_tokens": list(spec.new_tokens),
           "priorities": list(spec.priorities), "max_active": 2,
           "max_queue": 16, "page_tokens": 128,
           "service_rate_rps": service_rps,
           "arrival_x_service": ARRIVAL_X_SERVICE,
           "arrival_rate_rps": spec.arrival_rate,
           "decode_step_s": step_s, "deadline_x_step": list(DEADLINE_X_STEP),
           "deadlines_s": list(spec.deadlines),
           "mix_deadlines_s": list(mix.deadlines),
           "wall_s": wall_s, "steps": ses.steps,
           "chunk_steps": ses.chunk_steps, "launches": launches,
           "paged_launches_by_route": paged,
           "steady_steps": len(steady),
           "summary": summary, "swap_ms": swaps,
           "pool_swap": {k: pool.stats[k] for k in (
               "swapped_out", "swapped_in", "swap_out_bytes",
               "swap_in_bytes")},
           "invariants_checked_every_step": True}
    emit(row)
    if accounted != spec.n_requests or summary["n_trace"] != spec.n_requests:
        raise AssertionError(f"{accounted} of {spec.n_requests} requests "
                             f"accounted for: {summary}")
    if not summary["preemptions"] or not ses.preemptions or \
            not summary["swap_out_bytes"] or not summary["swap_in_bytes"]:
        raise AssertionError(f"no preemption with swap traffic: {summary}")
    if summary["pool_live_pages_end"] or pool.live_pages:
        raise AssertionError(f"{pool.live_pages} pages left after close")
    if paged != want_routes:
        raise AssertionError(f"paged launches by route {paged}, want "
                             f"{want_routes}")
    if any(s != (1, 1) for s in steady):
        raise AssertionError(f"steady-state transfers {steady}")
    row["fault"] = overload_fault_pass(eng)
    row["hybrid"] = overload_hybrid_park()
    return row


def overload_fault_pass(eng) -> dict:
    """``REPRO_SERVE_FAULT=swap_fail:1``: two priority-0 requests decode,
    a priority-1 arrival parks one of them, and its swap-in at resume
    fails. The victim must end as a ``swap_fail`` error event with its
    partial tokens; the other two finish; the pool ends empty."""
    import os
    from repro_torch.serve.engine import ServeSession
    from repro_torch.serve.metrics import MetricsRegistry
    cfg = eng.cfg
    reqs = _requests(cfg.vocab_size, [250, 380, 120], [24, 24, 16], 9)
    reqs[2].priority = 1
    metrics = MetricsRegistry()
    os.environ["REPRO_SERVE_FAULT"] = "swap_fail:1"
    try:
        ses = ServeSession(eng, capacity=420, max_active=2, metrics=metrics)
    finally:
        del os.environ["REPRO_SERVE_FAULT"]
    events = []
    for r in reqs[:2]:
        ses.submit(r)
    while not all(ses._recs[id(r)].active is not None
                  and len(ses._recs[id(r)].active.outs) >= 4
                  for r in reqs[:2]):
        events += ses.step()
    ses.submit(reqs[2])
    while not ses.done:
        events += ses.step()
    ses.close()
    errors = [(next(i for i, r in enumerate(reqs) if r is ev.request),
               ev.done) for ev in events if ev.error == "swap_fail"]
    status = [ses._recs[id(r)].status for r in reqs]
    s = metrics.summary()
    row = {"phase": "overload", "case": "REPRO_SERVE_FAULT=swap_fail:1",
           "requests": [len(r.prompt) for r in reqs],
           "priorities": [r.priority for r in reqs],
           "status": status, "swap_fail_events": errors,
           "tokens": [len(ses.result(r)) for r in reqs],
           "preemptions": ses.preemptions, "n_errors": s["n_errors"],
           "n_done": s["n_done"], "live_pages": eng.kv_pool.live_pages}
    emit(row)
    if len(errors) != 1 or sorted(status) != ["done", "done", "error"] \
            or status[2] != "done" or not errors[0][1] \
            or eng.kv_pool.live_pages or s["n_errors"] != 1:
        raise AssertionError(f"fault pass: {row}")
    return row


def overload_hybrid_park() -> dict:
    """recurrentgemma-2b at full depth, bf16: one request parked mid
    decode and resumed through `ServeSession.preempt` / `resume` (its
    recurrent slots read back whole, its ring pages to the host tier).
    Its outcome is checked: it terminates, the pool ends empty, its ring
    pages stay within ``ring_pages()``, and the recurrent store is read
    back only by the swap (one read per store tensor)."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine, ServeSession
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.paged_state import rec_array_names
    cfg = get_config("recurrentgemma-2b")
    eng = ServeEngine(cfg, seed=0, kv_pool=PagedKVPool(
        page_tokens=128, placement_policy=EveryOtherSlow()))
    [req] = _requests(cfg.vocab_size, [300], [24], 10)
    ses = ServeSession(eng, capacity=324, max_active=1)
    ses.submit(req)
    lay, pool = eng.layout, eng.kv_pool
    ring_max, parked = 0, None
    with SwapTimer() as timer:
        while not ses.done:
            ses.step()
            rec = ses._recs[id(req)]
            if rec.active is not None:
                ring_max = max(ring_max,
                               len(pool.seq_pages(rec.active.seq, 0)))
            if parked is None and rec.active is not None \
                    and len(rec.active.outs) >= 8:
                reads0 = ses.state._rec.reads
                if not ses.preempt(req):
                    raise AssertionError("recurrentgemma request did not park")
                parked = {"host_pages": pool.host_pages,
                          "rec_reads": ses.state._rec.reads - reads0,
                          "swap_out_bytes": pool.stats["swap_out_bytes"]}
                if not ses.resume(req):
                    raise AssertionError("recurrentgemma request did not "
                                         "resume")
    ses.close()
    n_names = len(rec_array_names(lay))
    store = ses.state.rec_store_counts()
    row = {"phase": "overload", "case": "recurrentgemma-2b, 26 layers, bf16:"
           " park and resume one request", "prompt": 300, "max_new": 24,
           "tokens": len(ses.result(req)), "status": ses._recs[id(req)].status,
           "parked": parked, "ring_pages_max": ring_max,
           "ring_pages_bound": lay.ring_pages(), "rec_store": store,
           "swap_ms": timer.summary(), "live_pages": pool.live_pages,
           "preemptions": ses.preemptions, "resumes": ses.resumes}
    emit(row)
    if row["status"] != "done" or row["tokens"] != 24 or pool.live_pages \
            or ring_max > lay.ring_pages() or parked is None \
            or not parked["host_pages"] or parked["rec_reads"] != n_names \
            or store["reads"] != n_names:
        raise AssertionError(f"recurrentgemma park / resume: {row}")
    del eng, ses
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _hybrid_generate(eng, reqs, n_layers_by_kernel) -> dict:
    """One `generate` call of a hybrid engine with the counts set to 0
    just before it: launches, recurrent-store traffic, transfers, times."""
    from repro_torch.serve.paged_state import rec_array_names
    seq0 = eng._next_seq
    st0 = dict(eng.stats)
    reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    flash = routes("flash_attention")
    _check_outs(outs, reqs, eng.cfg.vocab_size)
    for name, n in n_layers_by_kernel.items():
        if launches[name] != n:       # one batched prefill per generate
            raise AssertionError(f"{launches} launches, want {name} == {n}")
    if flash != {"wgmma": launches["flash_attention"], "simt": 0}:
        raise AssertionError(f"flash launches by route {flash}: the bf16 "
                             f"windowed prefill must take the wgmma route")
    scans = {"ssd_scan": routes("ssd_scan"),
             "rglru_scan": routes("rglru_scan")}
    if scans != {"ssd_scan": {"wgmma": launches["ssd_scan"], "simt": 0},
                 "rglru_scan": {"chunked": launches["rglru_scan"],
                                "serial": 0}}:
        raise AssertionError(f"scan launches by route {scans}: the bf16 SSD "
                             f"prefill must take the wgmma route, the "
                             f"RG-LRU prefill the chunked route")
    steps = eng.stats["decode_steps"] - st0["decode_steps"]
    store = eng.last_rec_store
    # the prefill installs one block per recurrent tensor and sequence;
    # decode never reads a state back nor writes one from the host
    n_names = len(rec_array_names(eng.layout))
    if store["reads"] or store["writes"] != n_names * len(reqs):
        raise AssertionError(f"recurrent store {store}, want "
                             f"{n_names * len(reqs)} writes, 0 reads")
    h2d, d2h = eng.last_transfers
    seqs = list(range(seq0, eng._next_seq))
    return {"outs": outs, "launches": launches,
            "flash_launches_by_route": flash,
            "scan_launches_by_route": scans, "steps": steps,
            "wall_s": wall_s, "seqs": seqs, "transfers": [h2d, d2h],
            "rec_store": dict(store),
            "prefill_ms_per_request":
                (eng.stats["prefill_s"] - st0["prefill_s"]) / len(reqs) * 1e3,
            "decode_ms_per_step":
                (eng.stats["decode_s"] - st0["decode_s"]) / steps * 1e3}


def _hybrid_serve(eng, reqs) -> dict:
    """The default `serve` path (a `ServeSession`) of a hybrid engine:
    chunked prefill through the one-token cores, no scan launches."""
    reset_launches()
    run = drive_session(eng, reqs, max_active=len(reqs))
    launches = read_launches()
    _check_outs(run["outs"], reqs, eng.cfg.vocab_size)
    if launches["ssd_scan"] or launches["rglru_scan"] or \
            launches["flash_attention"]:
        raise AssertionError(f"serve() launched a prefill kernel: {launches}")
    if not run["chunked"] or run["radix"]:
        raise AssertionError("a hybrid session must chunk, without radix")
    if not run["steady"] or any(s != (1, 1) for s in run["steady"]):
        raise AssertionError(f"steady-state transfers {run['steady']}")
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
    return {"launches": launches, "steps": run["steps"],
            "chunk_steps": len(run["wide_ms"]),
            "chunk_step_ms_mean": statistics.mean(run["wide_ms"]),
            "decode_ms_per_step": statistics.mean(run["narrow_ms"]),
            "steady_steps": len(run["steady"]),
            "transfers_per_steady_token": 2, "ttft_ms": run["ttft_ms"],
            "wall_s": run["wall_s"]}


# depths: recurrentgemma-2b whole, mamba2-780m cut from 48, whose default
# `serve` steps its one-token cores position by position, host launches
# (59 s of a whole run at 48 layers, 30-39 s at 24)
HYBRID_LAYERS = {"mamba2-780m": 12, "recurrentgemma-2b": 26}


def phase_hybrid() -> dict:
    """The hybrid stacks at `HYBRID_LAYERS`, bf16, seeded random weights
    made on the card: `generate` prefills through the SSD / RG-LRU scan kernels
    (and, for recurrentgemma's local-attention layers, the flash kernel
    with a 2048 window), then decodes with one recurrent slot per
    sequence and ring pages; the default `serve` streams short prompts
    in page-sized chunks through the one-token cores."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.paged_state import StateLayout
    rows, launches = {}, {}
    for arch, gen_lengths, gen_new, serve_lengths in (
            ("mamba2-780m", [256, 700, 1536], 32, [200, 280, 350]),
            ("recurrentgemma-2b", [2300, 1000], 40, [150, 220, 300])):
        cfg = get_config(arch, num_layers=HYBRID_LAYERS[arch])
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, seed=0, kv_pool=PagedKVPool(
            page_tokens=128, placement_policy=EveryOtherSlow()))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        lay = StateLayout(cfg, 128)
        per_prefill = {"ssd_scan": lay.n_ssd, "rglru_scan": lay.n_rg,
                       "flash_attention": lay.n_kv, "paged_attention": 0}
        torch.cuda.reset_peak_memory_stats()
        gen = _hybrid_generate(
            eng, _requests(cfg.vocab_size, gen_lengths,
                           [gen_new] * len(gen_lengths), 5), per_prefill)
        row = {"phase": "hybrid", "config": f"{arch}, {cfg.num_layers} "
               f"layers, bf16", "params": sum(
                   p.numel() for p in eng.model.parameters()),
               "init_s": init_s, "page_tokens": 128,
               "generate": {"prompt_lengths": gen_lengths,
                            "padded_to": max(gen_lengths),
                            "max_new": gen_new,
                            **{k: v for k, v in gen.items()
                               if k not in ("outs", "seqs")}}}
        if lay.has_ring:
            pool = eng.kv_pool
            live = [len(pool.seq_pages(s, 0)) for s in gen["seqs"]]
            # nothing but ring drops frees a page inside generate()
            drops = pool.stats["freed"]
            row["generate"].update(ring_pages_live=live,
                                   ring_pages_max=lay.ring_pages(),
                                   ring_pages_dropped_in_decode=drops)
            if max(live) > lay.ring_pages() or not drops:
                raise AssertionError(f"ring pages {live} (max "
                                     f"{lay.ring_pages()}), {drops} drops")
            for seq in gen["seqs"]:
                pool.free(seq)
        elif gen["transfers"][1] != gen["steps"] or \
                gen["transfers"][0] - gen["rec_store"]["writes"] \
                != gen["steps"]:
            # pure SSM: one control upload and one token download per
            # step, nothing else crosses
            raise AssertionError(f"transfers {gen['transfers']} for "
                                 f"{gen['steps']} steps")
        row["generate"]["peak_mem_gb"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        launches[arch] = gen["launches"]
        # the chunk step holds all k = page_tokens recurrent checkpoints
        # of every recurrent layer until its accept rule, as the reference
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated() / 2 ** 30
        row["serve"] = {"prompt_lengths": serve_lengths, "max_new": 16,
                        **_hybrid_serve(eng, _requests(
                            cfg.vocab_size, serve_lengths,
                            [16] * len(serve_lengths), 6))}
        row["serve"].update(mem_before_gb=mem0, peak_mem_gb=torch.cuda
                            .max_memory_allocated() / 2 ** 30)
        emit(row)
        row["profile"] = phase_profile(eng)
        rows[arch] = row
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return rows, launches


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_events(prof) -> list:
    """The trace's device events as recorded, (name, start µs, end µs)
    from the first one's start: parsing the trace into a tree of function
    events (`prof.events()`) took a minute at mamba2-780m's ~90,000
    kernels a 2x2 training step."""
    from torch.autograd import DeviceType
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    if not events:
        return []
    t0_ns = min(start for _, start, _ in events)     # µs from here, exact
    return [(name, (start - t0_ns) / 1e3, (end - t0_ns) / 1e3)
            for name, start, end in events]


def _device_us_under(event, skip: str) -> float:
    """Device time of the kernels launched under a profiler CPU event (its
    own and its descendants'), leaving out the GPU-side range of an
    annotation named `skip`."""
    return (sum(kern.duration for kern in event.kernels if kern.name != skip)
            + sum(_device_us_under(c, skip) for c in event.cpu_children))


def phase_profile(eng, steps: int = 16, k: int = 1,
                  span: str | None = None, backend: str = "auto") -> dict:
    """Steps of 2 rows at ~500 tokens of context, timed without and then
    with `torch.profiler`: device busy share of the traced window (union
    of kernel intervals over its wall time), kernels per step, the paged
    kernel's and the port's kernels' share of the busy time and the
    kernels that take the most device time. ``k`` = 1: decode steps; k >
    1: chunk-fill steps, each feeding k tokens a row through the k-row
    step (`build_fused_step(k=...)`) as the default `serve()` feeds a
    prompt chunk. Any stack the engine serves (the hybrids' decode runs
    none of the port's kernels: their recurrent and ring layers step
    through plain PyTorch, as the reference's do through jnp), and a
    mesh plan's (`eng.plan`: the two rows on their data shards, each
    shard's kernels launched in turn). ``span``
    names a `torch.profiler.record_function` range the caller wraps
    around part of the step (`moe_span`): its kernels' device time per
    step and share of the busy time join the row. ``backend`` "auto"
    launches the paged kernel at its knee, "cuda" at the launch before
    tiles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.paged_decode import (PagedKVState,
                                                build_fused_step,
                                                extract_prefill_pages)
    cfg = eng.cfg
    plan = getattr(eng, "plan", None)
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 500)).astype(np.int32)).cuda()
    state = PagedKVState(eng.kv_pool, 500 + (2 * steps + 3) * k + 8,
                         eng.layout, cfg.num_kv_heads, cfg.head_dim,
                         batch_hint=2, device=eng.device, plan=plan)
    seqs = [10_000, 10_001]
    shards = 1
    if plan is None:
        logits, caches = eng.model.forward_prefill(prompts)
    else:
        # each row on the data shard that decodes it, bound before writes
        rows = [plan.shard_of_row(i, 2) for i in range(2)]
        for seq, shard in zip(seqs, rows):
            state.bind_seq(seq, shard)
        logits, caches = eng.model.forward_prefill(prompts, row_shards=rows)
        shards = plan.dp * plan.tp
    extract_prefill_pages(eng.model, caches, state, seqs)
    del caches
    step_fn = build_fused_step(eng.model, state.slots, k=k,
                               layout=eng.layout, plan=plan, backend=backend)
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = 500

    def one_step():
        nonlocal tok, pos
        if k == 1:
            _, tok = state.run_fused(step_fn, tok, seqs, pos)
        else:
            chunk = rng.integers(0, cfg.vocab_size, (2, k)).astype(np.int32)
            state.run_spec(step_fn, chunk, seqs, pos)
            state.end_step(seqs, [k, k])
        pos += k

    for _ in range(3 if k == 1 else 1):              # warm-up
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    plain_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if span is None:
        kernels = device_events(prof)
    else:
        # the span's kernels are found through the tree of function
        # events, which `prof.events()` builds
        kernels = [(e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name != span]
    busy_us = _union_us((start, end) for _, start, end in kernels)
    by_name: dict = {}
    for name, start, end in kernels:
        by_name[name] = by_name.get(name, 0.0) + end - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn_us = sum(v for k, v in by_name.items() if "paged_attention" in k)
    port_us = sum(v for k, v in by_name.items()
                  if any(name in k for name in KERNELS))
    for seq in seqs:
        state.free_seq(seq)
    row = {"phase": "profile", "config": f"{cfg.name}, {cfg.num_layers} "
           f"layers, {cfg.compute_dtype}", "rows": 2, "context": 500,
           "plan": repr(plan) if plan is not None else None,
           "k": k, "steps": steps, "backend": backend,
           ("decode_ms_per_step" if k == 1 else "chunk_step_ms"): plain_ms,
           "traced_ms_per_step": traced_s / steps * 1e3,
           "device_busy_share": busy_us / (traced_s * 1e6),
           "kernels_per_step": len(kernels) / steps,
           "paged_attention_share_of_busy": attn_us / busy_us if busy_us
           else None,
           "paged_attention_us_per_launch":
               attn_us / (steps * cfg.num_layers * shards),
           "port_kernels_share_of_busy": port_us / busy_us if busy_us
           else None,
           "top_kernels_us_per_step": [[k[:80], v / steps] for k, v in top]}
    if span is not None:
        span_us = sum(_device_us_under(e, span) for e in prof.events()
                      if e.name == span and e.device_type == DeviceType.CPU)
        if not span_us:
            raise AssertionError(f"no device time under {span!r}")
        row[f"{span}_us_per_step"] = span_us / steps
        row[f"{span}_share_of_busy"] = span_us / busy_us
    emit(row)
    return row


# ---------------------------------------------------------------------------
# 8. the stencil path: NERO's COSMO hdiff and vadvc
# ---------------------------------------------------------------------------
EXACT_RULE = ("bit equality with the plain version on the same inputs "
              "(NaN where it has NaN): both round each operation once, in "
              "the same order")
L2_BYTES = 50e6                  # H100 L2 cache
SLEEP_CYCLES = 10_000_000        # ~5 ms of `torch.cuda._sleep` at 1.98 GHz
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def exact_check(got, want) -> dict:
    """`EXACT_RULE`: the elements that differ, the largest difference and
    its distance in ulps of |want| (in want's dtype)."""
    g, w = got.float(), want.float()
    same = (g == w) | (g.isnan() & w.isnan())
    diff = torch.where(same, 0.0, (g - w).abs().nan_to_num(nan=float("inf")))
    mant = {torch.float32: 23, torch.bfloat16: 7}[want.dtype]
    ulp = torch.exp2(torch.floor(torch.log2(
        w.double().abs().nan_to_num(0.0).clamp_min(2.0 ** -126))) - mant)
    return {"mismatches": int((~same).sum()),
            "max_abs_err": diff.max().item(),
            "max_ulps": (diff.double() / ulp).max().item()}


def hdiff_variant(src, fault=None):
    """The hdiff algorithm of `kernels/hdiff/ref.py` once more, in plain
    PyTorch; ``fault="skip_limiter"`` skips the limiter of the x flux at
    each cell's east face, to show that `exact_check` catches a kernel
    that does."""
    from repro_torch.kernels.hdiff.ref import COEFF, HALO
    nz, ny, nx = src.shape
    p = src.float()

    def s(dy, dx):
        return p[:, 2 + dy:ny - 2 + dy, 2 + dx:nx - 2 + dx]

    def lap(dy, dx):
        return (4.0 * s(dy, dx) - (s(dy - 1, dx) + s(dy + 1, dx)
                                   + s(dy, dx - 1) + s(dy, dx + 1)))

    def limited(flx, dif, skip=False):
        return flx if skip else torch.where(flx * dif > 0, 0.0, flx)

    lap_c = lap(0, 0)
    flx_c = limited(lap(0, 1) - lap_c, s(0, 1) - s(0, 0),
                    skip=fault == "skip_limiter")
    flx_m = limited(lap_c - lap(0, -1), s(0, 0) - s(0, -1))
    fly_c = limited(lap(1, 0) - lap_c, s(1, 0) - s(0, 0))
    fly_m = limited(lap_c - lap(-1, 0), s(0, 0) - s(-1, 0))
    out = src.clone()
    out[:, HALO:ny - HALO, HALO:nx - HALO] = (
        s(0, 0) - COEFF * ((flx_c - flx_m) + (fly_c - fly_m))).to(src.dtype)
    return out


def vadvc_variant(ustage, upos, utens, utens_stage, wcon, fault=None):
    """The vadvc algorithm of `kernels/vadvc/ref.py` once more, in plain
    PyTorch; ``fault="drop_k0_correction"`` drops the correction term of
    level 0, to show that `exact_check` catches a kernel that does."""
    from repro_torch.kernels.vadvc.ref import BET_M, BET_P, DTR_STAGE
    nz = ustage.shape[0]
    cc = dd = torch.zeros_like(ustage[0])
    ccols, dcols = [], []
    for k in range(nz):
        gav = -0.25 * (wcon[k, :, 1:] + wcon[k, :, :-1])
        gcv = 0.25 * (wcon[k + 1, :, 1:] + wcon[k + 1, :, :-1])
        u_k = ustage[k]
        corr_lo = -(gav * BET_M) * (ustage[max(k - 1, 0)] - u_k)
        corr_hi = -(gcv * BET_M) * (ustage[min(k + 1, nz - 1)] - u_k)
        acol = torch.zeros_like(gav) if k == 0 else gav * BET_P
        ccol = torch.zeros_like(gcv) if k == nz - 1 else gcv * BET_P
        if k == 0:
            corr = torch.zeros_like(corr_hi) \
                if fault == "drop_k0_correction" else corr_hi
        else:
            corr = corr_lo if k == nz - 1 else corr_lo + corr_hi
        rhs = DTR_STAGE * upos[k] + utens[k] + utens_stage[k] + corr
        divided = 1.0 / (DTR_STAGE - acol - ccol - cc * acol)
        cc, dd = ccol * divided, (rhs - dd * acol) * divided
        ccols.append(cc)
        dcols.append(dd)
    out = torch.empty_like(ustage)
    data = torch.zeros_like(ustage[0])
    for k in range(nz - 1, -1, -1):
        data = dcols[k] - ccols[k] * data
        out[k] = DTR_STAGE * (data - upos[k])
    return out


STENCIL_FAULTS = {"hdiff": (hdiff_variant, "skip_limiter"),
                  "vadvc": (vadvc_variant, "drop_k0_correction")}


STENCIL_ROUTES = {"hdiff": ("tma", "simt"), "vadvc": ("prefetch", "simt")}


def hdiff_tiled_loop(src, tile_x=64, tile_y=16, block_z=1, fault=None):
    """The hdiff kernel's tma route in plain PyTorch, item by item: the
    box of block_z planes x (tile_y + 4) rows x `tma_box_width` columns
    from (z0, y0 - 2, x0 - 16 bytes), zero where it leaves the grid (as
    TMA fills it); the (tile_y + 2) x (tile_x + 2) Laplacian tile computed
    once from the box; the limited fluxes and the output of the tile's cells from
    the box and that tile, ring cells copied from the box; cells of the
    ragged last tiles past the grid dropped. Each operation rounds once in
    fp32, in the kernel's order. ``fault`` "lap_interior_only" leaves the
    Laplacian tile's outer ring at 0 (a tile built over the output cells
    alone), to show that `exact_check` catches such a kernel."""
    from repro_torch.kernels.hdiff.hdiff import tma_box_width
    from repro_torch.kernels.hdiff.ref import COEFF, HALO
    nz, ny, nx = src.shape
    tx, ty, p = tile_x, tile_y, block_z
    tiles_z, tiles_y, tiles_x = -(-nz // p), -(-ny // ty), -(-nx // tx)
    width = tma_box_width(tx, src.element_size())
    lead = 16 // src.element_size()           # box columns before x0
    off = lead - HALO                         # box column of x0 - 2
    pad = src.new_zeros(tiles_z * p, tiles_y * ty + 4,
                        (tiles_x - 1) * tx + width)
    pad[:nz, HALO:HALO + ny, lead:lead + nx] = src
    out = torch.empty_like(src)
    for bz in range(tiles_z):
        for by in range(tiles_y):
            for bx in range(tiles_x):
                z0, y0, x0 = bz * p, by * ty, bx * tx
                raw = pad[z0:z0 + p, y0:y0 + ty + 4, x0:x0 + width]
                b = raw.float()

                def box(r, c, h, w):
                    return b[:, r:r + h, off + c:off + c + w]
                h, w = ty + 2, tx + 2
                lap = 4.0 * box(1, 1, h, w) - (
                    ((box(0, 1, h, w) + box(2, 1, h, w)) + box(1, 0, h, w))
                    + box(1, 2, h, w))
                if fault == "lap_interior_only":
                    inner = torch.zeros_like(lap)
                    inner[:, 1:-1, 1:-1] = lap[:, 1:-1, 1:-1]
                    lap = inner

                def lp(r, c):
                    return lap[:, r:r + ty, c:c + tx]
                s_c, l_c = box(2, 2, ty, tx), lp(1, 1)

                def limited(flx, dif):
                    return torch.where(flx * dif > 0, 0.0, flx)
                flx_c = limited(lp(1, 2) - l_c, box(2, 3, ty, tx) - s_c)
                flx_m = limited(l_c - lp(1, 0), s_c - box(2, 1, ty, tx))
                fly_c = limited(lp(2, 1) - l_c, box(3, 2, ty, tx) - s_c)
                fly_m = limited(l_c - lp(0, 1), s_c - box(1, 2, ty, tx))
                res = (s_c - COEFF * ((flx_c - flx_m) + (fly_c - fly_m))
                       ).to(src.dtype)
                y = torch.arange(y0, y0 + ty)[:, None]
                x = torch.arange(x0, x0 + tx)[None, :]
                ring = (y < HALO) | (y >= ny - HALO) | (x < HALO) \
                    | (x >= nx - HALO)
                cells = torch.where(ring.to(src.device),
                                    raw[:, 2:2 + ty, off + 2:off + 2 + tx],
                                    res)
                ze, ye, xe = min(p, nz - z0), min(ty, ny - y0), \
                    min(tx, nx - x0)
                out[z0:z0 + ze, y0:y0 + ye, x0:x0 + xe] = \
                    cells[:ze, :ye, :xe]
    return out


def vadvc_prefetch_loop(ustage, upos, utens, utens_stage, wcon, ahead=None,
                        fault=None):
    """The vadvc kernel's prefetch route in plain PyTorch, over all
    columns at once: the forward sweep takes level k's six loads
    (ustage[k + 1] clamped, wcon[k + 1] at x and x + 1, upos, utens,
    utens_stage at k) from slot k % `ahead` of a ring filled `ahead`
    levels before, and refills the slot with level k + ahead's; it keeps
    ccol, dcol and the upos it loaded for the backward sweep, which reads
    nothing else. The arithmetic is the kernel's, each operation rounded
    once in fp32. ``fault`` "stale_slot" skips the first refill, so level
    `ahead` reuses level 0's loads, to show that `exact_check` catches
    such a kernel."""
    from repro_torch.kernels.vadvc.ref import BET_M, BET_P, DTR_STAGE
    from repro_torch.kernels.vadvc.vadvc import AHEAD
    ahead = ahead or AHEAD
    nz = ustage.shape[0]

    def fetch(k):
        if k >= nz:
            return None
        return (ustage[min(k + 1, nz - 1)], wcon[k + 1, :, :-1],
                wcon[k + 1, :, 1:], upos[k], utens[k], utens_stage[k])
    ring = [fetch(j) for j in range(ahead)]
    wsum = wcon[0, :, 1:] + wcon[0, :, :-1]
    u_km1 = u_k = ustage[0]
    c_prev = d_prev = torch.zeros_like(ustage[0])
    ccols, dcols, ucols = [], [], []
    for k in range(nz):
        u_kp1, w0, w1, up, ut, uts = ring[k % ahead]
        if not (fault == "stale_slot" and k == 0):
            ring[k % ahead] = fetch(k + ahead)
        wnext = w1 + w0
        gav, gcv = -0.25 * wsum, 0.25 * wnext
        as_, cs = gav * BET_M, gcv * BET_M
        acol, ccol = gav * BET_P, gcv * BET_P
        corr_lo = -as_ * (u_km1 - u_k)
        corr_hi = -cs * (u_kp1 - u_k)
        first, last = k == 0, k == nz - 1
        corr = corr_hi if first else corr_lo if last else corr_lo + corr_hi
        if first:
            acol = torch.zeros_like(acol)
        if last:
            ccol = torch.zeros_like(ccol)
        bcol = DTR_STAGE - acol - ccol
        rhs = DTR_STAGE * up + ut + uts + corr
        divided = 1.0 / (bcol - c_prev * acol)
        c_prev = ccol * divided
        d_prev = (rhs - d_prev * acol) * divided
        ccols.append(c_prev)
        dcols.append(d_prev)
        ucols.append(up)
        wsum, u_km1, u_k = wnext, u_k, u_kp1
    out = torch.empty_like(ustage)
    nxt = torch.zeros_like(ustage[0])
    for k in range(nz - 1, -1, -1):
        data = dcols[k] - ccols[k] * nxt
        out[k] = DTR_STAGE * (data - ucols[k])
        nxt = data
    return out


def device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call of `fn` in a stream of `calls` calls, the
    median over `reps`: the card is held busy (`torch.cuda._sleep`) while
    the host enqueues the start event, the calls and the end event, so
    the interval holds the device's work and the gaps between launches,
    not the host's enqueueing. A rep whose sleep ended before the host
    finished is run again with a longer sleep."""
    fn()
    torch.cuda.synchronize()
    times, cycles = [], SLEEP_CYCLES
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        if start.query():             # the card had idled: enqueue-bound
            cycles *= 2
            torch.cuda.synchronize()
            continue
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def rotating(args, nbytes):
    """A function returning, call by call, one of enough copies of `args`
    to exceed twice the L2 cache, so that timed calls read their inputs
    from device memory."""
    sets = [args] + [[a.clone() for a in args]
                     for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes))
                                    - 1)]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(sets)
        return sets[state["i"]]
    return nxt


def _ranks(xs):
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    r = [0] * len(xs)
    for rank, i in enumerate(order):
        r[i] = rank
    return r


def spearman(xs, ys) -> float:
    """Rank correlation of two equally long lists (no ties expected)."""
    rx, ry = _ranks(xs), _ranks(ys)
    n = len(xs)
    return 1.0 - 6.0 * sum((a - b) ** 2 for a, b in zip(rx, ry)) \
        / (n * (n * n - 1))


def route_tiles(name, kind, grid, dtype_name) -> list:
    """The tiles of the kernel's tune space route `kind` launches at on
    this grid: the tma route's built tiles whose ring fits, the simt
    route's blocks within the thread and shared-memory limits."""
    from repro_torch.core.autotune import MAX_THREADS, SMEM_BYTES
    from repro_torch.kernels import registry
    spec = registry.get(name)
    names = sorted(spec.tune_space)
    tiles = [dict(zip(names, v)) for v in itertools.product(
        *(spec.tune_space[n] for n in names))]
    if name == "hdiff":
        from repro_torch.kernels.hdiff.hdiff import simt_smem_bytes, \
            tma_smem_bytes
        esize = DTYPES[dtype_name].itemsize
        if kind == "tma":
            return [t for t in tiles if tma_smem_bytes(
                t["tile_x"], t["tile_y"], t["block_z"], esize)
                <= SMEM_BYTES]
        return [t for t in tiles if t["tile_x"] * t["tile_y"] <= MAX_THREADS
                and simt_smem_bytes(t["tile_x"], t["tile_y"],
                                    t["block_z"]) <= SMEM_BYTES]
    from repro_torch.kernels.vadvc.vadvc import PREFETCH_MAX_THREADS, \
        simt_smem_bytes, smem_bytes
    threads, smem = (PREFETCH_MAX_THREADS, smem_bytes) \
        if kind == "prefetch" else (MAX_THREADS, simt_smem_bytes)
    return [t for t in tiles if t["tile_x"] * t["tile_y"] <= threads
            and smem(grid[0], t["tile_x"], t["tile_y"]) <= SMEM_BYTES]


def stencil_launch(name, args, tile, kind):
    """One launch of route `kind` at `tile` through the wrapper's
    `launch` (no checks, no counts); returns the output."""
    if name == "hdiff":
        from repro_torch.kernels.hdiff.hdiff import launch
        out = torch.empty_like(args[0])
        launch(args[0], out, tile["tile_x"], tile["tile_y"],
               tile["block_z"], kind)
        return out
    from repro_torch.kernels.vadvc.vadvc import launch
    out = torch.empty_like(args[0])
    launch(*args, out, tile["tile_x"], tile["tile_y"], kind)
    return out


# beside the spec cases: grids ragged against every tile (nz, ny, nx),
# grids whose rows are not a multiple of 16 bytes (hdiff: simt only), and
# vadvc's short columns
STENCIL_EDGE_GRIDS = {
    "hdiff": (((5, 37, 72), "float32"), ((3, 21, 40), "bfloat16"),
              ((4, 19, 50), "float32"), ((2, 13, 36), "bfloat16")),
    "vadvc": (((3, 5, 45), "float32"), ((1, 6, 40), "float32"),
              ((2, 7, 33), "float32")),
}


def stencil_cases():
    """Every spec case of hdiff and vadvc and the edge grids of
    `STENCIL_EDGE_GRIDS`, on each route the grid can take (hdiff's tma
    route only on rows a multiple of 16 bytes), at every tile of the
    kernel's tune space the route launches at: held to the plain version
    on the same inputs under `EXACT_RULE`. Through the wrapper (the route
    `route` picks: the new route on every spec case), also against the
    plain version on fp32 inputs under the spec's tolerance."""
    from repro_torch.kernels import api, registry
    from repro_torch.kernels.hdiff.hdiff import route as hdiff_route
    for name in ("hdiff", "vadvc"):
        spec = registry.get(name)
        grids = [(dict(c.shape), c.dtype, f"case {i}")
                 for i, c in enumerate(spec.cases)]
        grids += [(dict(zip(spec.shape_keys, g)), d, "edge")
                  for g, d in STENCIL_EDGE_GRIDS[name]]
        for shape, dtype_name, label in grids:
            inputs = spec.example_inputs(shape=shape)
            args32 = [torch.from_numpy(v).cuda() for v in inputs.values()]
            args = [a.to(DTYPES[dtype_name]) for a in args32]
            grid = spec.grid_of(*args)
            want = api.run(name, *args, backend="ref")
            kinds = STENCIL_ROUTES[name]
            if name == "hdiff" and hdiff_route(args[0].dtype,
                                               grid[2]) == "simt":
                kinds = ("simt",)
            tiles, mismatches = {}, {}
            for kind in kinds:
                ts = route_tiles(name, kind, grid, dtype_name)
                tiles[kind] = len(ts)
                mismatches[kind] = sum(exact_check(
                    stencil_launch(name, args, t, kind), want)["mismatches"]
                    for t in ts)
            taken = route_taken(name, lambda: api.run(  # noqa: B023
                name, *args, backend="auto"))
            want_route = kinds[0]
            got = api.run(name, *args, backend="auto")
            tol_err = (got.float() - api.run(name, *args32, backend="ref")
                       ).abs().max().item()
            tol = spec.tol[dtype_name]
            row = {"phase": "stencil", "kernel": name, "case": label,
                   "shape": shape, "dtype": dtype_name, "route": taken,
                   "tiles": tiles, "mismatches": mismatches,
                   "max_abs_err_vs_fp32_plain": tol_err, "tol": tol}
            emit(row)
            if any(mismatches.values()) or taken != want_route \
                    or not tol_err <= tol:
                raise AssertionError(f"{name} {label} {shape}: {row}")


def stencil_grid(name, dtype_name) -> dict:
    """One kernel at the COSMO grid (the spec's bench shape): the knee
    tile (`backend="auto"`, which must take the new route) against the
    plain version under `EXACT_RULE`, the broken variant above it; then
    device times at every tile of the route beside the cost model's
    estimate, the knee's time against the fastest tile's, the plain
    version's time and the bound; then the first port (route simt: hdiff
    at PR 14's knee, from its model and tune space; vadvc at the same
    tile) against the new route in 10 alternating pairs."""
    from repro_torch.core.autotune import (LAUNCH_OVERHEAD_S, autotune,
                                           autotune_kernel, dtype_nbytes)
    from repro_torch.kernels import api, registry
    spec = registry.get(name)
    inputs = spec.example_inputs(shape=dict(spec.bench_shape))
    args = [torch.from_numpy(v).cuda().to(DTYPES[dtype_name])
            for v in inputs.values()]
    grid = spec.grid_of(*args)
    new = STENCIL_ROUTES[name][0]
    tune = autotune_kernel(spec, grid, dtype_name)
    knee = api.resolve_tile(spec, args)
    if knee != tune["knee"].params:
        raise AssertionError(f"{name}: resolve_tile {knee} is not the knee "
                             f"{tune['knee'].params}")
    want = api.run(name, *args, backend="ref")
    taken = route_taken(name, lambda: api.run(name, *args, backend="auto"))
    got = api.run(name, *args, backend="auto")
    torch.cuda.synchronize()
    check = exact_check(got, want)
    variant, fault = STENCIL_FAULTS[name]
    broken = exact_check(variant(*args, fault=fault), want)
    if check["mismatches"] or not broken["mismatches"] or taken != new:
        raise AssertionError(f"{name} {dtype_name}: route {taken}, kernel "
                             f"{check}, broken variant {fault} {broken} "
                             f"({EXACT_RULE})")
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    w = work_of(name, *args)
    nbytes, flops = w["bytes"], sum(w["flops"].values())
    del got
    nxt = rotating(args, in_bytes)
    tiles = []
    for c in tune["candidates"]:
        if c.feasible:
            tiles.append({"tile": c.params, "smem": c.smem_bytes,
                          "est_ms": c.est_time_s * 1e3,
                          "ms": device_ms(lambda t=c.params: api.run(
                              name, *nxt(), backend="cuda", tile=t))})
    kernel_ms = device_ms(lambda: api.run(name, *nxt(), backend="auto"))
    warm_ms = device_ms(lambda: api.run(name, *args, backend="auto"))
    times = cuda_ms({"plain": lambda: api.run(name, *nxt(), backend="ref")},
                    warmup=1, rounds=5)
    fastest = min(tiles, key=lambda r: r["ms"])
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    if name == "hdiff":
        from repro_torch.kernels.hdiff.spec import SIMT_TUNE_SPACE, \
            simt_cost
        old_tile = autotune(simt_cost, grid, SIMT_TUNE_SPACE,
                            dtype_nbytes(dtype_name))["knee"].params
    else:
        old_tile = knee
    check_old = exact_check(stencil_launch(name, args, old_tile, "simt"),
                            want)
    if check_old["mismatches"]:
        raise AssertionError(f"{name} {dtype_name} simt at {old_tile}: "
                             f"{check_old}")
    pairs = scan_before_after(
        name, "simt", new, lambda kind: stencil_launch(
            name, nxt(), old_tile if kind == "simt" else knee, kind),
        f"{name} COSMO grid {dtype_name}, simt at {old_tile}, {new} at "
        f"{knee}", phase="stencil")
    row = {"phase": "stencil", "case": f"{name} COSMO grid {dtype_name}",
           "kernel": name, "dtype": dtype_name, "route": taken,
           "shape": dict(zip(spec.shape_keys, grid)),
           "knee": knee, "knee_est_ms": tune["knee"].est_time_s * 1e3,
           "max_abs_err": check["max_abs_err"], "tol": 0.0,
           "tol_rule": EXACT_RULE, "mismatches": check["mismatches"],
           "max_err_over_limit": 0.0,
           "broken": {fault: broken},
           "kernel_ms": kernel_ms, "warm_ms": warm_ms,
           "plain_ms": times["plain"][0], "library_ms": None,
           "library": f"none: no single PyTorch call computes {name}"
                      + (" (its flux limiter)" if name == "hdiff" else
                         " (an assembled tridiagonal solve and its "
                         "epilogue)"),
           "bytes": nbytes, "flops": flops,
           "bound_ms": max(t_bytes, t_flops),
           "bound_by": "bytes" if t_bytes >= t_flops else "operations",
           "fastest": fastest, "knee_over_fastest": kernel_ms / fastest["ms"],
           "est_vs_ms_rank_correlation": spearman(
               [r["est_ms"] for r in tiles], [r["ms"] for r in tiles]),
           "launch_overhead_model_ms": LAUNCH_OVERHEAD_S * 1e3,
           "simt_tile": old_tile,
           "simt_mismatches": check_old["mismatches"],
           "before_after_median_ms": pairs["median_ms"],
           f"{new}_wins": pairs[f"{new}_wins"],
           "tiles": tiles}
    row["bound_share"] = row["bound_ms"] / kernel_ms
    emit(row)
    return row


def stencil_main_path() -> dict:
    """The stencil path's entry point, `weather_stencil.main`, at the
    COSMO grid on the card, with the counts set to 0 just before it: the
    kernel check, the knees and the hdiff sweep through the kernels, every
    launch on the new routes; the sweep must equal the same sweep through
    the plain version on the card."""
    from repro_torch.core import precision as prec
    from repro_torch.kernels import api, registry
    from repro_torch.launch import weather_stencil
    reset_launches()
    t0 = time.perf_counter()
    res = weather_stencil.main(["--grid", "cosmo"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    by_route = {n: routes(n) for n in ("hdiff", "vadvc")}
    fmts = weather_stencil.SWEEP_FORMATS
    # one check each, then the sweep's exact run and one run per format
    want = {n: 0 for n in launches}
    want.update(hdiff=2 + len(fmts), vadvc=1)
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if any(by_route[n][STENCIL_ROUTES[n][0]] != want[n] for n in by_route):
        raise AssertionError(f"routes {by_route}: every launch of the main "
                             f"path must take the new route")
    if any(res["check"].values()):
        raise AssertionError(f"kernel against plain: {res['check']}")
    inputs = registry.get("hdiff").example_inputs(shape=res["grid"],
                                                  dtype=np.float64)
    plain = prec.precision_sweep(api.numpy_fn("hdiff", backend="ref"),
                                 inputs, fmts)
    if plain != res["sweep"] or not all(
            0.0 < r["accuracy_pct"] <= 100.0 for r in plain):
        raise AssertionError(f"sweep {res['sweep']} != plain {plain}")
    row = {"phase": "stencil", "path": "weather_stencil.main(['--grid', "
           "'cosmo'])", "grid": res["grid"], "wall_s": wall_s,
           "launches": launches, "launches_by_route": by_route,
           "check": res["check"],
           "knees": {f"{k[0]} {k[1]}": {"tile": v.params,
                                        "smem": v.smem_bytes,
                                        "est_ms": v.est_time_s * 1e3}
                     for k, v in res["knee"].items()},
           "sweep": res["sweep"], "sweep_equals_plain": True}
    emit(row)
    return row


def stencil_host_profile(top: int = 15) -> dict:
    """`weather_stencil.main(["--grid", "cosmo"])` once more, under
    cProfile: where its host time goes, by cumulative and by own time
    (the program untouched; the profiler's own cost is in the wall
    time)."""
    import cProfile
    import pstats
    from repro_torch.launch import weather_stencil
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    weather_stencil.main(["--grid", "cosmo"])
    torch.cuda.synchronize()
    prof.disable()
    wall_s = time.perf_counter() - t0
    rows = []
    for (path, line, fn), (_, calls, own, cum, _) in \
            pstats.Stats(prof).stats.items():
        where = path.replace(str(ROOT) + "/", "")
        if "site-packages/" in where:
            where = where.split("site-packages/", 1)[1]
        rows.append({"fn": f"{where}:{line}({fn})", "calls": calls,
                     "cum_s": round(cum, 4), "own_s": round(own, 4)})
    row = {"phase": "stencil", "case": "host profile of weather_stencil."
           "main(['--grid', 'cosmo']) under cProfile", "wall_s": wall_s,
           "top_cumulative": sorted(rows, key=lambda r: -r["cum_s"])[:top],
           "top_own": sorted(rows, key=lambda r: -r["own_s"])[:top]}
    emit(row)
    return row


def phase_stencil():
    """NERO's stencils: spec cases and edge grids at every tile on both
    routes, the COSMO grid for hdiff fp32 and bf16 and vadvc fp32 (with
    the before/after pairs), one launch's device time, the main path, then
    the main path's host profile. Returns the grid rows and the main
    path's launches."""
    from repro_torch.kernels import api
    stencil_cases()
    rows = {(n, d): stencil_grid(n, d) for n, d in (
        ("hdiff", "float32"), ("hdiff", "bfloat16"), ("vadvc", "float32"))}
    tiny = torch.randn(1, 16, 64, device="cuda")
    launch_ms = device_ms(lambda: api.run(
        "hdiff", tiny, backend="cuda",
        tile={"tile_x": 64, "tile_y": 16, "block_z": 1}), calls=50)
    emit({"phase": "stencil", "case": "one launch: hdiff of one item "
          "(1 x 16 x 64, tma route) in a stream of 50",
          "launch_ms": launch_ms})
    main_row = stencil_main_path()
    stencil_host_profile()
    torch.cuda.empty_cache()
    return rows, {k: main_row["launches"][k] for k in ("hdiff", "vadvc")}


# ---------------------------------------------------------------------------
# 10. Sibyl: the DQN agent, learned placement and victim ranking
# ---------------------------------------------------------------------------
SIBYL_FAST_PAGES = 64     # the Sibyl serve run's fast tier: below its peak
SIBYL_TRACE_FAST_CAP = 128   # HssEnv fast capacity for the decode trace
# `tests/test_torch_sibyl.py`'s tolerances: the card's agent against the
# CPU agent, per tensor max |card - cpu| <= rtol x max |cpu|
SIBYL_STATE_RTOL = 1e-5
SIBYL_LOSS_RTOL = 1e-5


def _sibyl_copy_state(src, dst):
    """Copy one agent's networks and Adam state into another's."""
    from repro_torch.core.sibyl.agent import PARAM_NAMES
    with torch.no_grad():
        for n in PARAM_NAMES:
            getattr(dst.net, n).copy_(getattr(src.net, n))
            getattr(dst.target, n).copy_(getattr(src.target, n))
            dst.opt_m[n].copy_(src.opt_m[n])
            dst.opt_v[n].copy_(src.opt_v[n])
    dst.opt_step = src.opt_step


def _scaled_err(got, want) -> float:
    """max |got - want| / max |want| over one tensor (both on the CPU)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def sibyl_card_vs_cpu(agent) -> dict:
    """The card's agent (after its run) against a CPU agent started from
    the same state: Q over the first 256 buffered states, then one
    training step on the same minibatch (loss, params, target, moments)."""
    from repro_torch.core.sibyl.agent import (PARAM_NAMES, SibylAgent,
                                              SibylConfig)
    cpu = SibylAgent(SibylConfig(**vars(agent.cfg)), device="cpu")
    _sibyl_copy_state(agent, cpu)
    states = agent.buffer.obs(np.arange(min(256, len(agent.buffer))))
    q_err = _scaled_err(torch.from_numpy(agent.q_batch(states)),
                        torch.from_numpy(cpu.q_batch(states)))
    rows = agent.buffer.gather(np.random.default_rng(0).integers(
        0, len(agent.buffer), agent.cfg.batch_size))
    loss_card = float(agent.train_step(rows))
    loss_cpu = float(cpu.train_step(rows))
    errs = {}
    for kind, a, b in (("params", agent.net.state_dict(),
                        cpu.net.state_dict()),
                       ("m", agent.opt_m, cpu.opt_m),
                       ("v", agent.opt_v, cpu.opt_v)):
        errs[kind] = max(_scaled_err(a[n], b[n]) for n in PARAM_NAMES)
    out = {"states": len(states), "q_scaled_err": q_err,
           "train_loss_card": loss_card, "train_loss_cpu": loss_cpu,
           "train_loss_rel_err": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "train_scaled_err": errs, "rtol": SIBYL_STATE_RTOL}
    if q_err > SIBYL_STATE_RTOL or out["train_loss_rel_err"] > \
            SIBYL_LOSS_RTOL or max(errs.values()) > SIBYL_STATE_RTOL:
        raise AssertionError(f"the card's agent differs from the CPU "
                             f"agent's: {out}")
    return out


def sibyl_host_ms(agent, n: int = 200) -> dict:
    """Host wall time of one `act` (a forward and its readback) and of one
    training step (upload, forward, backward, Adam), each call closed by
    `torch.cuda.synchronize`, medians over `n`. Runs after every
    comparison: it moves the agent's state on."""
    states = agent.buffer.obs(np.arange(min(n, len(agent.buffer))))
    act_ms, train_ms = [], []
    rng = np.random.default_rng(1)
    for i in range(n):
        obs = states[i % len(states)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.act(obs, 2)
        torch.cuda.synchronize()
        act_ms.append((time.perf_counter() - t0) * 1e3)
        rows = agent.buffer.gather(rng.integers(0, len(agent.buffer),
                                                agent.cfg.batch_size))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.train_step(rows)
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t0) * 1e3)
    agent._pending = None
    return {"act_ms_median": statistics.median(act_ms),
            "train_step_ms_median": statistics.median(train_ms),
            "calls": n}


class _Decisions:
    """Wraps a policy for `run_policy` and keeps its actions."""

    def __init__(self, policy):
        self.policy, self.actions = policy, []

    def act(self, obs, n_devices):
        a = self.policy.act(obs, n_devices)
        self.actions.append(a)
        return a

    def feedback(self, reward, next_obs=None):
        self.policy.feedback(reward, next_obs=next_obs)


def sibyl_storage(smi: str) -> dict:
    """`launch/sibyl_storage.main` on the card (rsrch_0, 10,000 requests,
    H&L, FastOnly / CDE / HPS / Sibyl), its decisions recorded; the same
    run with the agent on the CPU (the first decision where the two
    differ); the card's agent against the CPU agent from one state; host
    ms per act and per training step."""
    from repro_torch.core.sibyl import agent as agent_mod
    from repro_torch.core.sibyl.env import HssEnv, hss_config
    from repro_torch.launch import sibyl_storage as storage
    decisions = []
    act = agent_mod.SibylAgent.act

    def recording(self, obs, n_devices):
        a = act(self, obs, n_devices)
        decisions.append(a)
        return a
    agent_mod.SibylAgent.act = recording
    try:
        t0 = time.perf_counter()
        out = storage.main(["--device", "cuda"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        agent_mod.SibylAgent.act = act
    agent = out["agent"]
    if agent.device.type != "cuda" or not decisions:
        raise AssertionError(f"the agent ran on {agent.device}")
    cpu = _Decisions(agent_mod.SibylAgent(agent_mod.SibylConfig(seed=3),
                                          device="cpu"))
    t0 = time.perf_counter()
    cpu_res = agent_mod.run_policy(HssEnv(hss_config("H&L", fast_cap=1024)),
                                   out["trace"], cpu, warmup=2000)
    cpu_wall_s = time.perf_counter() - t0
    first = next((i for i, (a, b) in enumerate(zip(decisions, cpu.actions))
                  if a != b), None)
    if first is None and len(decisions) != len(cpu.actions):
        first = min(len(decisions), len(cpu.actions))
    res = out["results"]
    row = {"phase": "sibyl", "part": "storage", "nvidia_smi": smi,
           "path": "launch.sibyl_storage.main(['--device', 'cuda'])",
           "workload": "rsrch_0", "requests": len(out["trace"]),
           "trace_seed": 1, "warmup": 2000, "hss": "H&L", "fast_cap": 1024,
           "agent_seed": 3, "latency_model": "HssEnv's NVMe + HDD service "
           "model, not times of the card",
           "norm_avg_latency": {k: r["norm"] for k, r in res.items()},
           "avg_latency_us": {k: r["avg_latency_us"] for k, r in res.items()},
           "p99_latency_us": {k: r["p99_latency_us"] for k, r in res.items()},
           "p99_norm": {k: r["p99_latency_us"]
                        / res["fast_only"]["p99_latency_us"]
                        for k, r in res.items()},
           "migrations": {k: r["migrations"] for k, r in res.items()},
           "top_features": out["top_features"],
           "decisions": len(decisions), "training_steps": len(agent.losses),
           "wall_s": wall_s, "cpu_agent": {
               "wall_s": cpu_wall_s, "avg_latency_us":
               cpu_res["avg_latency_us"], "migrations":
               cpu_res["migrations"], "decisions": len(cpu.actions)},
           "first_differing_decision": "none" if first is None else first}
    row["card_vs_cpu"] = sibyl_card_vs_cpu(agent)
    row["host_ms"] = sibyl_host_ms(agent)
    emit(row)
    return row


def _sibyl_placement_cls():
    from repro_torch.serve.placement import SibylPlacement

    class Timed(SibylPlacement):
        """`SibylPlacement` that logs, at each `observe` (one a step), the
        host ms its `place` and `observe` calls took since the last one
        and the decisions they made."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.log, self.slow = [], 0
            self._ms, self._places = 0.0, 0

        def place(self, feats):
            t0 = time.perf_counter()
            tier = super().place(feats)
            self._ms += (time.perf_counter() - t0) * 1e3
            self._places += 1
            self.slow += tier == "slow"
            return tier

        def observe(self, gather_s, fast_hits, slow_hits):
            t0 = time.perf_counter()
            super().observe(gather_s, fast_hits, slow_hits)
            observe_ms = (time.perf_counter() - t0) * 1e3
            self.log.append((self._ms, observe_ms, self._places))
            self._ms, self._places = 0.0, 0
    return Timed


def policy_host_ms(run, policy) -> dict:
    """The Timed policy's per-step log beside the session's: host ms and
    decisions per prefill (the steps that gave first tokens, per first
    token) and per decode step (the rest)."""
    if len(policy.log) != len(run["step_log"]):
        raise AssertionError(f"{len(policy.log)} observes for "
                             f"{len(run['step_log'])} steps")
    pre = [(p + o, n, f) for (p, o, n), (_, f) in
           zip(policy.log, run["step_log"]) if f]
    dec = [(p + o, n) for (p, o, n), (_, f) in
           zip(policy.log, run["step_log"]) if not f]
    n_pre = sum(f for *_, f in pre)
    places = sum(n for *_, n in policy.log)
    return {"per_prefill": sum(ms for ms, *_ in pre) / n_pre,
            "per_decode_step": statistics.mean(ms for ms, _ in dec),
            "per_decode_step_max": max(ms for ms, _ in dec),
            "decisions_per_prefill": sum(n for _, n, _ in pre) / n_pre,
            "decisions_per_decode_step": statistics.mean(
                n for _, n in dec),
            "place_ms_per_call": sum(p for p, *_ in policy.log)
            / max(places, 1),
            "observe_ms_per_call": statistics.mean(
                o for _, o, _ in policy.log),
            "places": places, "slow_places": policy.slow,
            "observes": len(policy.log),
            "training_steps": len(policy.agent.losses)}


def _placement_engine(base, policy, fast_pages):
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    return ServeEngine(base.cfg, params=dict(base.model.weights
                                             .named_parameters()),
                       kv_pool=PagedKVPool(page_tokens=128,
                                           fast_capacity_pages=fast_pages,
                                           placement_policy=policy))


def sibyl_serve(base, smi: str) -> tuple:
    """The serve phase's workload (starcoder2-7b, 32 layers, bf16, its 5
    prompts, 32 new tokens, max_active=2, 128-token pages, one prefill
    pass per prompt) with `SibylPlacement` on the card and a fast tier of
    SIBYL_FAST_PAGES, below the run's peak live pages, so the DQN's int8
    placements and LRU demotion are both reached; in turns with
    `EveryOtherSlow` (Sibyl, every-other, Sibyl, every-other). The first
    Sibyl run is the main path: its launches counted from 0, a
    `DecodeTraceRecorder` on its pool."""
    from repro_torch.core.sibyl.traces import DecodeTraceRecorder
    cfg = base.cfg
    lengths, new = [120, 250, 380, 500, 600], [32] * 5
    timed = _sibyl_placement_cls()
    runs = {"sibyl": [], "every_other_slow": []}
    recorder = launches = paged = None
    for turn in range(2):
        for kind in ("sibyl", "every_other_slow"):
            policy = timed(device="cuda") if kind == "sibyl" \
                else EveryOtherSlow()
            eng = _placement_engine(base, policy, SIBYL_FAST_PAGES)
            reqs = _requests(cfg.vocab_size, lengths, new, 2)
            main = kind == "sibyl" and turn == 0
            if main:
                recorder = eng.kv_pool.recorder = DecodeTraceRecorder()
                reset_launches()
            run = drive_session(eng, reqs, chunked_prefill=False,
                                radix=False)
            if main:
                launches, paged = read_launches(), routes("paged_attention")
                flash = routes("flash_attention")
                eng.kv_pool.recorder = None
            _check_outs(run["outs"], reqs, cfg.vocab_size)
            if eng.kv_pool.live_pages:
                raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
            pool = eng.kv_pool.stats
            out = {"steps": run["steps"], "wall_s": run["wall_s"],
                   "peak_live_pages": run["peak_live_pages"],
                   "ttft_ms": run["ttft_ms"],
                   "decode_ms_per_step": statistics.mean(
                       ms for ms, first in run["step_log"] if not first),
                   "steady_steps": len(run["steady"]),
                   "pool": {k: pool[k] for k in ("fast_hits", "slow_hits",
                                                 "evictions")}}
            if kind == "sibyl":
                out["policy_host_ms"] = policy_host_ms(run, policy)
                if policy.agent.t <= 0 or policy._pending:
                    raise AssertionError(f"agent t={policy.agent.t}, "
                                         f"{len(policy._pending)} pending")
                if policy.agent.device.type != "cuda":
                    raise AssertionError(f"agent on {policy.agent.device}")
                places = out["policy_host_ms"]["places"]
                if not 0 < policy.slow < places or \
                        not pool["fast_hits"] or not pool["slow_hits"]:
                    raise AssertionError(f"one tier unused: {policy.slow} "
                                         f"of {places} pages placed slow, "
                                         f"{out['pool']}")
            if not run["steady"] or any(s != (1, 1) for s in run["steady"]):
                raise AssertionError(f"steady-state transfers "
                                     f"{run['steady']}")
            runs[kind].append(out)
            del eng
    first = runs["sibyl"][0]
    peak = max(r["peak_live_pages"] for rs in runs.values() for r in rs)
    want = {"split": first["steps"] * cfg.num_layers, "wgmma": 0, "simt": 0}
    row = {"phase": "sibyl", "part": "serve", "nvidia_smi": smi,
           "config": SERVE_CONFIG,
           "path": "ServeSession(chunked_prefill=False, radix=False), "
                   "SibylPlacement(device='cuda') as the pool's policy",
           "prompt_lengths": lengths, "max_new": 32, "max_active": 2,
           "page_tokens": 128, "fast_capacity_pages": SIBYL_FAST_PAGES,
           "peak_live_pages": peak, "launches": launches,
           "paged_launches_by_route": paged,
           "flash_launches_by_route": flash,
           "transfers_per_steady_token": 2,
           "turns": "sibyl, every_other_slow, sibyl, every_other_slow",
           "runs": runs}
    emit(row)
    if SIBYL_FAST_PAGES >= peak or not first["pool"]["evictions"]:
        raise AssertionError(f"fast tier {SIBYL_FAST_PAGES} pages, peak "
                             f"{peak}: demotion not reached")
    if launches["paged_attention"] != first["steps"] * cfg.num_layers or \
            paged != want:
        raise AssertionError(f"paged launches {paged}, want {want}")
    if launches["flash_attention"] != len(lengths) * cfg.num_layers or \
            flash["simt"]:
        raise AssertionError(f"flash launches {flash}")
    return row, recorder


def sibyl_exact() -> dict:
    """starcoder2-7b at full width, 2 layers, fp32, TF32 off: the kernel
    run places pages with `SibylPlacement` on the card (its agent
    exploring half the time, so each path reaches the int8 tier) and
    records each decision; the plain-version run replays them. Greedy
    tokens identical for ``generate``, monolithic ``serve`` and the
    default ``serve``."""
    from repro_torch.configs import get_config
    from repro_torch.core.sibyl.agent import SibylAgent, SibylConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.placement import SibylPlacement

    class Recording(SibylPlacement):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.tiers = []

        def place(self, feats):
            tier = super().place(feats)
            self.tiers.append(tier)
            return tier

    class Replay:
        def __init__(self, tiers):
            self.tiers = list(tiers)
            self.n = 0

        def place(self, feats):
            self.n += 1
            return self.tiers[self.n - 1]

    cfg = get_config("starcoder2-7b", num_layers=2, param_dtype="float32",
                     compute_dtype="float32")
    lengths, new = [70, 130, 200, 257], [9, 12, 15, 18]
    v = cfg.vocab_size
    paths = {"generate": lambda e: e.generate(
                 _requests(v, lengths, new, 0), free_pages=True),
             "serve_monolithic": lambda e: e.serve(
                 _requests(v, lengths, new, 1), max_active=2,
                 chunked_prefill=False, radix=False),
             "serve_chunked_radix": lambda e: e.serve(
                 _shared_prefix_requests(v, 150, [20, 90, 45, 130], 10, 2),
                 max_active=2)}
    row = {"phase": "sibyl", "part": "exact",
           "config": "starcoder2-7b full width, 2 layers, fp32",
           "page_tokens": 64, "fast_capacity_pages": 12, "agent_eps": 0.5,
           "identical_tokens": {}, "decisions": {}, "slow_decisions": {}}
    for name, run in paths.items():
        rec = Recording(agent=SibylAgent(SibylConfig(seed=0, eps=0.5),
                                         device="cuda"))
        if rec.agent.device.type != "cuda":
            raise AssertionError(f"agent on {rec.agent.device}")
        eng = ServeEngine(cfg, seed=0, backend="auto", kv_pool=PagedKVPool(
            page_tokens=64, fast_capacity_pages=12, placement_policy=rec))
        want = _tokens(run(eng))
        evictions = eng.kv_pool.stats["evictions"]
        replay = Replay(rec.tiers)
        eng = ServeEngine(cfg, seed=0, backend="ref", kv_pool=PagedKVPool(
            page_tokens=64, fast_capacity_pages=12, placement_policy=replay))
        got = _tokens(run(eng))
        if replay.n != len(rec.tiers):
            raise AssertionError(f"{name}: replayed {replay.n} of "
                                 f"{len(rec.tiers)} decisions")
        row["identical_tokens"][name] = got == want
        row["decisions"][name] = len(rec.tiers)
        row["slow_decisions"][name] = rec.tiers.count("slow")
        row.setdefault("evictions", {})[name] = evictions
        del eng
        torch.cuda.empty_cache()
    emit(row)
    if not all(row["identical_tokens"].values()) or \
            not all(row["slow_decisions"].values()):
        raise AssertionError(f"kernel and plain tokens differ under replayed "
                             f"Sibyl decisions, or no slow page: {row}")
    return row


def overload_spec(serve_row):
    """The reference's overload mix at the serve phase's prompt range,
    arrivals at ARRIVAL_X_SERVICE times its service rate and deadlines at
    DEADLINE_X_STEP times its decode step."""
    from repro_torch.serve import traffic
    service_rps = serve_row["requests"] / serve_row["wall_s"]
    step_s = serve_row["decode_ms_per_step"] / 1e3
    return traffic.MIXES["overload"].override(
        prompt_lens=OVERLOAD_PROMPTS, new_tokens=OVERLOAD_NEW,
        arrival_rate=ARRIVAL_X_SERVICE * service_rps,
        deadlines=tuple(m * step_s for m in DEADLINE_X_STEP))


def warm_preemption(policy, decisions: int = 24):
    """Drive `policy` with seeded (blocked head, 1-3 eligible victims)
    sets and step rewards until its agent holds more transitions than a
    minibatch, and end one transition short of a training step, so the
    replay's first transition trains on the card. Returns the agent's
    training steps so far."""
    from repro_torch.serve.preemption import RequestView
    rng = np.random.default_rng(0)

    def view(i):
        return RequestView(priority=int(rng.integers(0, 2)),
                           deadline_slack_s=float(rng.normal(0, 2)),
                           tokens_done=int(rng.integers(0, 32)),
                           tokens_left=int(rng.integers(0, 32)),
                           prefilling=bool(rng.random() < 0.3),
                           pages=int(rng.integers(1, 160)), admit_seq=i,
                           queue_depth=int(rng.integers(0, 16)))
    every = policy.agent.cfg.train_every
    n = 0
    while n < decisions or (policy.agent.t + 1) % every:
        size = int(rng.integers(2, 5)) if n < decisions else 2
        head, *victims = (view(i) for i in range(size))
        policy.pick(head, victims)
        policy.observe(float(rng.exponential(0.04)),
                       int(rng.integers(0, 2)))
        n += 1
    if len(policy.agent.buffer) < policy.agent.cfg.batch_size:
        raise AssertionError(f"warm-up left {len(policy.agent.buffer)} "
                             f"transitions")
    return policy.agent.opt_step


def sibyl_overload(base, serve_row, smi: str) -> dict:
    """The overload phase's replay with `SibylPreemption(device="cuda")`
    ranking the victims, then with the default LRU policy, in one call:
    every request's outcome, the policy's decisions and an empty pool.
    The Sibyl policy starts from `warm_preemption`, so each second
    transition of the replay takes a training step on the card."""
    import os
    from repro_torch.serve import traffic
    from repro_torch.serve.placement import SibylPreemption
    spec = overload_spec(serve_row)
    out = {}
    for name in ("sibyl", "lru"):
        eng = _shared_engine(base)
        policy = None
        if name == "sibyl":
            policy = SibylPreemption(device="cuda")
            if policy.agent.device.type != "cuda":
                raise AssertionError(f"agent on {policy.agent.device}")
            steps0 = warm_preemption(policy)
            t0, decisions0 = policy.agent.t, policy.decisions
            warm = {"decisions": decisions0, "transitions": t0,
                    "training_steps": steps0}
        os.environ["REPRO_SERVE_DEBUG"] = "1"
        try:
            t0_wall = time.perf_counter()
            summary = traffic.run_trace(eng, spec, max_active=2,
                                        max_queue=16, preempt_policy=policy)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0_wall
        finally:
            del os.environ["REPRO_SERVE_DEBUG"]
        accounted = sum(summary[k] for k in ("n_done", "n_cancelled",
                                             "n_rejected", "n_errors"))
        res = {"slo_attainment": summary["slo_attainment"],
               "deadline_misses": summary["deadline_misses"],
               "preemptions": summary["preemptions"],
               "n_done": summary["n_done"],
               "n_rejected": summary["n_rejected"],
               "n_errors": summary["n_errors"],
               "tpot_p99_ms": summary["tpot"]["p99_ms"],
               "ttft_p99_ms": summary["ttft"]["p99_ms"], "wall_s": wall_s}
        if policy is not None:
            every = policy.agent.cfg.train_every
            res.update(warm_up=warm,
                       decisions=policy.decisions - decisions0,
                       transitions=policy.agent.t - t0,
                       training_steps=policy.agent.opt_step - steps0,
                       agent_t=policy.agent.t,
                       pending=len(policy._pending))
            if summary["preemptions"] and not res["decisions"]:
                raise AssertionError(f"preemptions without decisions: {res}")
            if policy._pending:
                raise AssertionError(f"pending transitions: {res}")
            if res["training_steps"] != policy.agent.t // every - \
                    t0 // every or (res["decisions"] and
                                    not res["training_steps"]):
                raise AssertionError(f"the replay's transitions did not "
                                     f"train as the cadence says: {res}")
        if accounted != spec.n_requests or \
                summary["n_trace"] != spec.n_requests:
            raise AssertionError(f"{name}: {accounted} of {spec.n_requests} "
                                 f"requests accounted for: {summary}")
        if summary["pool_live_pages_end"] or eng.kv_pool.live_pages:
            raise AssertionError(f"{name}: pages left after the run")
        out[name] = res
        del eng
    row = {"phase": "sibyl", "part": "overload", "nvidia_smi": smi,
           "config": SERVE_CONFIG, "mix": "overload",
           "n_requests": spec.n_requests,
           "arrival_rate_rps": spec.arrival_rate,
           "deadlines_s": list(spec.deadlines),
           "path": "traffic.run_trace(preempt_policy=SibylPreemption("
                   "device='cuda') after warm_preemption), then the LRU "
                   "policy",
           **out}
    emit(row)
    return row


def sibyl_decode_trace(recorder, smi: str) -> dict:
    """The serve run's pool events (`DecodeTraceRecorder`: each put a
    write, each gather touch a read, page ids as addresses) replayed
    through `HssEnv` (H&L, SIBYL_TRACE_FAST_CAP pages fast) and
    `run_policy` for the heuristics and Sibyl on the card."""
    from repro_torch.core.sibyl.agent import (SibylAgent, SibylConfig,
                                              run_policy)
    from repro_torch.core.sibyl.env import HssEnv, hss_config
    from repro_torch.core.sibyl.policies import CDE, HPS, FastOnly
    trace = list(recorder.events)
    res = {}
    agent = SibylAgent(SibylConfig(seed=3), device="cuda")
    if agent.device.type != "cuda":
        raise AssertionError(f"agent on {agent.device}")
    for pol in (FastOnly(), CDE(), HPS(), agent):
        env = HssEnv(hss_config("H&L", fast_cap=SIBYL_TRACE_FAST_CAP))
        res[pol.name] = run_policy(env, trace, pol)
    fo = res["fast_only"]["avg_latency_us"]
    row = {"phase": "sibyl", "part": "decode_trace", "nvidia_smi": smi,
           "events": len(trace), "writes": sum(1 for e in trace if e[2]),
           "pages": len({e[0] for e in trace}),
           "hss": "H&L", "fast_cap": SIBYL_TRACE_FAST_CAP,
           "latency_model": "HssEnv's NVMe + HDD service model, not times "
                            "of the card",
           "norm_avg_latency": {k: r["avg_latency_us"] / fo
                                for k, r in res.items()},
           "avg_latency_us": {k: r["avg_latency_us"] for k, r in res.items()},
           "migrations": {k: r["migrations"] for k, r in res.items()},
           "sibyl_training_steps": len(agent.losses)}
    emit(row)
    if not trace or not row["writes"] or row["writes"] == len(trace):
        raise AssertionError(f"decode trace without reads or writes: {row}")
    return row


def phase_sibyl(base, serve_row, smi: str) -> dict:
    """Sibyl (thesis Ch. 7) on the card: the storage simulator, learned
    KV-page placement on the main path, its exactness under replayed
    decisions, learned victim ranking under overload, and the serve run's
    own pool trace replayed through the simulator."""
    rows = {"storage": sibyl_storage(smi)}
    rows["serve"], recorder = sibyl_serve(base, smi)
    rows["exact"] = sibyl_exact()
    rows["overload"] = sibyl_overload(base, serve_row, smi)
    rows["decode_trace"] = sibyl_decode_trace(recorder, smi)
    return rows


# ---------------------------------------------------------------------------
# 11. the remaining model families
# ---------------------------------------------------------------------------
SERVE_PROMPTS = (120, 250, 380, 500, 600)   # the serve phase's workload
MOE_SPAN = "moe_apply"
# the kernels' new launch shapes: (hq, hkv, d) of each family that serves
# through the paged path, and each family's prefill batch at s = 600
PAGED_FAMILIES = ("codeqwen1.5-7b", "granite-moe-3b-a800m",
                  "qwen3-moe-30b-a3b")
FLASH_FAMILIES = (("musicgen-medium", 2), ("codeqwen1.5-7b", 1),
                  ("granite-moe-3b-a800m", 1), ("llama-3.2-vision-11b", 2),
                  ("qwen3-moe-30b-a3b", 5))


@contextlib.contextmanager
def moe_span():
    """Wrap every MoE layer's body (`moe.moe_stats`, which `moe_apply`
    and the layer's MLP tail call) in a `torch.profiler.record_function`
    range named `MOE_SPAN`, so a trace can attribute the MoE layers'
    kernels (`phase_profile(span=...)`)."""
    from repro_torch.models import moe
    plain = moe.moe_stats

    def traced(*args, **kwargs):
        with torch.profiler.record_function(MOE_SPAN):
            return plain(*args, **kwargs)

    moe.moe_stats = traced
    try:
        yield
    finally:
        moe.moe_stats = plain


def family_kernel_rows(gen) -> dict:
    """Paged attention at each paged family's (hq, hkv, d) — g = 1 / d 128
    (codeqwen), g = 3 / d 64 (granite-moe), g = 8 / d 128 (qwen3-moe) —
    at k = 1 and 4 (split route) and k = 128 (wgmma route), bf16, over
    the kernel phase's mixed-tier pool and lengths; flash attention at
    each family's prefill (s = 600, causal, bf16, the batch its path
    gives it). Each row checks its route, is held to 2 ulps of the plain
    version and timed by `device_ms` beside SDPA's; a paged row's bound
    takes the fp32 peak (its pools are fp32), as the kernel phase's do,
    with the bf16 peak's beside it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import api
    from repro_torch.kernels.paged_attention.paged_attention import route
    rows = {}
    layer = 1
    for arch in PAGED_FAMILIES:
        cfg = get_config(arch)
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        shape = dict(b=4, hq=hq, hkv=hkv, d=d, t=128, n_layers=4,
                     lengths=[2048, 700, 1, 1500], dead=[2])
        for k in (1, 4, 128):
            args = decode_inputs(gen, q_dtype=torch.bfloat16, rows=k,
                                 **shape)
            nbytes, flops = bytes_and_flops(args)

            def kernel():
                return api.run("paged_attention", *args, layer,  # noqa: B023
                               backend="cuda")

            taken = route_taken("paged_attention", kernel)
            want = "split" if k < 128 else "wgmma"
            if taken != want or route(torch.bfloat16, k * hq // hkv, d) \
                    != want:
                raise AssertionError(f"paged {arch} k={k}: route {taken}")
            rows[("paged_attention", arch, k)] = compare_and_time(
                f"paged_attention {arch} k={k} bfloat16", kernel,
                lambda: api.run("paged_attention", *args, layer,  # noqa
                                backend="ref"),
                sdpa_yardstick(args, layer, k), nbytes, flops, FP32_FLOPS,
                {"kernel": "paged_attention", "rows": k, "dtype": "bfloat16",
                 "route": taken, "arch": arch, "g": hq // hkv,
                 "shape": shape, "layer": layer,
                 "bound_ms_bf16_peak": max(nbytes / HBM_BYTES_PER_S,
                                           flops / BF16_FLOPS) * 1e3,
                 "library": "scaled_dot_product_attention over K/V "
                            "gathered and dequantized beforehand (omits "
                            "gather and dequant)"}, device=True)
            del args
            torch.cuda.empty_cache()
    for arch, b in FLASH_FAMILIES:
        cfg = get_config(arch)
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = flash_inputs(gen, b=b, sq=600, skv=600, hq=hq, hkv=hkv,
                               d=d, dtype=torch.bfloat16)
        nbytes, flops = flash_bytes_and_flops(q, k, v)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def kernel():
            return api.run("flash_attention", q, k, v, causal=True,  # noqa
                           backend="cuda")

        taken = route_taken("flash_attention", kernel)
        if taken != "wgmma":
            raise AssertionError(f"flash {arch}: route {taken}")
        rows[("flash_attention", arch)] = compare_and_time(
            f"flash_attention {arch} prefill b={b} s=600 causal bfloat16",
            kernel,
            lambda: api.run("flash_attention", q, k, v, causal=True,  # noqa
                            backend="ref"),
            lambda: F.scaled_dot_product_attention(  # noqa: B023
                qt, kt, vt, is_causal=True, enable_gqa=True),
            nbytes, flops, BF16_FLOPS,
            {"kernel": "flash_attention", "dtype": "bfloat16",
             "route": taken, "arch": arch, "g": hq // hkv,
             "shape": {"b": b, "sq": 600, "skv": 600, "hq": hq, "hkv": hkv,
                       "d": d, "causal": True},
             "library": "scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True) on (b, h, s, d) copies made "
                        "beforehand"}, device=True)
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def _family_pool(cfg):
    from repro_torch.serve.kvcache import PagedKVPool
    # 128 fast page groups (one page per layer each) hold the run; every
    # other page goes to the int8 tier, as in the serve phase
    return PagedKVPool(page_tokens=128, fast_capacity_pages=128
                       * cfg.num_layers, placement_policy=EveryOtherSlow())


def _add(total: dict, launches: dict) -> dict:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    return total


QWEN3_LAYERS = 12    # of 48: at 48 the part took 68.5 s of a whole run,
#                      at 24 34-36 s


def families_qwen3(total: dict) -> dict:
    """qwen3-moe-30b-a3b at full width, `QWEN3_LAYERS` of its 48 layers
    (128 experts, bf16, seeded weights drawn on the card): the serve workload's five
    prompts through the default `serve()` (chunked prefill + radix), then
    through one monolithic `generate`; then 8 decode steps of 2 rows
    traced, the MoE layers' kernels attributed through `moe_span`."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("qwen3-moe-30b-a3b", num_layers=QWEN3_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, seed=0, kv_pool=_family_pool(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in eng.model.parameters())
    expert_bytes = sum(p.numel() * p.element_size() for n, p in
                       eng.model.weights.named_parameters()
                       if ".moe." in n and not n.endswith("router"))
    reqs = _requests(cfg.vocab_size, SERVE_PROMPTS, [32] * 5, 2)
    reset_launches()
    run = drive_session(eng, reqs)
    serve_launches = read_launches()
    _add(total, serve_launches)
    _check_outs(run["outs"], reqs, cfg.vocab_size)
    paged = check_paged_routes(run, cfg.num_layers)
    if serve_launches["flash_attention"] or not run["chunked"] \
            or not run["radix"]:
        raise AssertionError(f"default serve() took another path: {run}")
    if not run["steady"] or set(run["steady"]) != {(1, 1)}:
        raise AssertionError(f"steady-state transfers {run['steady']}")
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
    steps0 = eng.stats["decode_steps"]
    prefill0, decode0 = eng.stats["prefill_s"], eng.stats["decode_s"]
    reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(_requests(cfg.vocab_size, SERVE_PROMPTS, [32] * 5,
                                  2), free_pages=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = read_launches()
    _add(total, gen_launches)
    _check_outs(outs, reqs, cfg.vocab_size)
    gen_steps = eng.stats["decode_steps"] - steps0
    flash, paged_gen = routes("flash_attention"), routes("paged_attention")
    if flash != {"wgmma": cfg.num_layers, "simt": 0} or paged_gen != {
            "split": gen_steps * cfg.num_layers, "wgmma": 0, "simt": 0}:
        raise AssertionError(f"generate launches by route: flash {flash}, "
                             f"paged {paged_gen}")
    # routing must not sync the host (the fused step's 2 transfers a
    # token): one MoE layer at the decode and the chunk-fill shapes with
    # any synchronizing call made an error
    moe_p = eng.model.layers[0]["moe"]
    for rows in (1, 128):
        h = torch.randn(2, rows, cfg.d_model, device="cuda",
                        dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe_mod.moe_apply(cfg, moe_p, h)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with moe_span():
        prof = phase_profile(eng, steps=8, span=MOE_SPAN)
    decode_ms = statistics.median(run["narrow_ms"])
    row = {"phase": "families", "part": "qwen3-moe-30b-a3b",
           "config": f"qwen3-moe-30b-a3b, {QWEN3_LAYERS} of 48 layers, 128 "
                     "experts top-8, "
                     "bf16, seeded weights", "init_s": init_s,
           "params": sum(p.numel() for p in eng.model.parameters()),
           "weight_gb": weight_bytes / 1e9, "expert_gb": expert_bytes / 1e9,
           "decode_byte_floor_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
           "prompt_lengths": list(SERVE_PROMPTS), "max_new": 32,
           "max_active": 2, "page_tokens": 128,
           "serve": {"path": "default serve(): chunked prefill + radix",
                     "wall_s": run["wall_s"], "steps": run["steps"],
                     "chunk_steps": len(run["wide_ms"]),
                     "decode_ms_per_step": decode_ms,
                     "chunk_step_ms": statistics.median(run["wide_ms"]),
                     "ttft_ms": run["ttft_ms"],
                     "launches": serve_launches,
                     "paged_launches_by_route": paged,
                     "steady_steps": len(run["steady"]),
                     "transfers_per_steady_token": 2},
           "generate": {"path": "monolithic generate, 5 prompts left-padded "
                                "to 600", "wall_s": gen_s,
                        "prefill_ms_per_request":
                            (eng.stats["prefill_s"] - prefill0) / 5 * 1e3,
                        "decode_ms_per_step":
                            (eng.stats["decode_s"] - decode0) / gen_steps
                            * 1e3, "decode_steps": gen_steps,
                        "launches": gen_launches,
                        "flash_launches_by_route": flash,
                        "paged_launches_by_route": paged_gen},
           "traced_decode": {k: prof[k] for k in (
               "decode_ms_per_step", "traced_ms_per_step",
               "device_busy_share", f"{MOE_SPAN}_share_of_busy",
               f"{MOE_SPAN}_us_per_step", "paged_attention_share_of_busy",
               "kernels_per_step")},
           "moe_host_syncs": "none at k = 1 and 128 "
                             "(torch.cuda.set_sync_debug_mode('error'))",
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return row


def families_cut(total: dict) -> list:
    """The other five families at published widths, cut in depth (4
    layers; llama-3.2-vision-11b 5, one group with its cross layer),
    bf16, seeded weights: codeqwen and granite-moe through the default
    `serve()` on the serve workload, minicpm3 (MLA) through the
    dense-cache `generate`, llama-vision (seeded image embeddings) and
    musicgen (seeded frame embeddings) at the `Model` level: one prefill
    of 2 x 600 positions and 8 dense decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model, pad_caches
    from repro_torch.serve.engine import ServeEngine
    out = []
    for arch in ("codeqwen1.5-7b", "granite-moe-3b-a800m"):
        cfg = get_config(arch, num_layers=4)
        eng = ServeEngine(cfg, seed=0, kv_pool=_family_pool(cfg))
        reqs = _requests(cfg.vocab_size, SERVE_PROMPTS, [32] * 5, 2)
        reset_launches()
        run = drive_session(eng, reqs)
        launches = read_launches()
        _add(total, launches)
        _check_outs(run["outs"], reqs, cfg.vocab_size)
        paged = check_paged_routes(run, cfg.num_layers)
        if set(run["steady"]) != {(1, 1)} or eng.kv_pool.live_pages:
            raise AssertionError(f"{arch}: steady {run['steady']}, "
                                 f"{eng.kv_pool.live_pages} pages left")
        out.append({"phase": "families", "part": arch,
                    "config": f"{arch}, 4 layers, bf16",
                    "path": "default serve(): chunked prefill + radix",
                    "wall_s": run["wall_s"], "steps": run["steps"],
                    "decode_ms_per_step": statistics.median(run["narrow_ms"]),
                    "chunk_step_ms": statistics.median(run["wide_ms"]),
                    "ttft_ms": run["ttft_ms"], "launches": launches,
                    "paged_launches_by_route": paged,
                    "transfers_per_steady_token": 2})
        emit(out[-1])
        del eng
        torch.cuda.empty_cache()
    cfg = get_config("minicpm3-4b", num_layers=4)
    eng = ServeEngine(cfg, seed=0)
    reqs = _requests(cfg.vocab_size, SERVE_PROMPTS, [32] * 5, 2)
    reset_launches()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    _check_outs(outs, reqs, cfg.vocab_size)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"MLA generate launched {launches}")
    out.append({"phase": "families", "part": "minicpm3-4b",
                "config": "minicpm3-4b, 4 layers, bf16",
                "path": "dense-cache generate (no pool), 5 prompts "
                        "left-padded to 600",
                "prefill_ms_per_request": eng.stats["prefill_s"] / 5 * 1e3,
                "decode_ms_per_step": eng.stats["decode_s"]
                / eng.stats["decode_steps"] * 1e3,
                "decode_steps": eng.stats["decode_steps"],
                "launches": launches, "first_tokens": outs[0][:8].tolist()})
    emit(out[-1])
    del eng
    for arch, layers in (("llama-3.2-vision-11b", 5), ("musicgen-medium", 4)):
        cfg = get_config(arch, num_layers=layers)
        model = Model(cfg, device="cuda", seed=0)
        gen = torch.Generator(device="cuda").manual_seed(4)
        b, s, new = 2, 600, 8

        def draw(*shape):
            return torch.randn(shape, generator=gen,  # noqa: B023
                               device="cuda").to(torch.bfloat16)

        kw = {}
        if cfg.external_embed:
            kw["embeds"] = draw(b, s, cfg.d_model)
        else:
            kw["tokens"] = torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device="cuda")
        if cfg.n_img_tokens:
            kw["image_embeds"] = draw(b, cfg.n_img_tokens, cfg.d_model)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.forward_prefill(**kw)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        caches = pad_caches(caches, s + new, cfg)
        tok = torch.argmax(logits, -1)
        t0 = time.perf_counter()
        for step in range(new):
            if cfg.external_embed:
                logits = model.forward_decode(None, caches, s + step,
                                              embeds=draw(b, 1, cfg.d_model))
            else:
                logits = model.forward_decode(tok[:, None], caches, s + step)
                tok = torch.argmax(logits, -1)
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{arch}: non-finite logits")
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / new * 1e3
        launches = read_launches()
        _add(total, launches)
        n_self = sum(m == "attn" for m, _ in cfg.layer_kinds())
        flash = routes("flash_attention")
        if flash != {"wgmma": n_self, "simt": 0} or launches[
                "paged_attention"]:
            raise AssertionError(f"{arch}: launches {launches}, flash {flash}")
        out.append({"phase": "families", "part": arch,
                    "config": f"{arch}, {layers} layers, bf16",
                    "path": "Model.forward_prefill / forward_decode with "
                            + ("image_embeds" if cfg.n_img_tokens
                               else "frame embeds"),
                    "batch": b, "prefill_len": s, "prefill_ms": prefill_ms,
                    "decode_steps": new, "decode_ms_per_step": decode_ms,
                    "launches": launches, "flash_launches_by_route": flash,
                    "logits_shape": list(logits.shape)})
        emit(out[-1])
        del model, caches, logits
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recording(kernel: str):
    """Record the arguments of every ``api.run(kernel, ...)`` call made
    inside the block (detached copies, so later in-place writes do not
    change them and a training step's graph is not kept); yields the list
    of (args, kwargs), the tile the call launched at under ``tile``
    (`_as_launched`)."""
    from repro_torch.kernels import api
    plain_run = api.run
    calls = []

    def run(name, *args, **kwargs):
        if name == kernel:
            calls.append(([a.detach().clone()
                           if isinstance(a, torch.Tensor) else a
                           for a in args],
                          _as_launched(name, args, kwargs)))
        return plain_run(name, *args, **kwargs)

    api.run = run
    try:
        yield calls
    finally:
        api.run = plain_run


def families_exact() -> dict:
    """Kernel path against plain path (``backend="ref"``), 2 layers at
    published widths, fp32, TF32 off: identical greedy tokens for the
    three paged families through `generate` and a k = 4 speculative
    default `serve()`; llama-vision's (5 layers: one group with its cross
    layer, seeded image embeddings) and musicgen's (seeded frame
    embeddings) prefill through the flash kernel: each of its flash
    launches within 2 ulps of the plain version on the launch's own
    inputs, the same greedy token as the plain path, and the logits'
    distance from the plain path's recorded beside the 2-ulp limit (each
    layer's rounding differences feed the next, so the logits of a deep
    stack are not held to one kernel's limit); minicpm3's dense
    `generate` tokens (it runs no kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import api
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    lengths, new = [70, 130, 257], [9, 12, 15]
    row = {"phase": "families", "part": "exact",
           "config": "published widths, fp32, TF32 off; 2 layers "
                     "(llama-3.2-vision-11b 5)",
           "page_tokens": 64, "prompt_lengths": lengths, "max_new": new}
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    def engine(cfg, backend, speculate=0, params=None):
        return ServeEngine(cfg, seed=0, params=params, backend=backend,
                           speculate=speculate, kv_pool=PagedKVPool(
                               page_tokens=64,
                               placement_policy=EveryOtherSlow()))

    for arch in PAGED_FAMILIES:
        cfg = get_config(arch, num_layers=2, **fp32)
        v = cfg.vocab_size
        got = {}
        for backend in ("auto", "ref"):
            eng = engine(cfg, backend)
            toks = {"generate": _tokens(eng.generate(
                _requests(v, lengths, new, 0), free_pages=True))}
            eng4 = engine(cfg, backend, 4,
                          dict(eng.model.weights.named_parameters()))
            toks["serve_speculative_k4"] = _tokens(eng4.serve(
                _requests(v, lengths, new, 3), max_active=2))
            if eng.kv_pool.live_pages or eng4.kv_pool.live_pages:
                raise AssertionError(f"{arch}: pages left in the pool")
            got[backend] = toks
            del eng, eng4
            torch.cuda.empty_cache()
        same = {p: got["auto"][p] == got["ref"][p] for p in got["auto"]}
        row[arch] = {"identical_tokens": same, **got["auto"]}
        if not all(same.values()):
            emit(row)
            raise AssertionError(f"{arch}: kernel and plain tokens differ")
    for arch, layers in (("llama-3.2-vision-11b", 5), ("musicgen-medium", 2)):
        cfg = get_config(arch, num_layers=layers, **fp32)
        model = Model(cfg, device="cuda", seed=0)
        gen = torch.Generator(device="cuda").manual_seed(6)
        kw = {}
        if cfg.external_embed:
            kw["embeds"] = torch.randn(2, 300, cfg.d_model, generator=gen,
                                       device="cuda")
        else:
            kw["tokens"] = torch.randint(0, cfg.vocab_size, (2, 300),
                                         generator=gen, device="cuda")
        if cfg.n_img_tokens:
            kw["image_embeds"] = torch.randn(2, cfg.n_img_tokens,
                                             cfg.d_model, generator=gen,
                                             device="cuda")
        reset_launches()
        with recording("flash_attention") as calls:
            got, _ = model.forward_prefill(**kw, backend="auto")
        launches = read_launches()
        want, _ = model.forward_prefill(**kw, backend="ref")
        per_launch = []
        for a, k in calls:
            rkw, tile = _replay_kw(k)
            per_launch.append({"tile": tile, "err_over_limit": ulp_check(
                api.run("flash_attention", *a, **rkw, backend="cuda",
                        tile=tile),
                api.run("flash_attention", *a, **rkw, backend="ref"))[2]})
        err, tol, over = ulp_check(got, want)
        row[arch] = {"flash_launches": launches["flash_attention"],
                     "per_launch_err_over_limit": per_launch,
                     "prefill_logits_max_abs_err": err,
                     "prefill_logits_tol": tol,
                     "prefill_logits_err_over_limit": over,
                     "same_greedy_token": bool(torch.equal(
                         got.argmax(-1), want.argmax(-1))),
                     "tol_rule": ULP_RULE}
        n_self = sum(m == "attn" for m, _ in cfg.layer_kinds())
        if launches["flash_attention"] != n_self or len(calls) != n_self \
                or not max(r["err_over_limit"] for r in per_launch) <= 1.0 \
                or not row[arch]["same_greedy_token"]:
            emit(row)
            raise AssertionError(f"{arch}: flash launches {launches}, per "
                                 f"launch {per_launch} of the limit, or the "
                                 f"greedy tokens differ")
        del model, got, want, calls
        torch.cuda.empty_cache()
    cfg = get_config("minicpm3-4b", num_layers=2, **fp32)
    eng = ServeEngine(cfg, seed=0)
    row["minicpm3-4b"] = {"dense_generate": _tokens(eng.generate(
        _requests(cfg.vocab_size, lengths, new, 0)))}
    del eng
    torch.cuda.empty_cache()
    emit(row)
    return row


def phase_families() -> dict:
    """The remaining model families on the card (see the module
    docstring's phase 11). Returns the kernel launches of the paths it
    drove, each counted from 0 just before its run."""
    t0 = time.perf_counter()
    total: dict = {}
    family_kernel_rows(torch.Generator(device="cuda").manual_seed(11))
    families_qwen3(total)
    families_cut(total)
    families_exact()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families", "part": "summary", "launches": total,
          "wall_s": time.perf_counter() - t0})
    return total


# ---------------------------------------------------------------------------
# 12. training: forward_train through the kernels' autograd Functions,
#     AdamW with fp32 masters, the trainer, checkpoint and resume
# ---------------------------------------------------------------------------
# the kernels sum in other orders than their plain versions (the fp32
# SSD kernel in 64-position chunks against 256, its forward allowed
# 256 * 2^-23 * sqrt(S) of max |y|); a gradient that sums over every
# position and cancels (mamba2's a_log: 7.7e-5 of its max at S = 1024)
# shows it most. The broken backwards land at 5e-2 and more
TRAIN_GRAD_LIMIT = 2.5e-4
TRAIN_GRAD_RULE = ("per leaf (model) or per input (Function): max |g - "
                   "g_plain| <= 2.5e-4 * max |g_plain|; the loss within "
                   "1e-5 relative")
TRAIN_OC = {"lr": 1e-4, "warmup_steps": 1, "total_steps": 8}
# (arch, layers, batch, seq): fp32, TF32 off, the kernels against
# backend="ref"; recurrentgemma's 2560 positions pass its 2048 window
TRAIN_EXACT = (("starcoder2-7b", 2, 1, 1024), ("mamba2-780m", 2, 2, 1024),
               ("recurrentgemma-2b", 3, 1, 2560))
# (arch, layers, batch, seq, mid-run checkpoint and resume): published
# widths, bf16; recurrentgemma-2b at full depth, mamba2-780m cut to 12 of
# 48 layers and starcoder2-7b to 2 of 32 (its training state at 32
# layers, ~118 GB, does not fit one card): at 48 and 8 layers the phase
# took 279 s of a whole run's 1,030-1,200 s and its limit of 1,200, 58 s
# of it starcoder2's 30.7 GB checkpoint written and read back; at 24 and
# 4, 188-201 s (18.5 GB, 37 s). The card's
# machine allows a call 45 GiB of disk writes: mamba2's and starcoder2's
# checkpoints fit, recurrentgemma-2b's (49.7 GB) alone does not, so it
# trains its 4 steps in one run
TRAIN_FULL = (("mamba2-780m", 12, 4, 2048, True),
              ("recurrentgemma-2b", 26, 1, 4096, False),
              ("starcoder2-7b", 2, 2, 2048, True))
TRAIN_STRAIGHT = ("mamba2-780m",)     # resumed == straight, to the bit
TRAIN_PLAIN_TURNS = ("mamba2-780m", "starcoder2-7b")   # RG-LRU's plain
# step is a Python loop over 4096 positions: not timed at full depth
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"
# the Functions at full width: flash (label, b, s, hq, hkv, d, window),
# SSD (B, S, H, P, G, N), RG-LRU (B, S, W)
TRAIN_FLASH_SHAPES = (("starcoder2-7b", 2, 2048, 36, 4, 128, 0),
                      ("recurrentgemma-2b", 1, 4096, 10, 1, 256, 2048))
TRAIN_SSD_SHAPE = (4, 2048, 48, 64, 1, 128)
TRAIN_RGLRU_SHAPE = (1, 4096, 2560)


def expected_train_launches(cfg) -> dict:
    """Kernel launches of one training step: each attention, SSD and
    RG-LRU layer's forward once, once more in the backward where its group
    is rematerialised (tail layers are not), and one reverse RG-LRU scan
    per RG-LRU layer in the backward."""
    from repro_torch.configs.base import ATTN, LOCAL_ATTN, RGLRU, SSD
    n_group_layers = cfg.num_layers // cfg.group_size() * cfg.group_size()
    out = {"flash_attention": 0, "ssd_scan": 0, "rglru_scan": 0}
    for i, (mixer, _) in enumerate(cfg.layer_kinds()):
        runs = 1 + int(cfg.remat != "none" and i < n_group_layers)
        if mixer in (ATTN, LOCAL_ATTN):
            out["flash_attention"] += runs
        elif mixer == SSD:
            out["ssd_scan"] += runs
        elif mixer == RGLRU:
            out["rglru_scan"] += runs + 1
    return out


@contextlib.contextmanager
def patched(module, name, fn):
    """`module.name` replaced by `fn` for the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def train_broken_variants():
    """name -> (module, attribute, broken function): the RG-LRU backward's
    reverse scan without the one-step shift of a; the flash backward's
    recompute without the window."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rglru_scan import rglru_scan as rg
    exact_vjp = fa.attention_vjp

    def lru_vjp_unshifted(a, h, grad_h, chunk=None):
        lam = rg.rglru_scan(a.flip(1).contiguous(),
                            grad_h.flip(1).contiguous()).flip(1)
        h_prev = torch.zeros_like(h)
        h_prev[:, 1:] = h[:, :-1]
        return lam * h_prev, lam

    def attention_vjp_no_window(q, k, v, g, *, causal, window,
                                softmax_scale):
        return exact_vjp(q, k, v, g, causal=causal, window=0,
                         softmax_scale=softmax_scale)

    return {"rglru_no_shift": (rg, "lru_vjp", lru_vjp_unshifted),
            "flash_no_window": (fa, "attention_vjp",
                                attention_vjp_no_window)}


def grad_ratios(got, want) -> dict:
    """name -> max |got - want| / max |want|."""
    out = {}
    for name in want:
        w = want[name].float()
        out[name] = float((got[name].float() - w).abs().max()
                          / w.abs().max().clamp_min(1e-30))
    return out


def _worst(ratios: dict) -> list:
    name = max(ratios, key=ratios.get)
    return [name, ratios[name]]


def _train_batch(cfg, seq, batch, step=0):
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.trainer import batch_to
    return batch_to(TokenPipeline(cfg, seq, batch, seed=0).batch_at(step),
                    "cuda")


def model_grads(model, batch, backend):
    from repro_torch.train.train_step import make_loss_fn
    params = model.train_params()
    total, mets = make_loss_fn(model, backend)(batch)
    grads = torch.autograd.grad(total, list(params.values()))
    return mets["loss"].item(), dict(zip(params, grads))


def train_exact_model(arch, layers, batch, seq) -> dict:
    """Loss and every parameter's gradient through the kernels against the
    same step through the plain versions, fp32; for recurrentgemma-2b the
    two broken backwards must land over the limit."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    cfg = get_config(arch, num_layers=layers, param_dtype="float32",
                     compute_dtype="float32")
    model = Model(cfg, device="cuda", seed=0)
    data = _train_batch(cfg, seq, batch)
    reset_launches()
    loss, got = model_grads(model, data, "auto")
    launches = read_launches()
    want_launches = expected_train_launches(cfg)
    if {k: launches[k] for k in want_launches} != want_launches:
        raise AssertionError(f"{arch}: launches {launches}, want "
                             f"{want_launches}")
    plain_loss, want = model_grads(model, data, "ref")
    ratios = grad_ratios(got, want)
    row = {"arch": arch, "layers": layers, "batch": batch, "seq": seq,
           "loss": loss, "plain_loss": plain_loss,
           "loss_rel_err": abs(loss - plain_loss) / abs(plain_loss),
           "leaves": len(ratios), "worst_leaf": _worst(ratios),
           "launches": {k: launches[k] for k in want_launches}}
    if row["loss_rel_err"] > 1e-5 or row["worst_leaf"][1] > TRAIN_GRAD_LIMIT:
        raise AssertionError(f"train exact {arch}: {row}")
    if cfg.lru_width:
        row["broken"] = {}
        for name, (mod, attr, fn) in train_broken_variants().items():
            with patched(mod, attr, fn):
                _, bad = model_grads(model, data, "auto")
            worst = _worst(grad_ratios(bad, want))
            row["broken"][name] = worst
            if worst[1] <= TRAIN_GRAD_LIMIT:
                raise AssertionError(f"broken {name} within the limit: "
                                     f"{worst}")
    del model, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _grads_of(fn, inputs, weights):
    """(gradients of sum(out * weight) over `inputs`, the outputs
    detached)."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs[:len(weights)], leaves, weights)
    return grads, tuple(o.detach() for o in outs)


def forward_check(name, route, want_route, check, rule, got, want) -> dict:
    """A Function's forward output against the plain version's on the
    same inputs by the kernel phase's `check`, on the route the kernel
    phase holds at these dtypes. Raises when over the limit or off the
    route."""
    err, tol, over = check(got, want)
    out = {"route": route, "forward_max_abs_err": err, "forward_tol": tol,
           "forward_tol_rule": rule, "forward_err_over_limit": over}
    if route != want_route or not over <= 1.0:
        raise AssertionError(f"{name} forward: route {route} (want "
                             f"{want_route}), {over:.2f}x the limit")
    return out


def function_rows(gen) -> list:
    """Each Function at full width against the plain version on the same
    inputs: its forward output (the kernel's, on the wgmma route for flash
    and SSD, the chunked route for RG-LRU) by the kernel phase's limits,
    its backward against autograd of the plain version, with the broken
    variants over the limit, and the forward + backward timed (CUDA
    events in turns): through the Function, through the plain version,
    through one PyTorch call where there is one (SDPA). Flash's and SSD's
    backwards recompute the plain version from the saved inputs, so
    their gradient ratio is plain against plain (0 but for the order of
    atomics); the kernel is held by the forward check."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rglru_scan import ref as rref
    from repro_torch.kernels.rglru_scan import rglru_scan as rg
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    broken = train_broken_variants()
    rows = []

    def check(name, got, want, shape, extra):
        ratios = {f"d{i}": r for i, r in enumerate(grad_ratios(
            dict(enumerate(got)), dict(enumerate(want))).values())}
        row = {"function": name, "shape": shape,
               "worst_input": _worst(ratios), **extra}
        if row["worst_input"][1] > TRAIN_GRAD_LIMIT:
            raise AssertionError(f"{name} backward over the limit: {row}")
        return row

    def timed(fns, rounds=10):
        t = cuda_ms(fns, warmup=2, rounds=rounds)
        return {f"{n}_fwd_bwd_ms": v[0] for n, v in t.items()}

    for label, b, s, hq, hkv, d, window in TRAIN_FLASH_SHAPES:
        q = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        w = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        kw = {"causal": True, "window": window}
        reset_launches()
        got, out = _grads_of(lambda *x: fa.flash_attention(*x, **kw),
                             (q, k, v), (w,))
        launched = read_launches()["flash_attention"]
        want, plain = _grads_of(lambda *x: fref.attention(*x, **kw),
                                (q, k, v), (w,))
        extra = {"launches": launched, **forward_check(
            f"flash_attention ({label})", route_taken(
                "flash_attention", lambda: fa.flash_attention(q, k, v, **kw)),
            "wgmma", ulp_check, ULP_RULE, out[0], plain[0])}
        if window:
            mod, attr, fn = broken["flash_no_window"]
            with patched(mod, attr, fn):
                bad, _ = _grads_of(lambda *x: fa.flash_attention(*x, **kw),
                                   (q, k, v), (w,))
            extra["broken_flash_no_window"] = _worst(grad_ratios(
                dict(enumerate(bad)), dict(enumerate(want))))
            if extra["broken_flash_no_window"][1] <= TRAIN_GRAD_LIMIT:
                raise AssertionError(f"flash without the window backward "
                                     f"within the limit: {extra}")
        g = hq // hkv
        kr, vr = (x.repeat_interleave(g, dim=2).transpose(1, 2)
                  for x in (k, v))
        mask = None
        if window:
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)

        def sdpa(*x):
            out = F.scaled_dot_product_attention(
                x[0].transpose(1, 2), x[1], x[2], attn_mask=mask,
                is_causal=mask is None)
            return out.transpose(1, 2)

        extra.update(timed({
            "function": lambda: _grads_of(
                lambda *x: fa.flash_attention(*x, **kw), (q, k, v), (w,)),
            "plain": lambda: _grads_of(
                lambda *x: fref.attention(*x, **kw), (q, k, v), (w,)),
            "library": lambda: _grads_of(sdpa, (q, kr, vr), (w,))}))
        rows.append(check(f"flash_attention ({label})", got, want,
                          [b, s, hq, hkv, d, window], extra))
        del q, k, v, w, kr, vr, got, want

    B, S, H, P, G, N = TRAIN_SSD_SHAPE
    x = torch.randn(B, S, H, P, generator=gen, device="cuda").bfloat16()
    bm = torch.randn(B, S, G, N, generator=gen, device="cuda").bfloat16()
    cm = torch.randn(B, S, G, N, generator=gen, device="cuda").bfloat16()
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device="cuda") - 2)
    a = -torch.rand(H, generator=gen, device="cuda") * 4 - 0.5
    wy = torch.randn(B, S, H, P, generator=gen, device="cuda")
    inputs = (x, bm, cm, dt, a)
    reset_launches()
    got, out = _grads_of(ssd.ssd_scan, inputs, (wy,))
    extra = {"launches": read_launches()["ssd_scan"]}
    want, plain = _grads_of(sref.ssd_chunked, inputs, (wy,))
    extra.update(forward_check(
        "ssd_scan (mamba2-780m)",
        route_taken("ssd_scan", lambda: ssd.ssd_scan(*inputs)), "wgmma",
        ssd_check, SSD_LIMIT_RULE, out, plain))
    extra.update(timed({
        "function": lambda: _grads_of(ssd.ssd_scan, inputs, (wy,)),
        "plain": lambda: _grads_of(sref.ssd_chunked, inputs, (wy,))}))
    rows.append(check("ssd_scan (mamba2-780m)", got, want, [B, S, H, P, G, N],
                      extra))
    del x, bm, cm, dt, a, wy, inputs, got, want

    B, S, W = TRAIN_RGLRU_SHAPE
    a = torch.rand(B, S, W, generator=gen, device="cuda") * 0.5 + 0.5
    bb = torch.randn(B, S, W, generator=gen, device="cuda")
    w = torch.randn(B, S, W, generator=gen, device="cuda")
    reset_launches()
    got, out = _grads_of(rg.rglru_scan, (a, bb), (w,))
    extra = {"launches": read_launches()["rglru_scan"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, plain = _grads_of(rref.lru_scan, (a, bb), (w,))
    torch.cuda.synchronize()
    extra["plain_fwd_bwd_ms_once"] = (time.perf_counter() - t0) * 1e3
    extra.update(forward_check(
        "rglru_scan (recurrentgemma-2b)",
        route_taken("rglru_scan", lambda: rg.rglru_scan(a, bb)), "chunked",
        ulp_check, ULP_RULE, out[0], plain[0]))
    mod, attr, fn = broken["rglru_no_shift"]
    with patched(mod, attr, fn):
        bad, _ = _grads_of(rg.rglru_scan, (a, bb), (w,))
    extra["broken_rglru_no_shift"] = _worst(grad_ratios(
        dict(enumerate(bad)), dict(enumerate(want))))
    if extra["broken_rglru_no_shift"][1] <= TRAIN_GRAD_LIMIT:
        raise AssertionError(f"RG-LRU without the shift within the limit: "
                             f"{extra}")
    extra.update(timed({
        "function": lambda: _grads_of(rg.rglru_scan, (a, bb), (w,))}))
    rows.append(check("rglru_scan (recurrentgemma-2b)", got, want, [B, S, W],
                      extra))
    return rows


TRAIN_RANGES = ("forward", "backward", "optimizer", "remat_recompute",
                "vjp", "plain_recompute")


def traced_train_step(model, state, batch, oc) -> dict:
    """One training step under `torch.profiler`, its forward, backward and
    optimizer in named ranges, and inside the backward: the remat groups'
    forward rerun ("remat_recompute": a layer run while autograd
    executes), the flash / SSD Functions' backwards ("vjp") and, within
    them, the plain version's forward they recompute
    ("plain_recompute"). Device busy share, the top device ops, the
    recompute's share of the backward's device time and the vjps'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_step import make_loss_fn
    from repro_torch.models import transformer
    params = state["params"]
    layer = transformer.layer_tp

    def traced_layer(*args, **kw):
        if torch._C._current_graph_task_id() == -1:
            return layer(*args, **kw)
        with record_function("remat_recompute"):
            return layer(*args, **kw)

    def ranged(name, fn):
        def inner(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return inner

    with patched(transformer, "layer_tp", traced_layer), \
            patched(fa, "attention_vjp", ranged("vjp", fa.attention_vjp)), \
            patched(ssd, "ssd_vjp", ranged("vjp", ssd.ssd_vjp)), \
            patched(fref, "attention",
                    ranged("plain_recompute", fref.attention)), \
            patched(sref, "ssd_chunked",
                    ranged("plain_recompute", sref.ssd_chunked)), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("forward"):
            total, _ = make_loss_fn(model)(batch)
        with record_function("backward"):
            grads = torch.autograd.grad(total, list(params.values()))
        with record_function("optimizer"):
            adamw_update(params, dict(zip(params, grads)), state["opt"], oc)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in TRAIN_RANGES]
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    total_us = sum(e.time_range.elapsed_us() for e in kernels)

    def under(name):
        return sum(_device_us_under(e, name) for e in events
                   if e.name == name and e.device_type == DeviceType.CPU)

    us = {name: under(name) for name in TRAIN_RANGES}
    bwd_us = total_us - us["forward"] - us["optimizer"]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"traced_step_ms": traced_s * 1e3,
            "device_busy_share": busy_us / (traced_s * 1e6),
            "kernels": len(kernels), "device_ms": total_us / 1e3,
            "forward_device_ms": us["forward"] / 1e3,
            "backward_device_ms": bwd_us / 1e3,
            "optimizer_device_ms": us["optimizer"] / 1e3,
            "remat_recompute_device_ms": us["remat_recompute"] / 1e3,
            "vjp_device_ms": us["vjp"] / 1e3,
            "plain_recompute_device_ms": us["plain_recompute"] / 1e3,
            "backward_recompute_share":
                (us["remat_recompute"] + us["plain_recompute"]) / bwd_us,
            "backward_vjp_share": us["vjp"] / bwd_us,
            "top_device_ops_ms": [[n[:80], v / 1e3] for n, v in top]}


def _state_bytes(state) -> int:
    n = 0
    for leaf in state["params"].values():
        n += 2 * leaf.numel() * leaf.element_size()      # params and grads
    for key in ("m", "v", "master"):
        n += sum(t.numel() * t.element_size()
                 for t in state["opt"].get(key, {}).values())
    return n


def _trainer_run(cfg, oc, batch, seq, steps, ckpt=None, save=True):
    """`Trainer.run` over `steps` steps on the card; `save=False` skips
    the run's closing checkpoint (a resumed run's, which is not what is
    tested and would double the disk traffic). Returns (trainer, out)."""
    from repro_torch.train.trainer import Trainer, TrainJobConfig
    tr = Trainer(cfg, oc, TrainJobConfig(
        steps=steps, seq_len=seq, global_batch=batch, checkpoint_every=1000,
        checkpoint_dir=ckpt and str(ckpt), log_every=1), device="cuda")
    if not save:
        tr.ckpt.save = lambda *args, **kw: None
    return tr, tr.run()


def _release():
    """Return the memory of what the caller just deleted to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def train_full(arch, layers, batch, seq, resume, smi) -> tuple:
    """`Trainer` at published widths, bf16 params with fp32 master, m, v,
    4 steps: with `resume`, 2 steps and the trainer's closing checkpoint,
    then a new trainer resuming it for 2 more (for the arch in
    `TRAIN_STRAIGHT` also 4 steps straight, the params equal to the
    bit); without, 4 steps in one run. Launches by kernel and route
    against `expected_train_launches`, finite losses and grad norms,
    every parameter moved. Then, for `TRAIN_PLAIN_TURNS`, kernel and
    plain steps in turns and one traced step. Returns (row, launches of
    the trainers' runs, the straight run's excluded)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro_torch.models.common import flatten
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import batch_to
    cfg = get_config(arch, num_layers=layers)
    oc = OptimizerConfig(**TRAIN_OC)
    d = TRAIN_CKPT_DIR / arch
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    if resume:
        tr, out = _trainer_run(cfg, oc, batch, seq, 2, ckpt=d)
        histories, t_wall = out["history"], [time.perf_counter() - t0]
        ckpt_gb = sum(f.stat().st_size for f in d.rglob("*.npy")) / 1e9
        del tr, out
        _release()
        t0 = time.perf_counter()
        tr, out = _trainer_run(cfg, oc, batch, seq, 4, ckpt=d, save=False)
        histories = histories + out["history"]
        t_wall.append(time.perf_counter() - t0)
        shutil.rmtree(d, ignore_errors=True)
    else:
        tr, out = _trainer_run(cfg, oc, batch, seq, 4)
        histories, t_wall, ckpt_gb = out["history"], [
            time.perf_counter() - t0], None
    launches = read_launches()
    routes = {"flash_attention": dict(flash_attention.launches_by_route),
              "ssd_scan": dict(ssd_scan.launches_by_route),
              "rglru_scan": dict(rglru_scan.launches_by_route)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state, model = out["state"], tr.model
    # the weights every run starts from: the seeded draw, made again
    initial = {n: p.detach().cpu() for n, p in flatten(
        type(model)(cfg, device="cuda", seed=0).params).items()}
    gc.collect()
    torch.cuda.empty_cache()
    per_step = expected_train_launches(cfg)
    want = {k: 4 * v for k, v in per_step.items()}
    want_routes = {"flash_attention": ("wgmma", want["flash_attention"]),
                   "ssd_scan": ("wgmma", want["ssd_scan"]),
                   "rglru_scan": ("chunked", want["rglru_scan"])}
    moved = {n: not torch.equal(initial[n], p.detach().cpu())
             for n, p in state["params"].items()}
    step_ms = [h["step_time_s"] * 1e3 for h in histories]
    row = {"arch": arch, "layers": layers, "of_layers":
           get_config(arch).num_layers, "batch": batch, "seq": seq,
           "params": sum(p.numel() for p in state["params"].values()),
           "steps": [h["step"] for h in histories],
           "resumed_at": histories[2]["step"] if resume else None,
           "losses": [h["loss"] for h in histories],
           "grad_norms": [h["grad_norm"] for h in histories],
           "step_ms": step_ms,
           "tokens_per_s_steps_1_3": [batch * seq / (t / 1e3)
                                       for t in (step_ms[1], step_ms[3])],
           "trainer_wall_s": t_wall, "checkpoint_gb": ckpt_gb,
           "peak_gb": peak_gb, "state_gb": _state_bytes(state) / 1e9,
           "launches": {k: launches[k] for k in want},
           "launches_expected": want, "routes": routes,
           "every_param_moved": all(moved.values()), "nvidia_smi": smi}
    bad = [k for k, (r, n) in want_routes.items()
           if launches[k] != n or routes[k].get(r, 0) != n]
    if bad or not all(math.isfinite(x) for x in row["losses"] +
                      row["grad_norms"]) or not row["every_param_moved"] \
            or (resume and row["resumed_at"] != 2):
        raise AssertionError(
            f"train full {arch}: launches / routes {bad}, not moved "
            f"{[n for n, m in moved.items() if not m]}, {row}")
    if arch in TRAIN_STRAIGHT:
        final = {n: p.detach().clone() for n, p in state["params"].items()}
        del state, model, tr, out
        _release()
        tr, out = _trainer_run(cfg, oc, batch, seq, 4)
        straight = out["state"]["params"]
        row["straight_losses"] = [h["loss"] for h in out["history"]]
        row["resume_bit_equal"] = all(torch.equal(final[n], straight[n])
                                      for n in final)
        row["resume_max_abs_diff"] = max(
            float((final[n].float() - straight[n].float()).abs().max())
            for n in final)
        if not row["resume_bit_equal"]:
            raise AssertionError(f"{arch}: resumed params differ from the "
                                 f"straight run's: {row}")
        del final, straight
        state, model = out["state"], tr.model
    if arch in TRAIN_PLAIN_TURNS:
        pipe = TokenPipeline(cfg, seq, batch, seed=0)
        fns = {"kernel": make_train_step(model, oc),
               "plain": make_train_step(model, oc, backend="ref")}
        times = {"kernel": [], "plain": []}
        step = 4
        for order in (("kernel", "plain"), ("plain", "kernel")):
            for name in order:
                data = batch_to(pipe.batch_at(step), "cuda")
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, mets = fns[name](state, data)
                loss = float(mets["loss"])
                times[name].append((time.perf_counter() - t1) * 1e3)
                if not math.isfinite(loss):
                    raise AssertionError(f"{arch} {name} step loss {loss}")
                step += 1
        row["turns_step_ms"] = times
        row["traced"] = traced_train_step(
            model, state, batch_to(pipe.batch_at(step), "cuda"), oc)
    del state, model, tr, out
    _release()
    return row, launches


def phase_train(smi: str) -> dict:
    """Part ``exact``, then ``functions``, then ``full``, then ``mesh``
    (its ``exact`` and ``full``; one JSON line each). Returns the
    ``full`` trainers' and the plans' launches."""
    t0 = time.perf_counter()
    emit({"phase": "train", "part": "exact", "rule": TRAIN_GRAD_RULE,
          "models": [train_exact_model(*c) for c in TRAIN_EXACT],
          "wall_s": time.perf_counter() - t0})
    gen = torch.Generator(device="cuda").manual_seed(22)
    t1 = time.perf_counter()
    emit({"phase": "train", "part": "functions", "rule": TRAIN_GRAD_RULE,
          "rows": function_rows(gen), "wall_s": time.perf_counter() - t1})
    total: dict = {}
    one: dict = {}
    for arch, layers, batch, seq, resume in TRAIN_FULL:
        t2 = time.perf_counter()
        row, launches = train_full(arch, layers, batch, seq, resume, smi)
        row["wall_s"] = time.perf_counter() - t2
        emit({"phase": "train", "part": "full", **row})
        _add(total, launches)
        one[arch] = row
    t3 = time.perf_counter()
    train_mesh_collectives(smi)
    _add(total, train_mesh_exact(smi))
    for arch, layers, batch, seq in TRAIN_MESH_FULL:
        _, launches = train_mesh_full(arch, layers, batch, seq, one[arch],
                                      smi)
        _add(total, launches)
    emit({"phase": "train", "part": "done", "launches": total,
          "mesh_wall_s": time.perf_counter() - t3,
          "wall_s": time.perf_counter() - t0})
    return total


# -- part ``mesh``: training on a dp x tp plan (`train.sharding`) ----------
TRAIN_MESH_PLANS = ((1, 2), (2, 1), (2, 2))
# (arch, layers, batch, seq): fp32, TF32 off, the kernels on both sides,
# TRAIN_EXACT's models at batch 2 so that each data shard of a 2 x m plan
# takes a row
# (arch, layers, batch, seq, plans, config cuts): since the plan lays
# out what the model axis does not divide, starcoder2-7b also at 1x8 (36
# q heads: attention whole on every shard, the flash kernel at its
# whole-head shape), minicpm3-4b's MLA (latents whole, heads split) and
# qwen3-moe-30b-a3b at 1x8 (32 q / 4 kv heads: each shard's q block reads
# one kv head; its 128 experts cut to 16, every expert replicated on all
# 8 shards)
TRAIN_MESH_EXACT = (
    ("starcoder2-7b", 2, 2, 1024, TRAIN_MESH_PLANS + ((1, 8),), {}),
    ("mamba2-780m", 2, 2, 1024, TRAIN_MESH_PLANS, {}),
    ("recurrentgemma-2b", 3, 2, 2560, TRAIN_MESH_PLANS, {}),
    ("minicpm3-4b", 2, 2, 1024, TRAIN_MESH_PLANS, {}),
    ("qwen3-moe-30b-a3b", 2, 2, 512, ((1, 8),), {"num_experts": 16}))
TRAIN_MESH_EXACT_STEPS = 2
# Adam divides a step by sqrt(v) + eps (1e-8): an element whose gradient
# sits near eps moves by up to lr on rounding noise alone (on the card,
# recurrentgemma-2b's embedding at 2x1: one element 5.2e-5 = 0.52 lr from
# 1x1, its leaf's gradient within 1.9e-5 of max |g|), so the params are
# held by each leaf's update in norm, not element by element
TRAIN_MESH_UPDATE_LIMIT = 1e-2
TRAIN_MESH_RULE = ("against the 1x1 trainer on the same weights and "
                   "batches: step 0's gradient per leaf within "
                   "TRAIN_GRAD_LIMIT of max |g_1x1|; each step's loss and "
                   "grad norm within 1e-5 relative; per leaf, the 2-step "
                   "update's distance from the 1x1 run's, ||p - p_1x1|| / "
                   "||p_1x1 - p_init||, within 1e-2")
# (arch, layers, batch, seq): bf16 at 2x2 through `Trainer(mesh=)`, the
# shapes of `TRAIN_FULL`'s 1x1 trainers, which ran (and were freed) first
TRAIN_MESH_FULL = (("starcoder2-7b", 2, 2, 2048),
                   ("mamba2-780m", 12, 4, 2048))
TRAIN_MESH_FULL_STEPS = 4
# Relative limits against the 1x1 trainer, bf16. The plan's seams add the
# halves of each product in another order than the 1x1 step's one matmul;
# from step 1 on Adam carries that rounding into every weight. Readings
# on the card: step 0's loss 1.7e-6 / 2.7e-6 (starcoder2-7b / mamba2-780m),
# its grad norm 2.1e-4 / 5.2e-6, later losses up to 3.2e-5 / 1.2e-4. A
# lost data shard's rows or model shard's partial sum moves step 0 further
TRAIN_MESH_FULL_RTOL = {"loss_step0": 1e-4, "grad_norm_step0": 2e-3,
                        "loss_later": 1e-3}
TRAIN_KERNELS = ("flash_attention", "ssd_scan", "rglru_scan")
TRAIN_FN_INPUTS = {"flash_attention": 3, "ssd_scan": 5, "rglru_scan": 2}


def _mesh_trainer(cfg, oc, batch, seq, steps, plan_shape):
    """A `Trainer` on a d x m plan (`serve_mesh`), without checkpoints;
    1x1 is the unsharded trainer."""
    from repro_torch.train.trainer import Trainer, TrainJobConfig
    d, m = plan_shape
    return Trainer(cfg, oc, TrainJobConfig(
        steps=steps, seq_len=seq, global_batch=batch, checkpoint_every=1000,
        log_every=1), mesh=serve_mesh(d, m) if d * m > 1 else None,
        device="cuda")


def _trainer_params(tr, out) -> dict:
    """A trainer's weights as logical tensors on the card."""
    if tr.plan is not None:
        return tr.model.logical_params("cuda")
    return {n: p.detach() for n, p in out["state"]["params"].items()}


def update_ratios(got, want, init) -> dict:
    """name -> ||got - want|| / ||want - init||: how far a run's update of
    each leaf lies from another run's, relative to that update."""
    return {n: float(torch.linalg.vector_norm((got[n] - want[n]).float())
                     / torch.linalg.vector_norm(
                         (want[n] - init[n]).float()).clamp_min(1e-30))
            for n in want}


def check_recorded_grads(seen, label) -> list:
    """Each recorded launch shape's backward: the gradients of sum(out *
    w), w seeded, through the kernel's Function (``backend="cuda"`` at
    the tile it ran at)
    against autograd of the plain version on the same inputs, per input
    within `TRAIN_GRAD_LIMIT` of its max. Not the main path's launches:
    counted nowhere."""
    from repro_torch.kernels import api
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows, bad = [], []
    for kernel, calls in seen.items():
        n = TRAIN_FN_INPUTS[kernel]
        for args, kwargs in calls.values():
            kw, tile = _replay_kw(kwargs)
            out = api.run(kernel, *args, **kw, backend="ref")
            y = out[0] if isinstance(out, tuple) else out
            w = torch.randn(y.shape, generator=gen, device="cuda",
                            dtype=torch.float32).to(y.device, y.dtype)

            def through(backend):
                return _grads_of(lambda *x: api.run(
                    kernel, *x, *args[n:], **kw, backend=backend,
                    tile=tile if backend == "cuda" else None),
                    args[:n], (w,))[0]

            ratios = grad_ratios(dict(enumerate(through("cuda"))),
                                 dict(enumerate(through("ref"))))
            row = {"kernel": kernel, "shapes": [list(a.shape)
                                                for a in args[:3]],
                   "tile": tile,
                   "worst_input": _worst({f"d{i}": r for i, r in
                                          ratios.items()}),
                   "limit": TRAIN_GRAD_LIMIT}
            rows.append(row)
            if not row["worst_input"][1] <= TRAIN_GRAD_LIMIT:
                bad.append(row)
    emit({"phase": "train", "part": "grad_checks", "label": label,
          "rule": TRAIN_GRAD_RULE, "checks": rows})
    if bad:
        raise AssertionError(f"{label}: gradients past the limit: {bad}")
    return rows


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def plan_step0_grads(cfg, plan_shape, batch) -> dict:
    """A d x m plan's gradient of every logical leaf at the seeded
    weights (`train_step.plan_grads`, the replicas' copies summed), one
    copy of each distinct slice assembled on the card."""
    from repro_torch.train.sharding import ShardedTrainModel, TrainPlan
    from repro_torch.train.train_step import plan_grads
    plan = TrainPlan(serve_mesh(*plan_shape), cfg)
    model = ShardedTrainModel(cfg, plan, seed=0)
    model.train_params()
    _, _, grads = plan_grads(model, batch)
    plan.reduce_replicas(grads)
    return plan.logical_tree(grads, plan.device(0, 0))


def train_mesh_exact(smi: str) -> dict:
    """Sub-part ``exact``: `TRAIN_MESH_EXACT`'s models at each plan of
    `TRAIN_MESH_PLANS` against the 1x1 trainer on the same weights and
    batches (`TRAIN_MESH_RULE`), launches as `expected_train_launches` a
    step on every shard, every launch shape's forward held by the kernel
    phase's rules (`check_recorded`, recurrentgemma-2b's flash and RG-LRU
    by `magnitude_limit` as in phase ``mesh``) and its backward by
    `check_recorded_grads`. Returns the plans' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten
    from repro_torch.models.transformer import Model
    from repro_torch.serve.sharding import ServePlan
    from repro_torch.train.optimizer import OptimizerConfig
    oc = OptimizerConfig(**TRAIN_OC)
    steps = TRAIN_MESH_EXACT_STEPS
    launches: dict = {}
    for arch, layers, batch, seq, plan_shapes, cuts in TRAIN_MESH_EXACT:
        t0 = time.perf_counter()
        cfg = get_config(arch, num_layers=layers, param_dtype="float32",
                         compute_dtype="float32", **cuts)
        p_init = flatten(Model(cfg, device="cuda", seed=0).params)
        tr = _mesh_trainer(cfg, oc, batch, seq, steps, (1, 1))
        out = tr.run()
        hist_1, p_1 = out["history"], _trainer_params(tr, out)
        del tr, out
        _release()
        data = _train_batch(cfg, seq, batch)
        _, g_1 = model_grads(Model(cfg, device="cuda", seed=0), data, "auto")
        per_step = expected_train_launches(cfg)
        plans, bad = {}, []
        with first_calls(TRAIN_KERNELS) as seen:
            for d, m in plan_shapes:
                reset_launches()
                tr = _mesh_trainer(cfg, oc, batch, seq, steps, (d, m))
                out = tr.run()
                got = {k: v for k, v in read_launches().items()
                       if k in per_step}
                hist, p = out["history"], _trainer_params(tr, out)
                del tr, out
                _release()
                want = {k: steps * d * m * v for k, v in per_step.items()}
                ratios = update_ratios(p, p_1, p_init)
                g_ratios = grad_ratios(plan_step0_grads(cfg, (d, m), data),
                                       g_1)
                row = {"worst_grad_leaf_step0": _worst(g_ratios),
                       "loss_rel_err": [_rel(h["loss"], h1["loss"])
                                        for h, h1 in zip(hist, hist_1)],
                       "grad_norm_rel_err": [
                           _rel(h["grad_norm"], h1["grad_norm"])
                           for h, h1 in zip(hist, hist_1)],
                       "worst_update_leaf": _worst(ratios),
                       "worst_param_abs_diff": _worst({
                           n: float((p[n] - p_1[n]).abs().max())
                           for n in p_1}),
                       "lr": TRAIN_OC["lr"], "launches": got,
                       "launches_expected": want}
                plans[f"{d}x{m}"] = row
                _add(launches, got)
                if max(row["loss_rel_err"] + row["grad_norm_rel_err"]) \
                        > 1e-5 or row["worst_grad_leaf_step0"][1] \
                        > TRAIN_GRAD_LIMIT or row["worst_update_leaf"][1] \
                        > TRAIN_MESH_UPDATE_LIMIT or got != want:
                    bad.append(f"{d}x{m}")
                del p
        magnitude = MESH_MAGNITUDE_HELD.get(arch, ())
        checked = check_recorded(seen, f"train mesh exact {arch}",
                                 magnitude, phase="train")
        grads = check_recorded_grads(seen, f"train mesh exact {arch}")
        if seen["rglru_scan"]:
            shard_kernel_rows({"rglru_scan": seen["rglru_scan"]},
                              f"train mesh exact {arch}")
        del seen, p_1, p_init, g_1, data
        _release()
        row = {"phase": "train", "part": "mesh", "sub": "exact",
               "nvidia_smi": smi, "rule": TRAIN_MESH_RULE,
               "config": f"{arch} full width, {layers} layers, fp32"
               + "".join(f", {k} cut to {v}" for k, v in cuts.items()),
               "batch": batch, "seq": seq, "steps": steps,
               "losses_1x1": [h["loss"] for h in hist_1],
               "plans": plans, "devices": {
                   f"{d}x{m}": mesh_layout(serve_mesh(d, m))
                   for d, m in plan_shapes},
               "whole_sublayers": {
                   f"{d}x{m}": sorted(ServePlan(serve_mesh(d, m))
                                      .whole_sublayers(cfg))
                   for d, m in plan_shapes},
               "launch_shapes_checked": len(checked),
               "worst_forward_over_limit": max(
                   (c["max_err_over_limit"] for c in checked), default=0.0),
               "magnitude_held": list(magnitude),
               "worst_backward": max((c["worst_input"] for c in grads),
                                     key=lambda x: x[1], default=None),
               "wall_s": time.perf_counter() - t0}
        emit(row)
        if bad:
            raise AssertionError(f"train mesh exact {arch}: plans {bad} "
                                 f"outside {TRAIN_MESH_RULE}: {plans}")
    return launches


def train_mesh_collectives(smi: str) -> dict:
    """Sub-part ``collectives``: the plan's reductions over a 2x2 mesh's
    positions (`serve_mesh`: cuda:0-3 on a machine with four cards, the
    NCCL paths; else all on cuda:0, the in-order paths) against the same
    reductions with every part on cuda:0: `compressed_psum` (int8
    all-gather, then each shard's in-order dequantized sum) and the
    replicas' max to the bit; the seam `TrainPlan.psum` over a 1x2 row,
    forward and backward (`AllReduceSum` on two cards), within 1e-6 of
    the largest value."""
    from repro_torch.train import grad_compression as gc
    from repro_torch.serve.sharding import reduce_tensors
    from repro_torch.train.sharding import TrainPlan
    gen = torch.Generator(device="cuda").manual_seed(7)
    devs = list(serve_mesh(2, 2).devices.ravel())
    parts = [torch.randn(4096, 1024, generator=gen, device="cuda") * (i + 1)
             for i in range(4)]
    placed = [p.to(d) for p, d in zip(parts, devs)]
    want = gc.compressed_psum(parts)[0]
    psum_err = max(float((g.to("cuda:0") - want).abs().max())
                   for g in gc.compressed_psum(placed))
    amax = [torch.max(torch.abs(p)) for p in parts]
    max_err = max(float((g.to("cuda:0") - reduce_tensors(amax, "max")[0])
                        .abs()) for g in reduce_tensors(
        [a.to(d) for a, d in zip(amax, devs)], "max"))

    def seam(devices):
        leaves = [p.to(d).requires_grad_() for p, d in zip(parts, devices)]
        outs = TrainPlan.psum([x * x for x in leaves])
        loss = sum((o * (i + 1)).sum().to("cuda:0")
                   for i, o in enumerate(outs))
        grads = torch.autograd.grad(loss, leaves)
        return [t.detach().to("cuda:0") for t in list(outs) + list(grads)]

    row_devs = list(serve_mesh(1, 2).devices.ravel())
    got, ref = seam(row_devs), seam(["cuda:0"] * 2)
    seam_err = max(float((g - w).abs().max() / w.abs().max())
                   for g, w in zip(got, ref))
    row = {"phase": "train", "part": "mesh", "sub": "collectives",
           "nvidia_smi": smi, "devices": [str(d) for d in devs],
           "row_devices": [str(d) for d in row_devs],
           "compressed_psum_max_abs_err": psum_err,
           "replica_max_abs_err": max_err,
           "seam_fwd_bwd_rel_err": seam_err}
    emit(row)
    if psum_err != 0.0 or max_err != 0.0 or not seam_err <= 1e-6:
        raise AssertionError(f"train mesh collectives: {row}")
    return row


def shard_kernel_rows(seen, label) -> list:
    """Each recorded per-shard training launch shape through the kernel
    (``backend="cuda"``) and, for flash, SDPA on the same q, k and v (kv
    heads repeated outside the timing), timed by `device_ms`; the plain
    version by CUDA events, one call (its host may wait on the card, which
    `device_ms`'s queue behind a sleep cannot hold; RG-LRU's is a Python
    loop over positions: not timed); the bound from the spec's `work`.
    These launches are not the main path's and count nowhere."""
    from repro_torch.kernels import api
    rows = []
    for kernel, calls in seen.items():
        for args, kwargs in calls.values():
            kw, tile = _replay_kw(kwargs)

            def run(backend, args=args, kw=kw, kernel=kernel, tile=tile):
                return api.run(kernel, *args, **kw, backend=backend,
                               tile=tile if backend == "cuda" else None)

            work = work_of(kernel, *args, **kw)
            t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = sum(f / PEAKS[c] for c, f in work["flops"].items()) * 1e3
            library = None
            if kernel == "flash_attention":
                q, k, v = args[:3]
                g = q.shape[2] // k.shape[2]
                qt, kt, vt = (x.transpose(1, 2) for x in (
                    q, k.repeat_interleave(g, dim=2),
                    v.repeat_interleave(g, dim=2)))
                if kw.get("window"):
                    raise AssertionError("SDPA yardstick: no window")

                def library(qt=qt, kt=kt, vt=vt):
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
            row = {"kernel": kernel, "label": label, "tile": tile,
                   "shapes": [list(a.shape) for a in args[:3]],
                   "dtype": str(args[0].dtype).replace("torch.", ""),
                   "route": route_taken(kernel, lambda: run("cuda")),
                   "device_ms": device_ms(lambda: run("cuda")),
                   "plain_ms": None if kernel == "rglru_scan"
                   else cuda_ms({"plain": lambda: run("ref")}, warmup=2,
                                rounds=5)["plain"][0],
                   "library_ms": device_ms(library) if library else None,
                   "bytes": work["bytes"], "flops": work["flops"],
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops
                   else "operations"}
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            rows.append(row)
    emit({"phase": "train", "part": "mesh", "sub": "shard_kernels",
          "label": label, "timing": "kernel and library: device_ms, 20 "
          "calls queued behind a sleep, median of 5; plain: CUDA events, "
          "median of 5 calls", "rows": rows})
    return rows


def traced_plan_step(step_fn, state, batch) -> dict:
    """One step of a plan's trainer under `torch.profiler`: wall ms,
    device busy share, kernels launched (every CUDA kernel, not only the
    counted ones) and the top device ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mets = step_fn(state, batch)
        float(mets["loss"])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    kernels = device_events(prof)
    if not kernels:
        raise AssertionError("the traced plan step recorded no device "
                             "activity")
    busy_us = _union_us((start, end) for _, start, end in kernels)
    by_name: dict = {}
    for name, start, end in kernels:
        by_name[name] = by_name.get(name, 0.0) + end - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"traced_step_ms": traced_s * 1e3,
            "device_busy_share": busy_us / (traced_s * 1e6),
            "kernels": len(kernels),
            "device_ms": sum(by_name.values()) / 1e3,
            "top_device_ops_ms": [[n[:80], v / 1e3] for n, v in top]}


def _tensors(tree):
    """Every tensor of a nested dict / list state."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _to_host(state) -> tuple:
    """Move every tensor of `state` to the host in place of its storage,
    so each holder of a tensor (the model, the step) sees the move.
    Returns (seconds, a function that moves each back to its device and
    returns its seconds)."""
    def timed(fn):
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        _release()
        return time.perf_counter() - t0

    homes = {id(t): (t, t.device) for t in _tensors(state)}

    def move(to_host):
        for t, dev in homes.values():
            t.data = t.data.to("cpu" if to_host else dev)

    return timed(lambda: move(True)), lambda: timed(lambda: move(False))


def _timed_step(step_fn, state, data) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, mets = step_fn(state, data)
    loss = float(mets["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(loss):
        raise AssertionError(f"step loss {loss}")
    return state, ms


def plan_turns(cfg, oc, batch, seq, tr, state, data) -> dict:
    """The 2x2 trainer `tr` (its `state`) and a 1x1 trainer of the same
    shapes, one step each in turns 2x2, 1x1, 1x1, 2x2 on the batch
    `data`, never resident together: the idle one's state waits on the
    host. Each timed step follows an untimed step of its own trainer
    since its state last came to the card (the 1x1's first step is
    its allocator's warm-up, as is the 2x2's after its return)."""
    from repro_torch.train.train_step import init_state
    ms = {"2x2": [], "1x1": []}
    state, t = _timed_step(tr._step_fn, state, data)
    ms["2x2"].append(t)
    out_s, back = _to_host(state)
    resident_gb = torch.cuda.memory_allocated() / 1e9
    one = _mesh_trainer(cfg, oc, batch, seq, 1, (1, 1))
    state_1 = init_state(one.model, oc)
    state_1, _ = _timed_step(one._step_fn, state_1, data)
    for _ in range(2):
        state_1, t = _timed_step(one._step_fn, state_1, data)
        ms["1x1"].append(t)
    del one, state_1
    _release()
    moves = [out_s, back()]
    state, _ = _timed_step(tr._step_fn, state, data)
    state, t = _timed_step(tr._step_fn, state, data)
    ms["2x2"].append(t)
    return {"order": ["2x2", "1x1", "1x1", "2x2"], "step_ms": ms,
            "ratio_2x2_over_1x1": (sum(ms["2x2"]) / sum(ms["1x1"])),
            "gb_on_card_with_2x2_on_host": resident_gb,
            "state_move_s": moves}


def train_mesh_full(arch, layers, batch, seq, one, smi) -> tuple:
    """Sub-part ``full``: `Trainer(mesh=)` at 2x2, bf16 params with fp32
    master, m, v, remat, `TRAIN_MESH_FULL_STEPS` steps, after `one`, the
    1x1 trainer's `train_full` row of the same shapes: step ms, tokens/s,
    the state bytes each shard holds against `plan_rescale`'s, peak
    memory, launches by kernel and route (every shard's
    `expected_train_launches` a step, flash and SSD on ``wgmma``, RG-LRU
    ``chunked``), finite losses and grad norms, every step's loss and
    step 0's grad norm against the 1x1 trainer's on the same weights and
    batches (`TRAIN_MESH_FULL_RTOL`); then one more step traced, every
    per-shard launch shape held to its plain version forward
    (`check_recorded`) and backward (`check_recorded_grads`), and 2x2
    and 1x1 steps in turns (`plan_turns`). Returns (row, the trainer's
    launches, the traced and paired steps' excluded)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.ft.elastic import plan_rescale
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import batch_to
    cfg = get_config(arch, num_layers=layers)
    oc = OptimizerConfig(**TRAIN_OC)
    steps = TRAIN_MESH_FULL_STEPS
    label = f"train mesh full {arch}"
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tr = _mesh_trainer(cfg, oc, batch, seq, steps, (2, 2))
    init_s = time.perf_counter() - t0
    with first_calls(TRAIN_KERNELS) as seen:
        out = tr.run()
    launches = read_launches()
    routes = {k: dict(_counters()[k].launches_by_route)
              for k in TRAIN_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    held = tr.model.held_bytes(out["state"]["opt"])
    counted = plan_rescale(cfg, oc, tr.mesh).bytes_per_device
    hist = out["history"]
    step_ms = [h["step_time_s"] * 1e3 for h in hist]
    want = {k: steps * 4 * v for k, v in expected_train_launches(cfg).items()}
    want_route = {"flash_attention": "wgmma", "ssd_scan": "wgmma",
                  "rglru_scan": "chunked"}
    pipe = TokenPipeline(cfg, seq, batch, seed=0)
    t1 = time.perf_counter()
    traced = traced_plan_step(tr._step_fn, out["state"],
                              batch_to(pipe.batch_at(steps), "cuda"))
    traced["wall_s"] = time.perf_counter() - t1
    seen = {k: v for k, v in seen.items() if v}
    shard_rows = shard_kernel_rows(seen, label)
    rel = {"loss_step0": [_rel(hist[0]["loss"], one["losses"][0])],
           "grad_norm_step0": [_rel(hist[0]["grad_norm"],
                                    one["grad_norms"][0])],
           "loss_later": [_rel(h["loss"], w) for h, w in
                          zip(hist[1:], one["losses"][1:])]}
    row = {"phase": "train", "part": "mesh", "sub": "full",
           "nvidia_smi": smi, "arch": arch, "layers": layers,
           "of_layers": get_config(arch).num_layers, "batch": batch,
           "seq": seq, "plan": "2x2", "devices": mesh_layout(tr.mesh),
           "init_s": init_s, "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "losses_1x1": one["losses"], "grad_norms_1x1": one["grad_norms"],
           "rel_err_to_1x1": rel, "rtol": TRAIN_MESH_FULL_RTOL,
           "step_ms": step_ms, "step_ms_1x1": one["step_ms"],
           "tokens_per_s_steps_1_3": [batch * seq / (t / 1e3)
                                       for t in (step_ms[1], step_ms[3])],
           "tokens_per_s_1x1": one["tokens_per_s_steps_1_3"],
           "held_bytes_per_shard": held,
           "plan_rescale_bytes_per_device": counted,
           "peak_gb": peak_gb, "peak_gb_1x1": one["peak_gb"],
           "launches": {k: launches[k] for k in want},
           "launches_expected": want, "routes": routes,
           "launches_per_step": {k: launches[k] / steps for k in want},
           "traced": traced, "shard_kernels": [
               {k: r[k] for k in ("kernel", "shapes", "route", "device_ms",
                                  "bound_ms", "library_ms")}
               for r in shard_rows]}
    bad = [k for k in want if launches[k] != want[k]
           or routes[k].get(want_route[k], 0) != want[k]]
    bad += [k for k, errs in rel.items()
            if not max(errs) <= TRAIN_MESH_FULL_RTOL[k]]
    ok = (not bad and all(h == counted for r in held for h in r)
          and all(math.isfinite(x) for x in row["losses"]
                  + row["grad_norms"]))
    if not ok:
        emit(row)
        raise AssertionError(f"{label}: launches / routes / errors against "
                             f"1x1 {bad}, or held bytes or losses off: "
                             f"{row}")
    checked = check_recorded(seen, label, phase="train")
    grads = check_recorded_grads(seen, label)
    row["launch_shapes_checked"] = len(checked)
    row["worst_forward_over_limit"] = max(c["max_err_over_limit"]
                                          for c in checked)
    row["worst_backward"] = max((c["worst_input"] for c in grads),
                                key=lambda x: x[1])
    del seen
    t2 = time.perf_counter()
    row["turns"] = plan_turns(cfg, oc, batch, seq, tr, out["state"],
                              batch_to(pipe.batch_at(steps + 1), "cuda"))
    row["turns"]["wall_s"] = time.perf_counter() - t2
    row["wall_s"] = time.perf_counter() - t0
    emit(row)
    del tr, out
    _release()
    return row, {k: launches[k] for k in want}


# ---------------------------------------------------------------------------
# 13. napel: the cost counter, the dry run, NAPEL and LEAPER on the card
# ---------------------------------------------------------------------------
NAPEL_TRAIN = (("mamba2-780m", 12, 4, 2048),        # the train phase's shapes
               ("recurrentgemma-2b", 26, 1, 4096),
               ("starcoder2-7b", 2, 2, 2048))
# the serve phase's model and its longest prompt
NAPEL_PREFILL = ("starcoder2-7b", SERVE_LAYERS, 1, 600)
# processes of the meta counts when phase train runs beside them, started
# with it (two cores left to the main process: its host-bound steps)
NAPEL_EARLY_WORKERS = 6
NAPEL_WORKERS = 8            # processes of the meta counts (the 8 cores;
#                              the main process waits on the pool)
NAPEL_CARD_POINTS = 10       # corpus points trained on the card ...
NAPEL_CARD_BYTES = 60e9      # ... whose counted live bytes fit in this
NAPEL_SHOTS = (1, 3, 5)
NAPEL_TIMED_STEPS = 3
ENERGY_LOOP_S = 2.5          # each energy loop runs at least this long
DRYRUN_OUT = ROOT / "experiments" / "dryrun_torch"
CORPUS_OUT = ROOT / "experiments" / "napel_corpus_torch"
# dry-run cells allowed to end in "error", with the reason PERF.md gives
# (substring of the recorded error); none today
DRYRUN_KNOWN_ERRORS: dict = {}
COUNT_KEYS = ("flops_by_class", "bytes_accessed", "bytes_accessed_fused",
              "transcendentals", "collectives", "kernels", "kernel_routes")


def logged_count(fn, *args, inspect=False):
    """(fn(*args), summary, kernel entries, op log, the counter): one call
    under `CostCounter`, each counted op logged with its output shapes so
    two counts that differ show where."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.core.hlo_cost import CostCounter
    log = []

    class Logged(CostCounter):
        def _count(self, func, a, kw, out):
            shapes = [tuple(t.shape) for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)]
            log.append(f"{func} {shapes}")
            return super()._count(func, a, kw, out)

    t0 = time.perf_counter()
    with Logged(inspect=inspect) as c:
        out = fn(*args)
    c.count_s = time.perf_counter() - t0
    entries = [(e["kernel"], e["route"], e["bytes"], e["flops"])
               for e in c.entries]
    return out, c.summary(), entries, log, c


def napel_tokens(cfg, batch: int, seq: int, device: str):
    """Seeded int32 tokens (batch, seq) on `device`; on ``meta``, their
    shape."""
    if device == "meta":
        return torch.empty(batch, seq, dtype=torch.int32, device="meta")
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=device, dtype=torch.int32)


def napel_train_inputs(cfg, batch: int, seq: int, device: str):
    """(model, train step, state, batch) of `cfg` on `device` ("meta"
    builds nothing): seeded weights, a fresh AdamW state, tokens
    (`napel_tokens`; labels the same tensor)."""
    from repro_torch.models import Model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import init_state, make_train_step
    model = Model(cfg, device=device, seed=0)
    oc = OptimizerConfig()
    step = make_train_step(model, oc, num_microbatches=cfg.train_microbatches)
    tok = napel_tokens(cfg, batch, seq, device)
    return model, step, init_state(model, oc), {"tokens": tok, "labels": tok}


def napel_prefill_inputs(cfg, batch: int, seq: int, device: str):
    """(model, prefill step, tokens) of `cfg` on `device`."""
    from repro_torch.models import Model
    from repro_torch.serve.steps import make_prefill_step
    model = Model(cfg, device=device, seed=0)
    return model, make_prefill_step(model), napel_tokens(cfg, batch, seq,
                                                         device)


def _napel_cfg(arch, layers):
    from repro_torch.configs import get_config
    return get_config(arch, num_layers=layers)


def meta_task(task):
    """One count on ``meta`` in a worker process: ("dryrun", arch, shape)
    -> its record (written under experiments/dryrun_torch/); ("corpus",
    tag, params) -> its record (under experiments/napel_corpus_torch/);
    ("train" | "prefill", arch, layers, batch, seq) -> (summary, entries,
    op log, {"count_s", "live_bytes"})."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    torch.set_num_threads(1)
    kind = task[0]
    if kind == "dryrun":
        from repro_torch.launch.dryrun import run_cell
        return run_cell(task[1], task[2], out_dir=DRYRUN_OUT, force=True)
    if kind == "dryrun_pod":
        from repro_torch.launch.dryrun import run_cell
        return run_cell(task[1], task[2], out_dir=DRYRUN_OUT, force=True,
                        mesh=NAPEL_POD)
    if kind == "mesh_count":
        cfg = _napel_cfg(*NAPEL_MESH_COUNT[:2])
        _, step, state, b = mesh_count_inputs(cfg, task[1], "meta")
        return mesh_count_positions(step, state, b)
    if kind == "corpus":
        from repro_torch.core.napel.corpus import (compile_and_measure,
                                                   make_cfg, train_shape)
        tag, p = task[1], dict(task[2])
        cfg = make_cfg(p)
        rec = {**compile_and_measure(cfg, train_shape(p)), "status": "ok",
               "tag": tag, "params": p, "mesh": [1, 1]}
        CORPUS_OUT.mkdir(parents=True, exist_ok=True)
        (CORPUS_OUT / f"{tag}__{cfg.name}__1x1.json").write_text(
            json.dumps(rec))
        return rec
    from repro_torch.launch.dryrun import storage_bytes
    arch, layers, batch, seq = task[1:]
    cfg = _napel_cfg(arch, layers)
    if kind == "train":
        _, step, state, b = napel_train_inputs(cfg, batch, seq, "meta")
        _, summary, entries, log, c = logged_count(step, state, b)
        live = storage_bytes((state, b)) + summary["peak_live_bytes"]
    else:
        model, step, tok = napel_prefill_inputs(cfg, batch, seq, "meta")
        _, summary, entries, log, c = logged_count(step, tok)
        live = storage_bytes((model.params, tok)) + summary["peak_live_bytes"]
    return summary, entries, log, {"count_s": c.count_s, "live_bytes": live}


META_POOL: dict = {}


def start_meta_counts(workers: int = NAPEL_WORKERS) -> None:
    """Start every meta count of phase napel in `workers` processes: the
    dry run's cells at 1x1 and on the 16 x 16 pod, the corpus points, the
    count part's steps and the one-position counts of part
    ``mesh_count``. `napel_meta_counts` collects them."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.core.napel.corpus import corpus_points
    from repro_torch.launch.dryrun import all_cells
    tasks = [("train", *t) for t in NAPEL_TRAIN] \
        + [("prefill", *NAPEL_PREFILL)] \
        + [("mesh_count", shape) for shape in NAPEL_MESH_COUNT[4]] \
        + [("dryrun", a, s) for a, s in all_cells()] \
        + [("dryrun_pod", a, s) for a, s in all_cells()] \
        + [("corpus", tag, tuple(sorted(p.items())))
           for tag, p in corpus_points()]
    # the slowest first, so the pool ends together
    tasks.sort(key=lambda t: (t[0] != "train",
                              not (t[0] == "dryrun_pod"
                                   and t[2] == "train_4k")))
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    done: list = []
    META_POOL.update(pool=pool, workers=workers, done=done,
                     t0=time.perf_counter(), futures={})
    for task in tasks:
        fut = pool.submit(meta_task, task)
        fut.add_done_callback(lambda _: done.append(time.perf_counter()))
        META_POOL["futures"][task] = fut


def stop_meta_counts() -> None:
    """Cancel the meta counts not yet started (a run that failed)."""
    if META_POOL:
        META_POOL.pop("pool").shutdown(wait=False, cancel_futures=True)
        META_POOL.clear()


def napel_meta_counts() -> dict:
    """The meta counts' results (started here unless `start_meta_counts`
    ran before), the pool's wall seconds from its start to its last
    count, and the seconds the phase waited for them."""
    if not META_POOL:
        start_meta_counts()
    t0 = time.perf_counter()
    futures, done = META_POOL["futures"], META_POOL["done"]
    results = {t: f.result() for t, f in futures.items()}
    now = time.perf_counter()
    # a count's time is noted by its future's callback, which may run
    # just after its result is handed out
    last = max(done) if len(done) == len(futures) else now
    out = {"results": results, "workers": META_POOL["workers"],
           "wall_s": last - META_POOL["t0"], "wait_s": now - t0}
    META_POOL.pop("pool").shutdown()
    META_POOL.clear()
    return out


def _step_ms(fn, steps: int = NAPEL_TIMED_STEPS) -> list:
    """`steps` calls of `fn`, each timed by CUDA events (ms)."""
    out = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def compare_counts(label, meta, card) -> None:
    """Raise unless the meta and card counts agree on `COUNT_KEYS` and
    on every kernel entry; show the first ops where the logs part."""
    import difflib
    m_sum, m_ent, m_log = meta[:3]
    c_sum, c_ent, c_log = card[:3]
    bad = [k for k in COUNT_KEYS if m_sum[k] != c_sum[k]]
    if m_ent != c_ent:
        bad.append("entries")
    if bad:
        diff = list(itertools.islice(difflib.unified_diff(
            m_log, c_log, "meta", "card", lineterm="", n=1), 40))
        raise AssertionError(
            f"{label}: meta and card counts differ in {bad}: "
            f"{ {k: (m_sum[k], c_sum[k]) for k in bad if k in m_sum} }\n"
            + "\n".join(diff))


def napel_count_row(label, kind, meta, step_fn, cfg, shape, live_meta):
    """The card's count of one step (a warm call first) against the meta
    count, launches against entries, then the step timed; returns the
    row and the launches of the counted and timed calls."""
    from repro_torch.core import hlo_inspect
    from repro_torch.core.roofline import (H100_SXM, compute_seconds,
                                           model_flops, roofline_terms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_fn()
    torch.cuda.synchronize()
    warm = read_launches()
    reset_launches()
    _, summary, entries, log, c = logged_count(step_fn, inspect=True)
    torch.cuda.synchronize()
    launched = read_launches()
    compare_counts(label, meta, (summary, entries, log))
    for name, k in summary["kernels"].items():
        if launched[name] != k["entries"]:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launched[name]} times, counted "
                                 f"{k['entries']} entries")
    ms = _step_ms(step_fn)
    total = _add(dict(warm), read_launches())      # counted + timed
    step_s = statistics.median(ms) / 1e3
    rl = roofline_terms(summary["flops_by_class"],
                        summary["bytes_accessed_fused"],
                        summary["collectives"]["total_bytes"], H100_SXM)
    mf = model_flops(cfg, shape, 1)
    row = {"phase": "napel", "part": "count", "case": label, "kind": kind,
           "equal_meta_card": list(COUNT_KEYS) + ["entries"],
           "flops": summary["flops"],
           "flops_by_class": summary["flops_by_class"],
           "bytes_fused": summary["bytes_accessed_fused"],
           "bytes_unfused": summary["bytes_accessed"],
           "ops": summary["ops"], "kernels": summary["kernels"],
           "kernel_routes": summary["kernel_routes"],
           "launches_counted_step": {k: v for k, v in launched.items() if v},
           "step_ms": statistics.median(ms), "step_ms_all": ms,
           "timing": f"cuda events, median of {NAPEL_TIMED_STEPS} after a "
                     f"warm step",
           "bound_ms": rl["step_time_bound_s"] * 1e3,
           "bottleneck": rl["bottleneck"],
           "compute_bound_ms": compute_seconds(summary["flops_by_class"],
                                               H100_SXM) * 1e3,
           "memory_bound_ms": rl["memory_s"] * 1e3,
           "bound_share": rl["step_time_bound_s"] / step_s,
           "model_flops": mf,
           "model_flops_share": mf / (step_s * H100_SXM.peak_flops),
           "counted_flops_share": summary["flops"] /
           (step_s * H100_SXM.peak_flops),
           "dryrun_live_gb": live_meta / 1e9,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "count_s_meta": meta[3]["count_s"], "count_s_card": c.count_s,
           "top_bytes_ops": hlo_inspect.top_bytes_ops(c, 10)}
    emit(row)
    return row, total


def napel_count(meta_results) -> tuple:
    """Part ``count``: the three train steps of `NAPEL_TRAIN` and the
    prefill of `NAPEL_PREFILL`, each counted on meta (in the pool) and on
    the card."""
    from repro_torch.configs.base import InputShape
    rows, launches = [], {}
    for arch, layers, batch, seq in NAPEL_TRAIN:
        cfg = _napel_cfg(arch, layers)
        meta = meta_results[("train", arch, layers, batch, seq)]
        model, step, state, b = napel_train_inputs(cfg, batch, seq, "cuda")
        row, n = napel_count_row(
            f"{arch} train, {layers} layers, {batch} x {seq}", "train",
            meta, lambda: step(state, b), cfg,  # noqa: B023
            InputShape("train", seq, batch, "train"), meta[3]["live_bytes"])
        rows.append(row)
        _add(launches, n)
        del model, step, state, b
        gc.collect()
        torch.cuda.empty_cache()
    arch, layers, batch, seq = NAPEL_PREFILL
    cfg = _napel_cfg(arch, layers)
    meta = meta_results[("prefill", arch, layers, batch, seq)]
    model, step, tok = napel_prefill_inputs(cfg, batch, seq, "cuda")
    with torch.no_grad():
        row, n = napel_count_row(
            f"{arch} prefill, {layers} layers, {batch} x {seq}", "prefill",
            meta, lambda: step(tok), cfg,
            InputShape("prefill", seq, batch, "prefill"),
            meta[3]["live_bytes"])
    rows.append(row)
    _add(launches, n)
    del model, step, tok
    gc.collect()
    torch.cuda.empty_cache()
    return rows, launches


def napel_dryrun(meta_results, wall_s) -> list:
    """Part ``dryrun``: every arch x `shapes_for` cell at 1x1 and per
    device of the 16 x 16 pod (`NAPEL_POD`: one device of the plan,
    positions (0, 0) and (0, 1)), counted in the pool; one row per mesh;
    fails on an error whose reason PERF.md does not list."""
    out = []
    for kind, mesh in (("dryrun", "1x1"), ("dryrun_pod", "pod16x16")):
        cells = []
        for task, rec in meta_results.items():
            if task[0] != kind:
                continue
            cell = {"arch": rec["arch"], "shape": rec["shape"],
                    "status": rec["status"], "wall_s": rec["wall_s"]}
            if rec["status"] == "ok":
                cell.update(
                    flops=rec["cost"]["flops_per_device"],
                    bytes_fused=rec["cost"]["bytes_per_device"],
                    bytes_unfused=rec["cost"]["bytes_per_device_unfused"],
                    live_gb=rec["memory"]["live_bytes_per_device"] / 1e9,
                    fits_hbm=rec["memory"]["fits_hbm"],
                    bottleneck=rec["roofline"]["bottleneck"],
                    bound_s=rec["roofline"]["step_time_bound_s"],
                    kernels={k: v["entries"]
                             for k, v in rec["kernels"].items()},
                    count_s=rec["count_s"])
                if kind == "dryrun_pod":
                    cell.update(position=rec["position"],
                                collective_gb=rec["collectives"]
                                ["total_bytes"] / 1e9)
            else:
                cell["error"] = rec["error"]
                known = DRYRUN_KNOWN_ERRORS.get((rec["arch"], rec["shape"]))
                if known is None or known not in rec["error"]:
                    raise AssertionError(f"dry run {mesh} {rec['arch']} "
                                         f"{rec['shape']}: {rec['error']}\n"
                                         f"{rec.get('traceback', '')}")
            cells.append(cell)
        emit({"phase": "napel", "part": "dryrun", "mesh": mesh,
              "hardware": "h100_sxm", "cells": cells,
              "ok": sum(c["status"] == "ok" for c in cells),
              "pool_wall_s": wall_s,
              "out_dir": str(DRYRUN_OUT.relative_to(ROOT))})
        out += cells
    return out


# -- part ``mesh_count``: the card's per-position counts of a plan's step
# against the one-position counts on meta
NAPEL_POD = "16x16"
# (arch, layers, batch, seq, plans): bf16, every position on cuda:0
NAPEL_MESH_COUNT = ("starcoder2-7b", 2, 2, 1024, ((2, 2), (1, 8)))
MESH_COUNT_POSITIONS = ((0, 0), (0, 1))
MESH_COUNT_KEYS = ("flops_by_class", "bytes_accessed_fused",
                   "kernel_routes", "collectives")


def mesh_count_inputs(cfg, plan_shape, device: str):
    """(model, train step, state, batch) of `cfg` over a d x m plan: on
    the card every position on cuda:0, seeded weights; on ``meta`` a plan
    that runs only `MESH_COUNT_POSITIONS`."""
    from repro_torch.launch.mesh import make_abstract_mesh, make_serve_mesh
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.sharding import ShardedTrainModel, TrainPlan
    from repro_torch.train.train_step import init_state, make_train_step
    d, m = plan_shape
    if device == "meta":
        plan = TrainPlan(make_abstract_mesh((d, m), ("data", "model")), cfg,
                         count_positions=MESH_COUNT_POSITIONS)
    else:
        plan = TrainPlan(make_serve_mesh(d, m, devices=[device] * (d * m)),
                         cfg)
    model = ShardedTrainModel(cfg, plan, seed=0)
    oc = OptimizerConfig()
    step = make_train_step(model, oc)
    batch, seq = NAPEL_MESH_COUNT[2:4]
    tok = napel_tokens(cfg, batch, seq, device)
    return model, step, init_state(model, oc), {"tokens": tok,
                                                "labels": tok}


def mesh_count_positions(step, state, batch) -> dict:
    """One counted step: ``{"i,j": {key: ...}}`` of `MESH_COUNT_KEYS` for
    each of `MESH_COUNT_POSITIONS`, and the count's seconds."""
    from repro_torch.core.hlo_cost import CostCounter
    t0 = time.perf_counter()
    with CostCounter() as c:
        step(state, batch)
    out = {"count_s": time.perf_counter() - t0, "positions": {}}
    for pos in MESH_COUNT_POSITIONS:
        summ = c.position_summary(pos)
        out["positions"][f"{pos[0]},{pos[1]}"] = {
            k: summ[k] for k in MESH_COUNT_KEYS}
    return out


def napel_mesh_count(meta_results, smi) -> dict:
    """Part ``mesh_count``: `NAPEL_MESH_COUNT`'s train step on the card,
    every position of each plan on cuda:0 (a warm step, then a counted
    one), its counts of positions (0, 0) and (0, 1) against the meta
    one-position counts (`TrainPlan(count_positions=...)`, in the pool):
    flops by class, fused bytes, kernel entries by route and collectives
    by kind, count and bytes. Fails on any difference."""
    arch, layers = NAPEL_MESH_COUNT[:2]
    cfg = _napel_cfg(arch, layers)
    plans, bad = {}, []
    for shape in NAPEL_MESH_COUNT[4]:
        meta = meta_results[("mesh_count", shape)]
        model, step, state, batch = mesh_count_inputs(cfg, shape, "cuda:0")
        step(state, batch)
        torch.cuda.synchronize()
        card = mesh_count_positions(step, state, batch)
        del model, step, state, batch
        _release()
        label = f"{shape[0]}x{shape[1]}"
        diff = {pos: [k for k in MESH_COUNT_KEYS
                      if card["positions"][pos][k] != want[k]]
                for pos, want in meta["positions"].items()}
        plans[label] = {"meta": meta["positions"],
                        "card": card["positions"], "differ": diff,
                        "meta_count_s": meta["count_s"],
                        "card_count_s": card["count_s"]}
        if any(diff.values()):
            bad.append(label)
    emit({"phase": "napel", "part": "mesh_count", "nvidia_smi": smi,
          "config": f"{arch} full width, {layers} layers, "
                    f"{cfg.param_dtype}, batch {NAPEL_MESH_COUNT[2]}, seq "
                    f"{NAPEL_MESH_COUNT[3]}", "plans": plans})
    if bad:
        raise AssertionError(f"mesh_count: plans {bad}: the card's "
                             f"per-position counts differ from meta's")
    return plans


class Nvml:
    """NVML's energy counter and power reading through ctypes on
    ``libnvidia-ml.so.1`` (no package): device 0, the one card."""

    def __init__(self):
        import ctypes
        self.ct = ctypes
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._ok(self.lib.nvmlInit_v2(), "nvmlInit_v2")
        self.handle = ctypes.c_void_p()
        self._ok(self.lib.nvmlDeviceGetHandleByIndex_v2(
            0, ctypes.byref(self.handle)), "nvmlDeviceGetHandleByIndex_v2")

    def _ok(self, rc, name):
        if rc != 0:
            raise RuntimeError(f"NVML {name} returned {rc}")

    def energy_j(self) -> float:
        """The card's energy counter, joules (it only grows)."""
        mj = self.ct.c_ulonglong()
        self._ok(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, self.ct.byref(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1e3

    def power_w(self) -> float:
        mw = self.ct.c_uint()
        self._ok(self.lib.nvmlDeviceGetPowerUsage(
            self.handle, self.ct.byref(mw)), "nvmlDeviceGetPowerUsage")
        return mw.value / 1e3

    def close(self):
        self.lib.nvmlShutdown()


def energy_window(nvml, fn, min_s: float) -> dict:
    """Run `fn` (one unit of work, enqueued) repeatedly for at least
    `min_s` seconds of device time; the card's joules and seconds over
    the window and the units run."""
    torch.cuda.synchronize()
    e0, t0 = nvml.energy_j(), time.perf_counter()
    n = 0
    while True:
        for _ in range(8):
            fn()
        n += 8
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= min_s:
            break
    e1, t1 = nvml.energy_j(), time.perf_counter()
    return {"joules": e1 - e0, "s": t1 - t0, "units": n}


def napel_energy(smi) -> dict:
    """Part ``energy``: the card's idle power, then a bf16 matmul loop and
    an HBM copy loop of at least `ENERGY_LOOP_S` each under NVML's
    energy counter. Fits pJ per HBM byte from the copy (its whole energy
    over its bytes, idle included) and pJ per flop from the matmul (its
    energy less its bytes' share, over its flops); the idle-subtracted
    constants beside them."""
    nvml = Nvml()
    try:
        torch.cuda.synchronize()
        time.sleep(0.5)
        e0, t0 = nvml.energy_j(), time.perf_counter()
        time.sleep(1.5)
        idle_w = (nvml.energy_j() - e0) / (time.perf_counter() - t0)
        idle_read_w = nvml.power_w()
        n = 8192
        a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
        b = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
        c = torch.empty(n, n, device="cuda", dtype=torch.bfloat16)
        for _ in range(3):
            torch.mm(a, b, out=c)
        mm = energy_window(nvml, lambda: torch.mm(a, b, out=c),
                           ENERGY_LOOP_S)
        mm_flops = mm["units"] * 2 * n ** 3
        mm_bytes = mm["units"] * 3 * n * n * 2
        del a, b, c
        src = torch.empty(2 ** 30, device="cuda", dtype=torch.uint8)
        dst = torch.empty_like(src)
        src.fill_(1)
        for _ in range(3):
            dst.copy_(src)
        cp = energy_window(nvml, lambda: dst.copy_(src), ENERGY_LOOP_S)
        cp_bytes = cp["units"] * 2 * src.numel()
        del src, dst
        torch.cuda.empty_cache()
        pj_byte = cp["joules"] / cp_bytes * 1e12
        pj_flop = (mm["joules"] - pj_byte * 1e-12 * mm_bytes) / mm_flops \
            * 1e12
        dyn_byte = (cp["joules"] - idle_w * cp["s"]) / cp_bytes * 1e12
        dyn_flop = (mm["joules"] - idle_w * mm["s"]
                    - dyn_byte * 1e-12 * mm_bytes) / mm_flops * 1e12
        row = {"phase": "napel", "part": "energy", "nvidia_smi": smi,
               "total_memory_bytes":
                   torch.cuda.get_device_properties(0).total_memory,
               "total_memory_gib":
                   torch.cuda.get_device_properties(0).total_memory / 2 ** 30,
               "idle_w": idle_w, "idle_power_usage_w": idle_read_w,
               "matmul": {**mm, "n": n, "flops": mm_flops,
                          "bytes": mm_bytes, "watts": mm["joules"] / mm["s"],
                          "tflops": mm_flops / mm["s"] / 1e12},
               "copy": {**cp, "bytes": cp_bytes,
                        "watts": cp["joules"] / cp["s"],
                        "tb_per_s": cp_bytes / cp["s"] / 1e12},
               "pj_per_flop": pj_flop, "pj_per_hbm_byte": pj_byte,
               "dynamic_pj_per_flop": dyn_flop,
               "dynamic_pj_per_hbm_byte": dyn_byte,
               "rule": "total energy of each loop (idle included) over its "
                       "work: pJ/byte = copy J / bytes; pJ/flop = (matmul J "
                       "- pJ/byte x its bytes) / flops; dynamic_* subtract "
                       "idle W x s first"}
        if not (0 < pj_flop and 0 < pj_byte):
            raise AssertionError(f"energy fit not positive: {row}")
        emit(row)
        return row
    finally:
        nvml.close()


def step_energy(nvml, fn, min_s: float = 1.0) -> dict:
    """A step timed by CUDA events and its joules: steps back to back for
    at least `min_s`, energy over all of them divided by their count."""
    torch.cuda.synchronize()
    e0, t0 = nvml.energy_j(), time.perf_counter()
    ms = []
    while True:
        ms += _step_ms(fn, 1)
        if time.perf_counter() - t0 >= min_s and len(ms) >= 3:
            break
    e1 = nvml.energy_j()
    return {"ms": statistics.median(ms), "ms_all": ms,
            "joules": (e1 - e0) / len(ms), "steps": len(ms)}


def napel_learners(records):
    """bench_napel's evaluation on the port's corpus: RF, ANN and DT fitted
    on the DoE points' log residuals over the analytic napkin, per target
    (flops, bytes, coll). Returns (learners by name: [model per target],
    features and napkin of a record)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.napel.baselines import DecisionTree, MLPRegressor
    from repro_torch.core.napel.corpus import corpus_features, make_cfg
    from repro_torch.core.napel.features import analytic_costs
    from repro_torch.core.napel.forest import RandomForest

    def fa(r):
        p = r["params"]
        sh = InputShape("t", p["seq"], p["batch"], "train")
        return corpus_features(r), analytic_costs(make_cfg(p), sh,
                                                  tuple(r["mesh"]))

    doe = [r for r in records if r["tag"] == "doe"]
    x, a = map(np.stack, zip(*[fa(r) for r in doe]))
    makers = {"rf": lambda: RandomForest(n_trees=80, max_depth=10,
                                         min_samples_leaf=1,
                                         max_features=x.shape[1]),
              "ann": lambda: MLPRegressor(epochs=300),
              "dt": lambda: DecisionTree()}
    learners = {}
    for name, mk in makers.items():
        learners[name] = [
            mk().fit(x, np.log2([r[t] for r in doe]) - np.log2(a[:, i]))
            for i, t in enumerate(("flops", "bytes", "coll"))]
    return learners, fa


def napel_predict(models, fa, recs) -> list:
    """(flops, bytes, coll) predicted for each record."""
    x, a = map(np.stack, zip(*[fa(r) for r in recs]))
    return [tuple(float(2.0 ** m.predict(x[j:j + 1])[0] * a[j, i])
                  for i, m in enumerate(models)) for j in range(len(recs))]


def napel_corpus(meta_results, energy, nvml_smi) -> tuple:
    """Part ``corpus``: NAPEL's RF / ANN / DT on the DoE points, MRE on the
    test points for flops, bytes, step time and energy (the H100 entry
    with the energy part's constants), predict µs against the count's
    wall time; then the
    train step on the card at the `NAPEL_CARD_POINTS` cheapest corpus
    points whose counted live bytes fit `NAPEL_CARD_BYTES`, measured ms
    and joules beside the predictions."""
    import dataclasses
    from repro_torch.core.napel.corpus import make_cfg
    from repro_torch.core.napel.forest import mean_relative_error
    from repro_torch.core.napel.model import energy_joules
    from repro_torch.core.roofline import H100_SXM, roofline_terms
    hw = dataclasses.replace(H100_SXM, pj_per_flop=energy["pj_per_flop"],
                             pj_per_hbm_byte=energy["pj_per_hbm_byte"])
    records = [r for t, r in meta_results.items() if t[0] == "corpus"]
    test = [r for r in records if r["tag"] == "test"]
    t0 = time.perf_counter()
    learners, fa = napel_learners(records)
    train_s = time.perf_counter() - t0
    mre = {}
    for name, models in learners.items():
        pred = napel_predict(models, fa, test)
        row = {}
        for i, t in enumerate(("flops", "bytes", "coll")):
            row[f"{t}_mre"] = mean_relative_error(
                [p[i] for p in pred], [r[t] for r in test])
        row["perf_mre"] = mean_relative_error(
            [roofline_terms(*p, hw)["step_time_bound_s"] for p in pred],
            [roofline_terms(r["flops"], r["bytes"], r["coll"], hw)
             ["step_time_bound_s"] for r in test])
        row["energy_mre"] = mean_relative_error(
            [energy_joules(*p, hw) for p in pred],
            [energy_joules(r["flops"], r["bytes"], r["coll"], hw)
             for r in test])
        mre[name] = row
    x_test = np.stack([fa(r)[0] for r in test])
    rf_flops = learners["rf"][0]
    t0 = time.perf_counter()
    for _ in range(50):
        rf_flops.predict(x_test)
    predict_us = (time.perf_counter() - t0) / 50 / len(test) * 1e6
    count_s = float(np.mean([r["compile_s"] for r in test]))
    # the card
    fits = sorted((r for r in records if r["live_bytes"] <= NAPEL_CARD_BYTES),
                  key=lambda r: r["flops"])[:NAPEL_CARD_POINTS]
    preds = napel_predict(learners["rf"], fa, fits)
    nvml = Nvml()
    points, launches = [], {}
    try:
        for r, pred in zip(fits, preds):
            p = r["params"]
            cfg = make_cfg(p)
            model, step, state, b = napel_train_inputs(
                cfg, p["batch"], p["seq"], "cuda")
            reset_launches()
            step(state, b)                                   # warm
            m = step_energy(nvml, lambda: step(state, b))  # noqa: B023
            _add(launches, read_launches())
            bound = roofline_terms(r["flops_by_class"], r["bytes"],
                                   r["coll"], hw)["step_time_bound_s"]
            points.append({
                "tag": r["tag"], "params": p, "flops": r["flops"],
                "bytes": r["bytes"], "live_gb": r["live_bytes"] / 1e9,
                "ms": m["ms"], "joules": m["joules"], "steps": m["steps"],
                "counted_bound_ms": bound * 1e3,
                "counted_energy_j": energy_joules(r["flops"], r["bytes"],
                                                  r["coll"], hw),
                "napel_step_ms": roofline_terms(*pred, hw)
                ["step_time_bound_s"] * 1e3,
                "napel_energy_j": energy_joules(*pred, hw)})
            del model, step, state, b
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        nvml.close()
    row = {"phase": "napel", "part": "corpus", "nvidia_smi": nvml_smi,
           "points": len(records), "doe": len(records) - len(test),
           "test": len(test), "mre_on_test_points": mre,
           "learners": {"rf": "RandomForest(80 trees, depth 10)",
                        "ann": "MLPRegressor(300 epochs)",
                        "dt": "DecisionTree()"},
           "train_all_s": train_s, "predict_us": predict_us,
           "count_s": count_s, "speedup_over_count": count_s * 1e6 /
           predict_us,
           "card_points": points,
           "card_ms_over_bound": [q["ms"] / q["counted_bound_ms"]
                                  for q in points],
           "card_joules_over_counted": [q["joules"] / q["counted_energy_j"]
                                        for q in points],
           "out_dir": str(CORPUS_OUT.relative_to(ROOT))}
    emit(row)
    if len(points) < 8:
        raise AssertionError(f"{len(points)} corpus points fit "
                             f"{NAPEL_CARD_BYTES:.0f} bytes, want 8")
    return row, launches


NAPEL_KNEE_K = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
NAPEL_KNEE_MN = 8192


def napel_platform(energy) -> dict:
    """The h100 `Platform`'s efficiency parameters from the card: mem_eff
    from the energy part's copy loop, launch_overhead_s from empty
    launches (``torch.cuda._sleep(0)``) back to back, compute_eff_knee
    fitted to bf16 matmuls of rising arithmetic intensity: M = N =
    `NAPEL_KNEE_MN`, K in `NAPEL_KNEE_K` (each long enough that its
    launch does not set its time), ai = 2 M N K / (2 (M K + K N + M N)),
    ceff = its flops / (its time x the bf16 peak), the knee minimising the
    squared error of ceff = ai / (ai + knee)."""
    from repro_torch.core.roofline import H100_SXM
    mem_eff = energy["copy"]["tb_per_s"] * 1e12 / H100_SXM.hbm_bw
    torch.cuda.synchronize()
    for _ in range(100):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()
    launch_s = (time.perf_counter() - t0) / 2000
    sweep = []
    mn = NAPEL_KNEE_MN
    c = torch.empty(mn, mn, device="cuda", dtype=torch.bfloat16)
    for k in NAPEL_KNEE_K:
        a = torch.randn(mn, k, device="cuda", dtype=torch.bfloat16)
        b = torch.randn(k, mn, device="cuda", dtype=torch.bfloat16)
        reps = max(10, min(400, int(4e13 / (mn * mn * k))))
        for _ in range(3):
            torch.mm(a, b, out=c)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            torch.mm(a, b, out=c)
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3 / reps
        flops = 2 * mn * mn * k
        sweep.append({"m": mn, "n": mn, "k": k,
                      "ai": flops / (2 * (mn * k + k * mn + mn * mn)),
                      "s": sec, "ceff": flops / sec / H100_SXM.peak_flops})
        del a, b
    del c
    ai = np.array([p["ai"] for p in sweep])
    ceff = np.array([p["ceff"] for p in sweep])
    grid = np.exp(np.linspace(np.log(1.0), np.log(1e5), 4001))
    err = [np.sum((ai / (ai + k) - ceff) ** 2) for k in grid]
    knee = float(grid[int(np.argmin(err))])
    return {"compute_eff_knee": knee, "mem_eff": mem_eff, "coll_eff": 1.0,
            "launch_overhead_s": launch_s, "matmul_sweep": sweep,
            "knee_rms_error": float(np.sqrt(min(err) / len(sweep)))}


def napel_leaper(meta_results, corpus_row, energy) -> dict:
    """Part ``leaper``: base learners trained on the h100 `Platform`'s
    labels (its parameters fitted on the card here) over every corpus
    point; `Leaper.transfer` on 1, 3 and 5 shots of the card's measured
    step times, accuracy (100 - MRE%) on the other measured points beside
    a forest trained from scratch on the same shots and the platform
    model alone."""
    from types import SimpleNamespace

    from repro_torch.core.leaper import transfer as lp
    from repro_torch.core.napel.corpus import corpus_features
    from repro_torch.core.napel.forest import (RandomForest,
                                               mean_relative_error)
    from repro_torch.core.roofline import H100_SXM
    fit = napel_platform(energy)
    platform = lp.Platform(H100_SXM, fit["compute_eff_knee"],
                           fit["mem_eff"], fit["coll_eff"],
                           fit["launch_overhead_s"])
    platforms = {"h100": platform}
    records = [r for t, r in meta_results.items() if t[0] == "corpus"]

    def cell(r):
        return SimpleNamespace(flops=r["flops"], bytes_=r["bytes"],
                               coll=r["coll"])

    feats = lp.invariant_features([cell(r) for r in records],
                                  np.stack([corpus_features(r)
                                            for r in records]))
    y_src = lp.platform_labels("h100", [cell(r) for r in records],
                               platforms=platforms)
    bases = lp.base_learners(feats, y_src, seed=0)
    key = {json.dumps(r["params"], sort_keys=True): i
           for i, r in enumerate(records)}
    measured = corpus_row["card_points"]
    idx_m = [key[json.dumps(q["params"], sort_keys=True)] for q in measured]
    x = feats[idx_m]
    y = np.log2([q["ms"] / 1e3 for q in measured])
    order = np.random.default_rng(0).permutation(len(measured))
    out = {}
    for shots in NAPEL_SHOTS:
        s_idx, t_idx = order[:shots], order[shots:]
        learner = lp.Leaper(bases, 0).transfer(x[s_idx], y[s_idx])
        mre_t = mean_relative_error(2.0 ** learner.predict(x[t_idx]),
                                    2.0 ** y[t_idx])
        if shots >= 2:
            scratch = RandomForest(n_trees=30, seed=0).fit(x[s_idx],
                                                           y[s_idx])
            mre_s = mean_relative_error(2.0 ** scratch.predict(x[t_idx]),
                                        2.0 ** y[t_idx])
        else:
            mre_s = None
        mre_p = mean_relative_error(2.0 ** y_src[idx_m][t_idx],
                                    2.0 ** y[t_idx])
        out[shots] = {"leaper_acc_pct": 100 * (1 - min(mre_t, 1.0)),
                      "scratch_acc_pct": None if mre_s is None
                      else 100 * (1 - min(mre_s, 1.0)),
                      "platform_model_acc_pct": 100 * (1 - min(mre_p, 1.0)),
                      "n_test": len(t_idx)}
    module = lp.PLATFORMS["h100"]
    row = {"phase": "napel", "part": "leaper", "platform_fit": fit,
           "platform_in_port": {k: getattr(module, k) for k in (
               "compute_eff_knee", "mem_eff", "coll_eff",
               "launch_overhead_s")},
           "base_learners": len(bases), "source_cells": len(records),
           "measured_points": len(measured), "by_shots": out}
    emit(row)
    return row


def phase_napel(smi: str) -> dict:
    """The thesis's data-driven models on the card, one JSON line per
    part: ``count``, ``dryrun``, ``energy``, ``corpus``, ``leaper`` (see
    the module docstring). Returns the card's kernel launches."""
    t0 = time.perf_counter()
    meta = napel_meta_counts()
    results = meta["results"]
    napel_dryrun(results, meta["wall_s"])
    _, launches = napel_count(results)
    reset_launches()
    napel_mesh_count(results, smi)
    _add(launches, read_launches())
    energy = napel_energy(smi)
    corpus_row, corpus_launches = napel_corpus(results, energy, smi)
    _add(launches, corpus_launches)
    napel_leaper(results, corpus_row, energy)
    emit({"phase": "napel", "part": "done", "launches": launches,
          "meta_pool_s": meta["wall_s"], "meta_wait_s": meta["wait_s"],
          "meta_workers": meta["workers"],
          "wall_s": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# 14. serving across devices: dp x tp plans on one card
# ---------------------------------------------------------------------------
MESH_PLANS = ((1, 2), (2, 1), (2, 2), (1, 4))
MESH_EXACT_LAYERS = 2
MESH_HYBRIDS = (("mamba2-780m", 2, ((2, 2),)),
                ("recurrentgemma-2b", 3, ((2, 1), (1, 2))))
# kernels of an arch held to `magnitude_limit` instead of 2 ulps:
# recurrentgemma-2b's fp32 windowed flash at d = 256 and its fp32 RG-LRU
# scan miss 2 ulps at 1x1 as at every plan, and so do plain loops in the
# kernels' orders of summation (`flash_online_loop`,
# `rglru_chunked_loop`) on the same inputs (PERF.md §6-7, part
# ``launch_checks``)
MESH_MAGNITUDE_HELD = {"recurrentgemma-2b": ("flash_attention",
                                             "rglru_scan")}
MESH_PLAN_MESHES = "1x1,1x2,2x2,1x4,2x4"
MESH_PROFILE_STEPS = 4   # traced 2x2 steps: ~5,000 kernels each
# part ``serve``'s depth: at 32 layers (97.2 s of it) an every-phase run
# took 1,138.7 s of its 1,200 s limit on a slow host; at 16 the part
# took 37 s of a 735 s run
MESH_SERVE_LAYERS = 8
MESH_KERNELS = ("paged_attention", "flash_attention", "ssd_scan",
                "rglru_scan")


def serve_mesh(d: int, m: int):
    """A d x m serving mesh: position i on cuda:i when the machine has a
    card for every position (the seams all-reduce over NCCL), else every
    position on cuda:0."""
    from repro_torch.launch.mesh import make_serve_mesh
    n = d * m
    if torch.cuda.device_count() >= n:
        return make_serve_mesh(d, m)
    return make_serve_mesh(d, m, devices=["cuda:0"] * n)


def mesh_layout(mesh) -> list:
    """The devices of a mesh's positions, in order."""
    return [str(x) for x in mesh.devices.ravel()]


def _call_key(args, kwargs):
    return (tuple((tuple(a.shape), a.dtype) for a in args
                  if isinstance(a, torch.Tensor)),
            tuple(sorted((k, v) for k, v in kwargs.items()
                         if k not in ("backend", "tile"))))


def _as_launched(name, args, kwargs) -> dict:
    """A recorded call's keyword arguments with the launch shape it runs
    at under ``tile``: the caller's tile; else, with ``backend="auto"``
    on the card, the knee `api.resolve_tile` gives (the one `api.run` is
    about to take); else None (``"cuda"``: the wrapper's launch before
    tiles; ``"ref"``: the plain version). The replays launch the kernel
    at that tile (`_replay_kw`)."""
    from repro_torch.kernels import api
    kw = dict(kwargs)
    if kw.get("tile") is None:
        auto = kw.get("backend", "auto") == "auto"
        kw["tile"] = api.resolve_tile(name, args) if auto and \
            api.as_spec(name).tune_space and args[0].is_cuda else None
    return kw


def _replay_kw(kwargs) -> tuple:
    """(keyword arguments of both sides, the kernel side's tile) of a
    recorded call: the kernel is replayed at the tile it ran at, the
    plain version takes none."""
    return ({k: v for k, v in kwargs.items() if k not in ("backend", "tile")},
            kwargs.get("tile"))


@contextlib.contextmanager
def first_calls(kernels):
    """Record the first ``api.run(kernel, ...)`` call of every launch
    shape (argument shapes and dtypes, keyword arguments but the tile)
    for each of `kernels`, its tensors copied and the tile it launched at
    under ``tile`` (`_as_launched`); yields ``{kernel: {key: (args,
    kwargs)}}``."""
    from repro_torch.kernels import api
    plain_run = api.run
    seen = {k: {} for k in kernels}

    def run(name, *args, **kwargs):
        if name in seen:
            key = _call_key(args, kwargs)
            if key not in seen[name]:
                seen[name][key] = ([a.detach().clone()
                                    if isinstance(a, torch.Tensor) else a
                                    for a in args],
                                   _as_launched(name, args, kwargs))
        return plain_run(name, *args, **kwargs)

    api.run = run
    try:
        yield seen
    finally:
        api.run = plain_run


def flash_online_loop(q, k, v, *, causal=True, window=0, two_pass=False):
    """The simt flash route's softmax in plain PyTorch, fp32: tiles of 32
    keys, each row's running max and sum rescaled by exp(m_old - m_new)
    as a later tile raises the max (``two_pass``: the row max over every
    visible key first, so no rescale). Scores and p @ V by matmul, not
    the kernel's FMA order."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.float())
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s = torch.where(ok, s, -1e30)
    vf = v.float()
    m = torch.full(s.shape[:-1], -1e30, device=q.device)
    if two_pass:
        m = s.amax(dim=-1)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (d,), device=q.device)
    for t0 in range(0, skv, 32):
        st = s[..., t0:t0 + 32]
        m_new = torch.maximum(m, st.amax(dim=-1))
        p = torch.exp(st - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqs,bshd->bhgqd", p, vf[:, t0:t0 + 32])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


MAGNITUDE_RULE = ("per element: 64 * 2^-23 * M + 1e-6, M the plain "
                  "version over |v| (flash) or |b| (RG-LRU): the "
                  "magnitudes summed into the element")


def magnitude_limit(kernel, args, kw):
    """Per-element limit for a flash or RG-LRU launch against its plain
    version on the same inputs, scaled by what the element sums rather
    than by its value: M is the plain version with |v| (flash: each
    row's softmax weights times |v|) or |b| (RG-LRU: the decayed sum of
    |b|). Both sides compute in fp32 and round their sums in other
    orders, so they differ by a few roundings of M, not of the output,
    which cancellation can make far smaller: 64 roundings of M. A kernel
    that drops a key tile, rounds P to bf16 or drops a chunk's carry
    misses it a hundredfold or more (`magnitude_faults`; on the CPU, at
    recurrentgemma-2b's own 3-layer launches, 350x and more)."""
    from repro_torch.kernels import api
    absed = list(args)
    i = 2 if kernel == "flash_attention" else 1
    absed[i] = args[i].abs()
    m = api.run(kernel, *absed, **kw, backend="ref").float()
    return 64.0 * 2.0 ** -23 * m + 1e-6


def limit_check(got, want, limit):
    """`ulp_check` against a given per-element limit."""
    diff = (got.float() - want.float()).abs()
    worst = int(torch.argmax(diff))
    return (diff.flatten()[worst].item(), limit.flatten()[worst].item(),
            (diff / limit).max().item())


def magnitude_faults(kernel, args, kw, want, limit, tile) -> dict:
    """Each broken variant of the kernel on the launch's own inputs over
    `magnitude_limit` (must exceed 1), at the launch's `tile`: flash's
    `FLASH_FAULTS` (key tiles of its ``block_k``), RG-LRU's
    `RGLRU_FAULTS` (chunks of its ``chunk``; none for a sequence of one
    chunk, which has no carry)."""
    from repro_torch.kernels.rglru_scan.rglru_scan import route
    if kernel == "flash_attention":
        variants = {f: flash_variant(*args[:3], fault=f, **kw,
                                     block_k=tile["block_k"])
                    for f in FLASH_FAULTS}
    elif route(args[0].shape[1], tile["chunk"]) == "chunked":
        variants = {f: rglru_chunked_loop(*args[:2], chunk=tile["chunk"],
                                          fault=f)
                    for f in RGLRU_FAULTS}
    else:
        variants = {}
    return {f: limit_check(v, want, limit)[2] for f, v in variants.items()}


def check_recorded(seen, label, magnitude=(), phase="mesh",
                   summarize=False) -> list:
    """Each recorded launch shape through the kernel (``backend="cuda"``
    at the tile it ran at) and the plain version on the same inputs: paged, flash and RG-LRU to
    2 ulps, SSD to `ssd_limit`, the kernels in `magnitude` to
    `magnitude_limit`. A magnitude-held launch also shows the cause of
    its 2-ulp reading, a plain loop in the kernel's order of summation
    on the same inputs (`flash_online_loop`, in tiles of 32 keys;
    `rglru_chunked_loop`, whose roundings are the chunked route's, so it
    must equal the kernel within 2 ulps), and its broken variants over
    the limit (`magnitude_faults`). Every shape is checked and emitted;
    then any launch past its limit raises. These launches are not the
    main path's and count nowhere. With `summarize` the line groups the
    launches by kernel, shapes, dtype and tile (`launch_groups`) instead
    of one row each."""
    from repro_torch.kernels import api
    from repro_torch.kernels.rglru_scan.rglru_scan import route
    out, bad = [], []
    for kernel, calls in seen.items():
        for args, kwargs in calls.values():
            kw, tile = _replay_kw(kwargs)
            got = api.run(kernel, *args, **kw, backend="cuda", tile=tile)
            want = api.run(kernel, *args, **kw, backend="ref")
            torch.cuda.synchronize()
            shape = [list(a.shape) for a in args
                     if isinstance(a, torch.Tensor)][:3]
            row = {"kernel": kernel, "shapes": shape,
                   "dtype": str(args[0].dtype).replace("torch.", ""),
                   "kwargs": {k: v for k, v in kw.items()}, "tile": tile}
            spec = api.as_spec(kernel)
            launched = tile or spec.fixed_tile(tuple(spec.grid_of(*args)))
            if kernel in magnitude:
                limit = magnitude_limit(kernel, args, kw)
                err, tol, over = limit_check(got, want, limit)
                row.update(rule=MAGNITUDE_RULE,
                           over_2ulp=ulp_check(got, want)[2],
                           faults_over_limit=magnitude_faults(
                               kernel, args, kw, want, limit, launched))
                if kernel == "flash_attention":
                    emu = flash_online_loop(*args[:3], **kw)
                    row["online_loop_over_2ulp"] = ulp_check(emu, want)[2]
                    row["online_loop_over_limit"] = limit_check(
                        emu, want, limit)[2]
                else:
                    chunk = launched["chunk"]
                    emu = rglru_chunked_loop(*args[:2], chunk=chunk)
                    row["route"] = route(args[0].shape[1], chunk)
                    row["chunked_loop_over_2ulp"] = ulp_check(emu, want)[2]
                    row["kernel_vs_chunked_loop_over_2ulp"] = \
                        ulp_check(got, emu)[2]
                    if row["route"] == "chunked" and \
                            not row["kernel_vs_chunked_loop_over_2ulp"] <= 1:
                        bad.append(row)
                if not all(v > 1.0
                           for v in row["faults_over_limit"].values()):
                    bad.append(row)
            else:
                check = ssd_check if kernel == "ssd_scan" else ulp_check
                err, tol, over = check(got, want)
                row["rule"] = SSD_LIMIT_RULE if kernel == "ssd_scan" \
                    else ULP_RULE
            row.update(max_abs_err=err, tol=tol, max_err_over_limit=over)
            if not over <= 1.0:
                bad.append(row)
            out.append(row)
            del got, want
    emit({"phase": phase, "part": "launch_checks", "label": label,
          **({"launches_checked": len(out), "groups": launch_groups(out)}
             if summarize else {"checks": out})})
    if bad:
        raise AssertionError(f"{label}: {len(bad)} launch shapes past their "
                             f"limit, equal to no loop in the kernel's "
                             f"order, or with a broken variant inside the "
                             f"limit: {bad}")
    return out


def launch_groups(rows) -> list:
    """`check_recorded`'s rows grouped by kernel, shapes, dtype and tile:
    the launches in each and the worst error over the limit."""
    groups: dict = {}
    for r in rows:
        key = json.dumps([r["kernel"], r["shapes"], r["dtype"], r["tile"]])
        g = groups.setdefault(key, {
            "kernel": r["kernel"], "shapes": r["shapes"], "dtype": r["dtype"],
            "tile": r["tile"], "rule": r["rule"], "launches": 0,
            "worst_over_limit": 0.0, "max_abs_err": 0.0})
        g["launches"] += 1
        g["worst_over_limit"] = max(g["worst_over_limit"],
                                    r["max_err_over_limit"])
        g["max_abs_err"] = max(g["max_abs_err"], r["max_abs_err"])
        # a magnitude-held launch: its 2-ulp reading, the loop in the
        # kernel's order, the broken variants (the least over the limit)
        for key in ("over_2ulp", "online_loop_over_2ulp",
                    "online_loop_over_limit"):
            if key in r:
                g[f"worst_{key}"] = max(g.get(f"worst_{key}", 0.0), r[key])
        for fault, over in r.get("faults_over_limit", {}).items():
            least = g.setdefault("least_faults_over_limit", {})
            least[fault] = min(least.get(fault, math.inf), over)
    return list(groups.values())


def _mesh_engine(cfg, params, d, m, **kw):
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    return ServeEngine(cfg, params=params, mesh=serve_mesh(d, m)
                       if d * m > 1 else None,
                       kv_pool=PagedKVPool(page_tokens=64,
                                           placement_policy=EveryOtherSlow()),
                       **kw)


def mesh_exact_paths(cfg, params, d, m, hybrid: bool) -> dict:
    """One plan's tokens: ``generate``, the default ``serve`` and k = 4
    ``generate`` (plain-attention stacks), or ``generate`` and the
    default ``serve`` (hybrids); transfers and steady steps beside."""
    v = cfg.vocab_size
    lengths, new = [70, 130, 200, 257], [9, 12, 15, 18]
    eng = _mesh_engine(cfg, params, d, m)
    got = {"generate": _tokens(eng.generate(_requests(v, lengths, new, 0),
                                            free_pages=True))}
    got["transfers"] = list(eng.last_transfers)
    reqs = _requests(v, lengths, new, 1) if hybrid else \
        _shared_prefix_requests(v, 150, [20, 90, 45, 130], 10, 2)
    got["serve"] = _tokens(eng.serve(reqs, max_active=2))
    got["steady"] = [list(x) for x in eng.last_steady_transfers]
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{d}x{m}: pages left in the pool")
    del eng
    if not hybrid:
        eng = _mesh_engine(cfg, params, d, m, speculate=4)
        got["generate_k4"] = _tokens(eng.generate(
            _requests(v, lengths, new, 0), free_pages=True))
        del eng
    torch.cuda.empty_cache()
    return got


def mesh_exact(smi: str) -> dict:
    """Part ``exact``: every plan's greedy tokens against the 1x1
    engine's over the same weights, fp32, and every launch shape the
    plans gave a kernel against its plain version. The plans' launches,
    counted from 0 around their runs, are returned under
    ``"launches"``."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten
    from repro_torch.models.transformer import Model
    t0 = time.perf_counter()
    rows, shapes, launches = [], [], {}
    cases = [("starcoder2-7b", MESH_EXACT_LAYERS, MESH_PLANS)] + \
        list(MESH_HYBRIDS)
    for arch, layers, plans in cases:
        cfg = get_config(arch, num_layers=layers, param_dtype="float32",
                         compute_dtype="float32")
        hybrid = arch != "starcoder2-7b"
        params = flatten(Model(cfg, device="cuda", seed=0).params)
        magnitude = MESH_MAGNITUDE_HELD.get(arch, ())
        with first_calls(MESH_KERNELS) as seen_1x1:
            want = mesh_exact_paths(cfg, params, 1, 1, hybrid)
        checked_1x1 = check_recorded(seen_1x1, f"mesh exact {arch} 1x1",
                                     magnitude)
        del seen_1x1
        reset_launches()
        with first_calls(MESH_KERNELS) as seen:
            got = {f"{d}x{m}": mesh_exact_paths(cfg, params, d, m, hybrid)
                   for d, m in plans}
        _add(launches, read_launches())
        checked = check_recorded(seen, f"mesh exact {arch}", magnitude)
        shapes += checked
        same = {plan: {p: g[p] == want[p] for p in want
                       if p not in ("steady",)} for plan, g in got.items()}
        steady_ok = {plan: bool(g["steady"]) and all(
            x == [1, 1] for x in g["steady"]) for plan, g in got.items()}
        row = {"phase": "mesh", "part": "exact", "nvidia_smi": smi,
               "config": f"{arch} full width, {layers} layers, fp32",
               "plans": list(got), "page_tokens": 64, "identical": same,
               "steady_transfers_per_token_2": steady_ok,
               "steady_steps": {plan: len(g["steady"])
                                for plan, g in got.items()},
               "transfers": {"1x1": want["transfers"],
                             **{plan: g["transfers"]
                                for plan, g in got.items()}},
               "launch_shapes_checked": len(checked),
               "worst_over_limit": max([c["max_err_over_limit"]
                                        for c in checked], default=None),
               "worst_over_limit_1x1": max(
                   [c["max_err_over_limit"] for c in checked_1x1],
                   default=None),
               "magnitude_held": list(magnitude),
               "devices": {f"{d}x{m}": mesh_layout(serve_mesh(d, m))
                           for d, m in plans},
               "generate_1x1": want["generate"]}
        emit(row)
        bad = [plan for plan, s in same.items() if not all(s.values())]
        if bad or not all(steady_ok.values()):
            raise AssertionError(f"mesh exact {arch}: plans {bad} differ "
                                 f"from 1x1, or a steady step cost other "
                                 f"than 2 transfers: {same} {steady_ok}")
        rows.append(row)
        del params
        torch.cuda.empty_cache()
    rows.append(mesh_exact_mla(smi))
    # recurrentgemma-2b's 10 heads do not split 4 ways: the paged serving
    # plan refuses, as the reference's `check_config`
    from repro_torch.serve.sharding import ServePlan
    try:
        ServePlan(serve_mesh(1, 4)).check_config(
            get_config("recurrentgemma-2b"))
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("recurrentgemma-2b accepted a 1x4 plan")
    if "num_heads=10" not in refusal:
        raise AssertionError(f"unexpected refusal: {refusal}")
    row = {"phase": "mesh", "part": "exact_shapes", "nvidia_smi": smi,
           "launch_shapes": shapes, "recurrentgemma_1x4": refusal,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return {"rows": rows, "shapes": shapes, "launches": launches}


# minicpm3-4b (MLA) generates from dense caches over a plan: its latents
# whole on every shard, its heads split (no page pool: the reference's
# engine serves it the same way)
MESH_MLA = ("minicpm3-4b", 2, ((1, 2), (2, 2)))


def mesh_exact_mla(smi: str) -> dict:
    """Part ``exact``, MLA: `MESH_MLA`'s dense `generate` on each plan
    against the 1x1 engine's on the same weights, fp32 greedy tokens
    equal. MLA attends in plain PyTorch, as the reference's jnp: no kernel
    launches to hold."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import ServeEngine
    arch, layers, plans = MESH_MLA
    t0 = time.perf_counter()
    cfg = get_config(arch, num_layers=layers, param_dtype="float32",
                     compute_dtype="float32")
    params = flatten(Model(cfg, device="cuda", seed=0).params)
    lengths, new = [70, 130, 200, 257], [9, 12, 15, 18]
    v = cfg.vocab_size
    want = _tokens(ServeEngine(cfg, params=params, device="cuda").generate(
        _requests(v, lengths, new, 0)))
    got = {}
    for d, m in plans:
        eng = ServeEngine(cfg, params=params, mesh=serve_mesh(d, m))
        got[f"{d}x{m}"] = _tokens(eng.generate(_requests(v, lengths, new,
                                                         0)))
        del eng
    same = {plan: g == want for plan, g in got.items()}
    row = {"phase": "mesh", "part": "exact", "nvidia_smi": smi,
           "config": f"{arch} full width, {layers} layers, fp32",
           "path": "dense generate (no pool)", "plans": list(got),
           "identical": same, "generate_1x1": want,
           "devices": {f"{d}x{m}": mesh_layout(serve_mesh(d, m))
                       for d, m in plans},
           "wall_s": time.perf_counter() - t0}
    emit(row)
    del params
    torch.cuda.empty_cache()
    if not all(same.values()):
        raise AssertionError(f"mesh exact {arch}: plans differ from 1x1: "
                             f"{same}")
    return row


def _serve_turn(eng, cfg, seed: int) -> dict:
    """The serve phase's workload (monolithic prefill) through one
    engine, its launches counted from 0: outputs, decode ms/step,
    launches, steady transfers, peak memory."""
    reqs = _requests(cfg.vocab_size, list(SERVE_PROMPTS), [32] * 5, seed)
    steps0, dec0 = eng.stats["decode_steps"], eng.stats["decode_s"]
    pre0 = eng.stats["prefill_s"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve(reqs, max_active=2, chunked_prefill=False, radix=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = eng.stats["decode_steps"] - steps0
    _check_outs(outs, reqs, cfg.vocab_size)
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
    return {"outs": _tokens(outs), "wall_s": wall, "decode_steps": steps,
            "decode_ms_per_step": (eng.stats["decode_s"] - dec0) / steps
            * 1e3,
            "prefill_ms_per_request": (eng.stats["prefill_s"] - pre0)
            / len(reqs) * 1e3,
            "launches": launches,
            "paged_by_route": routes("paged_attention"),
            "flash_by_route": routes("flash_attention"),
            "steady": [list(x) for x in eng.last_steady_transfers],
            "resident_gb": resident / 2 ** 30,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def _agreement(a, b) -> dict:
    """Position-wise equal tokens and the equal prefix per request."""
    same = sum(x == y for o, p in zip(a, b) for x, y in zip(o, p))
    total = sum(len(o) for o in a)
    prefix = [next((i for i, (x, y) in enumerate(zip(o, p)) if x != y),
                   len(o)) for o, p in zip(a, b)]
    return {"equal_tokens": same, "tokens": total, "share": same / total,
            "equal_prefix": prefix}


def mesh_serve(serve_eng, smi: str) -> tuple:
    """Part ``serve``: starcoder2-7b at full width and `MESH_SERVE_LAYERS`
    of its 32 layers (the serve phase's weights, its first layers), bf16,
    on a 2x2 plan on the one card beside a 1x1 engine over the same
    weights. Returns the row and the 2x2 engine's launches from its first
    turn."""
    import dataclasses
    from repro_torch.kernels import api
    from repro_torch.models.common import flatten
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.sharding import ServePlan, plan_param_bytes
    cfg = dataclasses.replace(serve_eng.cfg, num_layers=MESH_SERVE_LAYERS)
    # the serve model's first layers: views of its stacked leaves (one
    # layer a group), no copy
    params = {n: t[:MESH_SERVE_LAYERS] if n.startswith("groups.") else t
              for n, t in flatten(serve_eng.model.params).items()}
    base = ServeEngine(cfg, params=params, kv_pool=PagedKVPool(
        page_tokens=128, placement_policy=EveryOtherSlow()))
    d, m = 2, 2
    plan = ServePlan(serve_mesh(d, m))
    counted = plan_param_bytes(cfg, plan)
    counted_1x1 = plan_param_bytes(cfg, ServePlan(serve_mesh(1, 1)))
    held_1x1 = sum(t.numel() * t.element_size()
                   for t in flatten(base.model.params).values())
    if held_1x1 != counted_1x1:
        raise AssertionError(f"1x1 holds {held_1x1} bytes, counted "
                             f"{counted_1x1}")
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params=params, mesh=serve_mesh(d, m),
                      kv_pool=PagedKVPool(page_tokens=128,
                                          placement_policy=EveryOtherSlow()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = eng.model.nbytes()
    if held != counted:
        raise AssertionError(f"the 2x2 shards hold {held} bytes, counted "
                             f"{counted}")
    turns = []
    seen = None
    for name, e in (("1x1", base), ("2x2", eng), ("2x2", eng),
                    ("1x1", base)):
        if name == "2x2" and seen is None:
            with first_calls(("paged_attention", "flash_attention")) as seen:
                turns.append((name, _serve_turn(e, cfg, 2)))
        else:
            turns.append((name, _serve_turn(e, cfg, 2)))
    first = turns[1][1]
    steps = first["decode_steps"]
    launches = first["launches"]
    want = {"paged_attention": steps * cfg.num_layers * d * m,
            "flash_attention": len(SERVE_PROMPTS) * cfg.num_layers * m}
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"2x2 {k}: {launches[k]} launches, want "
                                 f"{n}")
    if first["paged_by_route"]["split"] != want["paged_attention"]:
        raise AssertionError(f"2x2 paged routes {first['paged_by_route']}")
    if first["flash_by_route"]["wgmma"] != want["flash_attention"]:
        raise AssertionError(f"2x2 flash routes {first['flash_by_route']}")
    for name, t in turns:
        if not t["steady"] or any(x != [1, 1] for x in t["steady"]):
            raise AssertionError(f"{name} steady transfers {t['steady']}")
    # the recorded per-shard launches held to their plain versions, the
    # k = 1 paged launch and the longest prompt's flash launch timed
    checked = check_recorded(seen, "mesh serve")
    timed = {}
    for (args, kwargs) in seen["paged_attention"].values():
        if args[0].dim() != 3:
            continue
        layer = args[9]
        ptile = _replay_kw(kwargs)[1]
        nbytes, flops = bytes_and_flops(args[:9])
        timed["paged_attention"] = compare_and_time(
            "paged_attention starcoder2-7b 2x2 shard k=1 bfloat16",
            lambda: api.run("paged_attention", *args,  # noqa: B023
                            backend="cuda", tile=ptile),
            lambda: api.run("paged_attention", *args, backend="ref"),  # noqa
            sdpa_yardstick(args[:9], layer, 1), nbytes, flops, FP32_FLOPS,
            {"kernel": "paged_attention", "rows": 1, "dtype": "bfloat16",
             "plan": "2x2", "nvidia_smi": smi, "tile": ptile,
             "shape": {"b": args[0].shape[0], "hq": args[0].shape[1],
                       "hkv": args[1].shape[-2], "d": args[0].shape[-1],
                       "t": args[1].shape[2], "n_layers": args[1].shape[0],
                       "lengths": args[8].tolist()},
             "library": "scaled_dot_product_attention over K/V gathered "
                        "and dequantized beforehand (omits gather and "
                        "dequant)"}, device=True)
        break
    longest = max(seen["flash_attention"].values(),
                  key=lambda c: c[0][0].shape[1])
    q, k, v = longest[0][:3]
    kw, ftile = _replay_kw(longest[1])
    nbytes, flops = flash_bytes_and_flops(q, k, v,
                                          causal=kw.get("causal", True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    timed["flash_attention"] = compare_and_time(
        f"flash_attention starcoder2-7b 2x2 shard s={q.shape[1]} bfloat16",
        lambda: api.run("flash_attention", q, k, v, **kw, backend="cuda",
                        tile=ftile),
        lambda: api.run("flash_attention", q, k, v, **kw, backend="ref"),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        nbytes, flops, BF16_FLOPS,
        {"kernel": "flash_attention", "dtype": "bfloat16", "plan": "2x2",
         "nvidia_smi": smi, "tile": ftile,
         "shape": {"b": q.shape[0], "sq": q.shape[1], "hq": q.shape[2],
                   "hkv": k.shape[2], "d": q.shape[3], "causal": True},
         "library": "scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True) on (b, h, s, d) copies made "
                    "beforehand"}, device=True)
    del seen, longest, q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    turns_s = time.perf_counter() - t0
    prof = phase_profile(eng, steps=MESH_PROFILE_STEPS)
    by_name = {"1x1": [t for n, t in turns if n == "1x1"],
               "2x2": [t for n, t in turns if n == "2x2"]}
    row = {"phase": "mesh", "part": "serve", "nvidia_smi": smi,
           "config": f"starcoder2-7b, {MESH_SERVE_LAYERS} of 32 layers, "
                     f"bf16", "plan": "2x2",
           "peak_mem_device": "cuda:0",
           "devices": mesh_layout(plan.mesh),
           "path": "monolithic prefill (chunked_prefill=False, radix=False)",
           "weights_bytes_counted": {"1x1": counted_1x1, "2x2": counted},
           "weights_bytes_held": {"1x1": held_1x1, "2x2": held},
           "init_s": init_s,
           "turns_and_kernels_s": turns_s,
           "seconds": time.perf_counter() - t0,
           "turns": [name for name, _ in turns],
           "decode_ms_per_step": {n: [t["decode_ms_per_step"] for t in ts]
                                  for n, ts in by_name.items()},
           "prefill_ms_per_request": {
               n: [t["prefill_ms_per_request"] for t in ts]
               for n, ts in by_name.items()},
           "wall_s": {n: [t["wall_s"] for t in ts]
                      for n, ts in by_name.items()},
           "decode_steps": {n: ts[0]["decode_steps"]
                            for n, ts in by_name.items()},
           "launches": {n: ts[0]["launches"] for n, ts in by_name.items()},
           "paged_launches_per_step": {
               n: ts[0]["launches"]["paged_attention"]
               / ts[0]["decode_steps"] for n, ts in by_name.items()},
           "paged_by_route": first["paged_by_route"],
           "flash_by_route": first["flash_by_route"],
           "steady_steps": {n: len(ts[0]["steady"])
                            for n, ts in by_name.items()},
           "peak_mem_gb": {n: [t["peak_mem_gb"] for t in ts]
                           for n, ts in by_name.items()},
           "resident_gb": {n: ts[0]["resident_gb"]
                           for n, ts in by_name.items()},
           "bf16_agreement_with_1x1": _agreement(by_name["2x2"][0]["outs"],
                                                 by_name["1x1"][0]["outs"]),
           "repeat_agreement_2x2": _agreement(by_name["2x2"][0]["outs"],
                                              by_name["2x2"][1]["outs"]),
           "shard_kernels": {k: {f: r[f] for f in (
               "kernel_ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "max_abs_err", "max_err_over_limit", "shape")}
               for k, r in timed.items()},
           "launch_shapes_checked": checked,
           "profile_2x2": {k: prof[k] for k in (
               "decode_ms_per_step", "traced_ms_per_step",
               "device_busy_share", "kernels_per_step",
               "paged_attention_us_per_launch",
               "paged_attention_share_of_busy")}}
    emit(row)
    del eng, base, params
    gc.collect()
    torch.cuda.empty_cache()
    return row, launches, timed


def mesh_plan(smi: str) -> dict:
    """Part ``plan``: the dry run's serve-plan report on `H100_SXM`, every
    arch at `MESH_PLAN_MESHES`; plain arithmetic, no device work."""
    import types
    from repro_torch.core.roofline import H100_SXM
    from repro_torch.launch import dryrun
    args = types.SimpleNamespace(arch=None, serve_meshes=MESH_PLAN_MESHES,
                                 out=str(ROOT / "build" / "serve_plan"))
    t0 = time.perf_counter()
    recs = dryrun.serve_plan_main(args, hw=H100_SXM)
    row = {"phase": "mesh", "part": "plan", "nvidia_smi": smi,
           "hardware": H100_SXM.name, "meshes": MESH_PLAN_MESHES,
           "seconds": time.perf_counter() - t0, "cells": recs}
    emit(row)
    return row


def phase_mesh(base, smi: str) -> dict:
    """Serving across devices on one card: parts ``exact``, ``serve`` and
    ``plan`` (see the module docstring). Returns the launches of the 2x2
    serve run and of the exact plans, for the ``kernels`` line."""
    t0 = time.perf_counter()
    exact = mesh_exact(smi)
    exact_launches = exact["launches"]
    _, serve_launches, _ = mesh_serve(base, smi)
    mesh_plan(smi)
    emit({"phase": "mesh", "part": "done", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0,
          "exact_shapes": len(exact["shapes"])})
    total = {k: exact_launches.get(k, 0) + serve_launches.get(k, 0)
             for k in MESH_KERNELS}
    return total


# ---------------------------------------------------------------------------
# 15. examples: the JAX package's examples/ scripts on the port
# ---------------------------------------------------------------------------
# train_100m at its default --steps 300 writes four checkpoints of 2.2 GB
# (at 100, 200 and twice at 300: the trainer saves its last step again at
# its end), 8.7 GB, and takes ~42 s (139 ms a step): a whole run must
# stay within its 1,200 s, and a call may write 45 GiB (48.3 GB), 42.7 GB
# of which phase train wrote before its depth was cut. 60 steps write
# one checkpoint, at the end.
EXAMPLES_TRAIN_STEPS = 60
EXAMPLES_STEPS_NOTE = (
    f"--steps {EXAMPLES_TRAIN_STEPS} (the example's default is 300): 300 "
    f"steps write four 2.2 GB checkpoints (100, 200, 300 twice), 8.7 GB, "
    f"and take ~42 s, against the whole run's 1,200 s and a call's 45 GiB "
    f"of writes; {EXAMPLES_TRAIN_STEPS} write one (the end's); seq 256 "
    f"and batch 8 stay the example's")
EXAMPLES_KERNELS = ("paged_attention", "flash_attention")


def expected_routes(kernel: str, calls) -> dict:
    """{route: launches} the recorded calls must have taken: paged
    attention by q's dtype, k * g rows and head dim (`route`), flash by
    dtype and head dim."""
    if kernel == "paged_attention":
        from repro_torch.kernels.paged_attention.paged_attention import route
    else:
        from repro_torch.kernels.flash_attention.flash_attention import route
    out: dict = {}
    for args, _ in calls:
        q = args[0]
        if kernel == "paged_attention":
            rows = (q.shape[1] if q.ndim == 4 else 1) * (
                q.shape[-2] // args[1].shape[-2])
            r = route(q.dtype, rows, q.shape[-1])
        else:
            r = route(q.dtype, q.shape[-1])
        out[r] = out.get(r, 0) + 1
    return out


def run_example(name, argv, smi, magnitude=()) -> tuple:
    """One example's ``main`` on the card with the launch counts set to 0
    just before it and read just after, every launch of the paged and
    flash kernels recorded (`recording`) and then held to its plain
    version at the tile it ran at (`check_recorded`: 2 ulps, the kernels
    in `magnitude` to `magnitude_limit`); fails if a launch escaped the
    recording or took another route than its shapes give. Returns (its
    result, the row to emit, its launches)."""
    import importlib
    module = importlib.import_module(f"repro_torch.examples.{name}")
    argv = ["--device", "cuda"] + list(argv)
    _release()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        calls = {k: stack.enter_context(recording(k))
                 for k in EXAMPLES_KERNELS}
        out = module.main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    routes = {k: dict(_counters()[k].launches_by_route)
              for k in EXAMPLES_KERNELS}
    want_routes = {k: expected_routes(k, calls[k]) for k in EXAMPLES_KERNELS}
    row = {"phase": "examples", "part": name, "nvidia_smi": smi,
           "argv": argv, "wall_s": wall,
           "launches": {k: launches[k] for k in EXAMPLES_KERNELS},
           "recorded": {k: len(calls[k]) for k in EXAMPLES_KERNELS},
           "routes": {k: {r: n for r, n in routes[k].items() if n}
                      for k in EXAMPLES_KERNELS},
           "routes_expected": want_routes}
    bad = [k for k in EXAMPLES_KERNELS
           if launches[k] != len(calls[k]) or row["routes"][k]
           != want_routes[k]]
    if bad:
        emit(row)
        raise AssertionError(f"examples {name}: launches unrecorded or on "
                             f"another route: {bad}")
    checked = check_recorded({k: dict(enumerate(v)) for k, v in calls.items()},
                             f"examples {name}", magnitude,
                             phase="examples", summarize=True)
    row["launches_checked"] = len(checked)
    row["worst_over_limit"] = max((c["max_err_over_limit"]
                                   for c in checked), default=None)
    del calls, checked
    _release()
    return out, row, {k: launches[k] for k in EXAMPLES_KERNELS}


def phase_examples(smi: str) -> dict:
    """The four examples the port adds (`repro_torch.examples`), each
    through its ``main`` with ``--device cuda``: serve_stream (the
    streams equal `serve()`, a cancel, the pool empty), serve_lm (Sibyl
    placement, the decode trace's replay, k = 4 speculative tokens equal
    to `generate`'s), quickstart (40 steps, checkpoints, `generate`),
    train_100m (135,313,152 fp32 parameters at seq 256 x batch 8,
    `EXAMPLES_TRAIN_STEPS` steps under `Supervisor`). Their own
    assertions hold or the phase fails; beside them quickstart's loss
    falls, train_100m's is finite and falls with no restart. Every paged
    and flash launch is held to its plain version (`run_example`): 2
    ulps, train_100m's fp32 flash launches `magnitude_limit`.
    Returns the phase's launches."""
    t0 = time.perf_counter()
    total: dict = {}
    out, row, launches = run_example("serve_stream", [], smi)
    s = out["summary"]
    row.update(tokens=s["tokens"], n_done=s["n_done"],
               throughput_tok_s=s["throughput_tok_s"],
               ttft_ms={k: s["ttft"][k] for k in ("p50_ms", "p99_ms")},
               tpot_ms={k: s["tpot"][k] for k in ("p50_ms", "p99_ms")},
               shared_puts=out["shared_puts"],
               cancelled_after=len(out["partial"]),
               live_pages=out["live_pages"])
    emit(row)
    _add(total, launches)

    out, row, launches = run_example("serve_lm", [], smi)
    spec = out["spec_stats"]
    row.update(tokens=sum(len(o) for o in out["outs"]),
               pool_stats=out["pool_stats"], sibyl=out["sibyl"],
               replay_events=len(out["events"]),
               replay_avg_latency_us=out["replay"]["avg_latency_us"],
               replay_p99_latency_us=out["replay"]["p99_latency_us"],
               replay_note="the HSS simulator's latencies (H&M), not times "
                           "of the card",
               spec_accept_rate=[d["accept_rate"] for d in spec],
               spec_tokens_per_step=[d["tokens_per_step"] for d in spec],
               spec_accepted=[d["accepted"] for d in spec])
    emit(row)
    _add(total, launches)

    out, row, launches = run_example("quickstart", [], smi)
    losses = out["losses"]
    row.update(losses=losses, generated=[o.tolist() for o in
                                         out["generated"]])
    emit(row)
    _add(total, launches)
    if not (all(math.isfinite(x) for x in losses) and losses[-1]
            < losses[0]):
        raise AssertionError(f"examples quickstart: the loss did not fall: "
                             f"{losses}")

    # its fp32 flash launches (d 64, s 256) miss 2 ulps by the order of
    # their sums, as recurrentgemma-2b's fp32 flash does (phase mesh):
    # held to magnitude_limit, the 2-ulp reading and the loop in the
    # kernel's order beside it, the broken variants over the limit
    out, row, launches = run_example(
        "train_100m", ["--steps", str(EXAMPLES_TRAIN_STEPS)], smi,
        magnitude=("flash_attention",))
    losses = out["losses"]
    step_ms = [h["step_time_s"] * 1e3 for h in out["history"]]
    med = statistics.median(step_ms)
    row.update(param_count=out["param_count"], steps=out["steps"],
               seq=out["seq"], batch=out["batch"],
               steps_note=EXAMPLES_STEPS_NOTE, restarts=out["restarts"],
               loss_first=losses[0], loss_last=losses[-1],
               step_ms_median=med, step_ms_first=step_ms[0],
               tokens_per_s=out["seq"] * out["batch"] / (med / 1e3))
    emit(row)
    _add(total, launches)
    if out["restarts"] != 0 or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"examples train_100m: {out['restarts']} "
                             f"restarts, or the loss is not finite or did "
                             f"not fall: {losses}")
    emit({"phase": "examples", "part": "done", "launches": total,
          "wall_s": time.perf_counter() - t0})
    return total


def kernels_line(full, launches, stencil=None) -> dict:
    """One entry per kernel at its main path's shapes (bf16 where the path
    runs bf16): paged attention at one decode row and flash attention at
    the longest serve prompt (600 tokens, its `device_ms`), launches from
    the serve phase's run; the SSD scan at mamba2-780m's generate prefill (B=3,
    S=1536) and the RG-LRU scan at recurrentgemma-2b's (B=2, S=2300),
    launches from the hybrid phase's generate calls; hdiff and vadvc at
    the COSMO grid in fp32, launches from the stencil phase's main path.
    Kernels whose phase did not run are left out."""
    rows = []
    if full is not None:
        rows += [(name, full[key]) for name, key in (
            ("paged_attention", ("paged_attention", 1, "bfloat16")),
            ("flash_attention", ("flash_attention", 600, "bfloat16")),
            ("ssd_scan", ("ssd_scan", 3, 1536, "bfloat16")),
            ("rglru_scan", ("rglru_scan", 2, 2300, "float32")))]
    if stencil is not None:
        rows += [(name, stencil[(name, "float32")])
                 for name in ("hdiff", "vadvc")]
    out = []
    for name, k in rows:
        source, replaces = KERNELS[name]
        source = ROUTE_SOURCES.get((name, k.get("route")), source)
        out.append({
            "name": name, "route": "cuda", "impl": "cuda",
            "kernel_route": k.get("route", "simt"), "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": k["max_abs_err"], "max_err": k["max_abs_err"],
            "tol": k["tol"], "tol_rule": k["tol_rule"],
            "max_err_over_limit": k["max_err_over_limit"],
            "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"],
            "timing": k.get("timing"),
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "library": k.get("library"), "shape": k["shape"]})
    return {"kernels": out}


def serve_profiles(eng) -> None:
    """The serve phase's decode modes in turns (`serve_modes`), the fused
    step at its knee and at the launch before tiles, after an untimed
    turn, in the order knee, fixed, fixed, knee (kernels per traced step
    beside the decode ms, paired), and the knee cache's round trip."""
    serve_modes(eng)
    phase_profile(eng, steps=4)
    order = ("auto", "cuda", "cuda", "auto")
    runs = [phase_profile(eng, backend=b) for b in order]
    knee = [p for b, p in zip(order, runs) if b == "auto"]
    fixed = [p for b, p in zip(order, runs) if b == "cuda"]

    def per(key):
        return {"knee": [p[key] for p in knee],
                "fixed": [p[key] for p in fixed],
                "knee_over_fixed_median": statistics.median(
                    p[key] for p in knee) / statistics.median(
                    p[key] for p in fixed)}
    emit({"phase": "profile", "case": "knee vs the launch before "
          "tiles", "order": ["knee" if b == "auto" else "fixed"
                             for b in order],
          "warm_up": "one untimed profile of 4 steps first",
          "kernels_per_step": per("kernels_per_step"),
          "decode_ms_per_step": per("decode_ms_per_step"),
          "traced_ms_per_step": per("traced_ms_per_step"),
          "device_busy_share": per("device_busy_share")})
    # a traced window's mean, a page fill in it or not
    if len({round(p["kernels_per_step"]) for p in knee + fixed}) \
            != 1:
        raise AssertionError("kernels per step differ between the "
                             "knee and the launch before tiles")
    knee_round_trip(eng)


PHASES = ("kernel", "exact", "serve", "chunked", "spec", "overload",
          "families", "hybrid", "train", "napel", "stencil", "sibyl", "mesh",
          "examples")
DISK_BUDGET_BYTES = 45 * 2 ** 30     # what one call of the card may write
DISK_START: dict = {}


IO_KEYS = ("wchar", "write_bytes", "cancelled_write_bytes")


def io_counts() -> dict | None:
    """This process's write counters from ``/proc/self/io`` (its threads,
    and its children once reaped): ``wchar``, the bytes it passed to
    write calls (files, pipes and the terminal alike), and
    ``write_bytes``, the bytes it sent to storage, deleted files included
    (``cancelled_write_bytes`` those never written back); the card's
    machine reports ``write_bytes`` as 0, so the budget reads the larger.
    None where the file cannot be read."""
    try:
        fields = dict(line.split(": ") for line in
                      Path("/proc/self/io").read_text().splitlines())
    except (OSError, ValueError):
        return None
    return {k: int(fields[k]) for k in IO_KEYS if k in fields}


def _io_delta(after, before) -> dict | None:
    if after is None or before is None:
        return None
    return {k: after[k] - before[k] for k in after}


@contextlib.contextmanager
def disk(phase: str):
    """Emit the phase's storage writes (`io_counts` before and after it)
    and the run's so far, with the phase's wall seconds and the run's,
    on a line of the phase's own."""
    before = io_counts()
    t0 = time.perf_counter()
    yield
    after = io_counts()
    emit({"phase": phase, "part": "disk", "io": _io_delta(after, before),
          "run_io": _io_delta(after, DISK_START.get("io")),
          "wall_s": time.perf_counter() - t0,
          "run_s": time.perf_counter() - RUN_T0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=PHASES,
                    help="run the device phase and this one phase only "
                         "(chunked, spec, overload, sibyl and mesh build "
                         "the serve phase's model)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False    # plain fp32 is fp32
    torch.backends.cudnn.allow_tf32 = False
    DISK_START["io"] = io_counts()
    with disk("device"):
        dev = phase_device()
    smi = dev["nvidia_smi"]
    run = (lambda p: args.only in (None, p))
    full = serve = None
    launches = {}
    mesh_launches = None
    if run("kernel"):
        with disk("kernel"):
            full = phase_kernel()
    keep_knees()
    if run("exact"):
        with disk("exact"):
            phase_exact()
    if run("serve") or run("chunked") or run("spec") or run("overload") \
            or run("sibyl") or run("mesh"):
        with disk("serve"):
            serve, eng = phase_serve()
            if args.only in (None, "serve"):
                serve_profiles(eng)
        if run("chunked"):
            with disk("chunked"):
                phase_chunked(eng)
        if run("spec"):
            with disk("spec"):
                phase_spec(eng)
        if run("overload"):
            with disk("overload"):
                phase_overload(eng, serve, smi)
        if run("sibyl"):
            with disk("sibyl"):
                phase_sibyl(eng, serve, smi)
        if run("mesh"):
            with disk("mesh"):
                mesh_launches = phase_mesh(eng, smi)
        del eng
        # a finished session's radix tree and its release callback form
        # reference cycles: collect them so the next phase's memory
        # readings start from its own weights
        gc.collect()
        torch.cuda.empty_cache()
        launches.update({k: serve["launches"][k]
                         for k in ("paged_attention", "flash_attention")})
    if run("families"):
        # the families' paths launch the serving kernels at new shapes:
        # their counts join the serve phase's
        with disk("families"):
            _add(launches, phase_families())
    if run("hybrid"):
        with disk("hybrid"):
            _, hybrid_launches = phase_hybrid()
        launches["ssd_scan"] = hybrid_launches["mamba2-780m"]["ssd_scan"]
        launches["rglru_scan"] = \
            hybrid_launches["recurrentgemma-2b"]["rglru_scan"]
    if run("train"):
        if run("napel"):
            # the napel phase's meta counts, on the CPU, run beside the
            # train phase's work on the card
            start_meta_counts(NAPEL_EARLY_WORKERS)
        # the training path launches flash, SSD and RG-LRU at new shapes:
        # its trainers' counts join the serving and hybrid phases'
        with disk("train"):
            _add(launches, phase_train(smi))
    if run("napel"):
        # the counted and timed steps launch flash, SSD and RG-LRU: their
        # counts join the other phases'
        with disk("napel"):
            _add(launches, phase_napel(smi))
    stencil = None
    if run("stencil"):
        with disk("stencil"):
            stencil, stencil_launches = phase_stencil()
        launches.update(stencil_launches)
    if mesh_launches is not None:
        # the plans launch the serving kernels (and the scans) at
        # per-shard shapes: their counts join the other phases'
        _add(launches, mesh_launches)
    if run("examples"):
        # the examples launch the serving kernels at head dim 16 with
        # 8-token pages and flash in fp32: their counts join the others'
        with disk("examples"):
            _add(launches, phase_examples(smi))
    if MAIN_KNEES:
        knee_audit(smi)
    total = _io_delta(io_counts(), DISK_START["io"])
    written = None if total is None else max(
        total.get("wchar", 0), total.get("write_bytes", 0))
    emit({"phase": "disk", "nvidia_smi": smi, "run_io": total,
          "written_bytes": written, "budget_bytes": DISK_BUDGET_BYTES,
          "within_budget": None if written is None
          else written <= DISK_BUDGET_BYTES})
    if full is not None or stencil is not None:
        emit(kernels_line(full, launches, stencil))
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_meta_counts()
