"""Continuous-batching serving with paged KV tiering driven by the Sibyl
agent — the data-driven placement policy applied to a production
subsystem, learning from *real* serving feedback (observed page-gather
latency + slow-tier hit penalty), with the decode-time pool workload
recorded as a trace and replayed through the Ch. 7 HSS simulator. The
port of the JAX package's ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

``params`` (a flat state dict, e.g. carried from the JAX example's
weights by `repro_torch.convert.params_from_numpy`) replaces the seeded
weights. The replay's latencies are the simulator's model of an NVMe +
SATA SSD pair (``H&M``), not times of the device the agent runs on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.core.sibyl.agent import SibylAgent, run_policy
from repro_torch.core.sibyl.env import HssEnv, hss_config
from repro_torch.core.sibyl.traces import DecodeTraceRecorder
from repro_torch.examples import check_device, parser
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.placement import SibylPlacement


def main(argv=None, *, params=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    check_device(args.device)
    device = args.device
    cfg = smoke_config("llama3-405b")   # reduced-config llama-family stack
    recorder = DecodeTraceRecorder()
    pool = PagedKVPool(page_tokens=8, fast_capacity_pages=16,
                       placement_policy=SibylPlacement(seed=0,
                                                       device=device))
    pool.recorder = recorder
    eng = ServeEngine(cfg, params=params, kv_pool=pool, device=device)

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
    reqs = [
        # two identical prompts: their prefill pages are stored once and
        # ref-counted (prefix cache), freed when the last holder retires
        Request(shared.copy(), max_new_tokens=16),
        Request(shared.copy(), max_new_tokens=12),
        Request(rng.integers(0, cfg.vocab_size, 24).astype(np.int32),
                max_new_tokens=20),
        Request(rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                max_new_tokens=8),
    ]
    # max_active=2 staggers admission: requests join mid-decode as earlier
    # ones retire at their own lengths and free their pages
    outs = eng.serve(reqs, max_active=2)
    print(f"generated {sum(map(len, outs))} tokens over {len(reqs)} "
          f"requests (peak_active={eng.last_peak_active}); "
          f"prefill {eng.stats['prefill_s']:.2f}s decode "
          f"{eng.stats['decode_s']:.2f}s")
    print("kv pool:", pool.stats, f"live_pages={len(pool.pages)}")
    agent = pool.policy.agent
    print(f"sibyl: {agent.t} transitions, last_reward="
          f"{pool.policy.last_reward:.3f}, eps={agent.epsilon:.3f}")
    assert len(pool.pages) == 0, "retired requests must free their pages"
    assert pool.stats["shared_puts"] > 0, "identical prompts must share pages"
    sibyl = {"transitions": agent.t, "last_reward": pool.policy.last_reward,
             "epsilon": agent.epsilon}
    pool_stats = dict(pool.stats)
    serve_stats = dict(eng.stats)

    # replay the recorded decode-time pool workload through the HSS
    # simulator (Ch. 7) — same trace schema as the synthetic MSRC set
    res = run_policy(HssEnv(hss_config("H&M", fast_cap=16)),
                     recorder.events, SibylAgent(device=device))
    print(f"decode-trace replay ({len(recorder.events)} events): "
          f"avg {res['avg_latency_us']:.1f}us "
          f"p99 {res['p99_latency_us']:.1f}us")

    # speculative multi-token decode: n-gram drafts verified 4 rows at a
    # time through the widened fused step — same greedy tokens, fewer
    # host<->device round trips per token (the whole point)
    spool = PagedKVPool(page_tokens=8)
    state = {n: p for n, p in eng.model.weights.named_parameters()}
    seng = ServeEngine(cfg, params=state, kv_pool=spool, speculate=4,
                       draft="ngram", device=device)
    souts = seng.serve([Request(shared.copy(), max_new_tokens=16),
                        Request(rng.integers(0, cfg.vocab_size, 24)
                                .astype(np.int32), max_new_tokens=20)],
                       max_active=2)
    # greedy-equivalent to the plain 1-token fused path
    ref = ServeEngine(cfg, params=state, device=device,
                      kv_pool=PagedKVPool(page_tokens=8))
    [bout] = ref.generate([Request(shared.copy(), max_new_tokens=16)])
    np.testing.assert_array_equal(souts[0], bout)
    for i, d in enumerate(seng.last_request_stats):
        print(f"speculative req {i}: {d['tokens']} tokens in {d['steps']} "
              f"verify steps ({d['tokens_per_step']:.2f} tok/step, "
              f"accept_rate={d['accept_rate']:.2f})")
    assert any(d["accepted"] > 0 for d in seng.last_request_stats), \
        "greedy decode of these prompts should accept some drafts"
    return {"outs": outs, "peak_active": eng.last_peak_active,
            "serve_stats": serve_stats, "pool_stats": pool_stats,
            "live_pages": len(pool.pages), "sibyl": sibyl,
            "events": list(recorder.events), "replay": res,
            "spec_outs": souts, "plain_out": bout,
            "spec_stats": [dict(d) for d in seng.last_request_stats]}


if __name__ == "__main__":
    main()
