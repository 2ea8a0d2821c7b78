"""Sibyl on hybrid storage: online RL placement against heuristics on an
MSRC-like trace (thesis Ch. 7 in miniature) — the port's counterpart of
the JAX package's ``examples/sibyl_storage.py``. The DQN runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.sibyl_storage --device cpu

The latencies are the simulator's model of an NVMe + HDD pair (`HssEnv`,
``H&L``), not times of the device the agent runs on.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.sibyl.agent import SibylAgent, SibylConfig, run_policy
from repro_torch.core.sibyl.env import HssEnv, hss_config
from repro_torch.core.sibyl.policies import CDE, HPS, FastOnly
from repro_torch.core.sibyl.traces import WORKLOADS, generate

FEATURE_NAMES = ("size", "is_write", "fast_fill", "fast_q", "slow_q",
                 "hotness", "recency", "in_fast", "lat_ema", "config")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workload", default="rsrch_0", choices=sorted(WORKLOADS))
    ap.add_argument("--requests", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=1, help="trace seed")
    ap.add_argument("--warmup", type=int, default=2000,
                    help="leading requests left out of the latency stats")
    ap.add_argument("--agent-seed", type=int, default=3)
    ap.add_argument("--hss", default="H&L",
                    choices=("H&L", "H&M", "M&L", "H&M&L"))
    ap.add_argument("--fast-cap", type=int, default=1024,
                    help="fast-device capacity in pages")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    spec = WORKLOADS[args.workload]
    trace = generate(spec, args.requests, seed=args.seed)
    print(f"workload {spec.name}: {len(trace)} requests, "
          f"read_ratio={spec.read_ratio}, scans={spec.scan_fraction}")
    devices = hss_config(args.hss, fast_cap=args.fast_cap)
    agent = SibylAgent(SibylConfig(seed=args.agent_seed,
                                   n_actions=len(devices)),
                       device=args.device)
    results = {}
    for pol in [FastOnly(), CDE(), HPS(), agent]:
        env = HssEnv(hss_config(args.hss, fast_cap=args.fast_cap))
        results[pol.name] = run_policy(env, trace, pol, warmup=args.warmup)
    fo = results["fast_only"]["avg_latency_us"]
    for name, r in results.items():
        r["norm"] = r["avg_latency_us"] / fo
        print(f"{name:10s} avg={r['avg_latency_us']:10.1f}us "
              f"norm={r['norm']:6.3f} "
              f"p99={r['p99_latency_us'] / 1e3:8.1f}ms "
              f"migrations={r['migrations']}")
    imp = agent.explain()
    top = [FEATURE_NAMES[i] for i in np.argsort(-imp)[:3]]
    print("sibyl's top decision features:", top)
    return {"trace": trace, "results": results, "agent": agent,
            "importance": imp, "top_features": top}


if __name__ == "__main__":
    main()
