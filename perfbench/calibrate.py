"""Readings that the limits of ``correct`` are set from, for one cell on
the card: the program's number on each seed, and the control's (the
plain reference in the precision below the configuration's, on the same
inputs) on the seeds given, all in one process. The benchmark's own runs
never run this.

    python3 perfbench/calibrate.py --workload sc2-7b.decode-c32 \\
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 30 \\
        --out build/calibration/decode.jsonl

``--fault half_batch`` runs the program with half of each batch left out
(the mean taken over the rest), planted in its train step, for the
fault's reading. One JSON line per seed goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from perfbench.run import _environment  # noqa: E402


def half_batch():
    """Plant the fault: the train step sees the first half of the rows."""
    from repro_torch.train import train_step as ts
    make = ts.make_train_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)
        return lambda st, b: step(st, {k: v[:v.shape[0] // 2]
                                       for k, v in b.items()})

    ts.make_train_step = broken


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    _environment()
    from perfbench.lib import harness
    if args.fault == "half_batch":
        half_batch()
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = harness.run_cell(args.workload, seed, args.seconds, False,
                                control=seed in control)
        row = {"seed": seed, "fault": args.fault, "wall_s":
               time.perf_counter() - t, "checked": line["checked"],
               "control": line.get("control"),
               "metrics": line["metrics"]}
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
