"""Render the dry-run and roofline tables from the port's cached dry-run
records (`launch.dryrun`, experiments/dryrun_torch/) — the port of the
JAX package's ``repro/core/report.py`` at mesh 1x1.

`variant_delta` waits for the port of ``launch/variants.py`` (ROADMAP
Queue 1 item 6c, the dry run on a mesh): it raises.
"""
from __future__ import annotations

import json
from pathlib import Path

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def load(mesh=None, variant="baseline", dryrun_dir=DRYRUN_DIR):
    out = []
    for p in sorted(Path(dryrun_dir).glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("status") != "ok":
            continue
        if variant is not None and r.get("variant", "baseline") != variant:
            continue
        base_mesh = r["mesh"].split("__")[0]
        if mesh is not None and base_mesh != mesh:
            continue
        r["base_mesh"] = base_mesh
        out.append(r)
    return out


def _fmt_s(x):
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def roofline_table(mesh="1x1", variant="baseline",
                   dryrun_dir=DRYRUN_DIR) -> str:
    rows = load(mesh, variant, dryrun_dir)
    lines = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "frac | 6ND/counted | HBM GiB/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        rl = r["roofline"]
        mem = r["memory"]["live_bytes_per_device"] / 2 ** 30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(rl['compute_s'])} | "
            f"{_fmt_s(rl['memory_s'])} | {_fmt_s(rl['collective_s'])} | "
            f"{rl['bottleneck']} | {rl['roofline_fraction']:.3f} | "
            f"{min(r['useful_flops_ratio'], 9.99):.2f} | {mem:.1f} | "
            f"{'y' if r['memory']['fits_hbm'] else 'n'} |")
    return "\n".join(lines)


def dryrun_table(dryrun_dir=DRYRUN_DIR) -> str:
    """One row per cell: the count's wall time, ops dispatched, kernel
    entries, collectives and argument bytes (one device: the reference's
    second mesh has no counterpart)."""
    lines = [
        "| arch | shape | count | ops | kernel entries | collectives "
        "(count/GB) | argbytes/dev |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(load("1x1", dryrun_dir=dryrun_dir),
                    key=lambda r: (r["arch"], r["shape"])):
        c = r["collectives"]
        cs = " ".join(
            f"{k.replace('collective-', 'c-')}:{v['count']:.0f}/"
            f"{v['bytes'] / 1e9:.1f}"
            for k, v in c.items()
            if isinstance(v, dict) and v.get("count")) or "none"
        ks = " ".join(f"{k}:{v['entries']}" for k, v in
                      sorted(r["kernels"].items())) or "none"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['count_s']:.1f}s | "
            f"{r['cost']['ops']} | {ks} | {cs} | "
            f"{r['memory']['argument_bytes'] / 2 ** 30:.2f}GiB |")
    return "\n".join(lines)


def variant_delta(arch, shape, variant, mesh="1x1") -> dict:
    raise NotImplementedError(
        "variant_delta compares a variant's dry run with the baseline's; "
        "the port has no variants until launch/variants.py is ported "
        "(ROADMAP Queue 1 item 6c)")


if __name__ == "__main__":
    print("## Roofline (one H100, baseline)\n")
    print(roofline_table())
    print("\n## Dry-run\n")
    print(dryrun_table())
