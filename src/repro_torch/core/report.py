"""Render the dry-run and roofline tables from the port's cached dry-run
records (`launch.dryrun`, experiments/dryrun_torch/) — the port of the
JAX package's ``repro/core/report.py``: one device (mesh 1x1) or one
device of either pod (``pod16x16``, ``pod2x16x16``), and a variant's
roofline against the baseline's (`variant_delta`).
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


def _colls(c: dict) -> str:
    return " ".join(
        f"{k.replace('collective-', 'c-')}:{v['count']:.0f}/"
        f"{v['bytes'] / 1e9:.1f}"
        for k, v in c.items()
        if isinstance(v, dict) and v.get("count")) or "none"


def dryrun_table(mesh="1x1", dryrun_dir=DRYRUN_DIR) -> str:
    """One row per cell: the count's wall time, ops dispatched (one
    device), kernel entries, collectives and argument bytes. For a pod
    mesh, as the reference's, both pods side by side: the 16 x 16 count
    and the 2 x 16 x 16 one, the collectives and argument bytes of the
    first."""
    if mesh != "1x1":
        single = {(r["arch"], r["shape"]): r
                  for r in load("pod16x16", dryrun_dir=dryrun_dir)}
        multi = {(r["arch"], r["shape"]): r
                 for r in load("pod2x16x16", dryrun_dir=dryrun_dir)}
        lines = [
            "| arch | shape | count 16x16 | count 2x16x16 | "
            "collectives 16x16 (count/GB) | argbytes/dev |",
            "|---|---|---|---|---|---|"]
        for key in sorted(set(single) | set(multi)):
            r = single.get(key) or multi[key]
            m = multi.get(key)
            s16 = single.get(key, {}).get("count_s", float("nan"))
            lines.append(
                f"| {r['arch']} | {r['shape']} | {s16:.1f}s | "
                f"{(m or {}).get('count_s', float('nan')):.1f}s | "
                f"{_colls(r['collectives'])} | "
                f"{r['memory']['argument_bytes'] / 2 ** 30:.2f}GiB |")
        return "\n".join(lines)
    lines = [
        "| arch | shape | count | ops | kernel entries | collectives "
        "(count/GB) | argbytes/dev |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(load("1x1", dryrun_dir=dryrun_dir),
                    key=lambda r: (r["arch"], r["shape"])):
        ks = " ".join(f"{k}:{v['entries']}" for k, v in
                      sorted(r["kernels"].items())) or "none"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['count_s']:.1f}s | "
            f"{r['cost']['ops']} | {ks} | {_colls(r['collectives'])} | "
            f"{r['memory']['argument_bytes'] / 2 ** 30:.2f}GiB |")
    return "\n".join(lines)


def pod_table(dryrun_dir=DRYRUN_DIR) -> str:
    """One row per arch, one column per shape: per-device live GB on the
    16 x 16 pod and on the 2 x 16 x 16 one ("*" past the card's memory),
    the 16 x 16 count's bottleneck (compute, memory, collective) and its
    seconds; a cell that did not count shows its status."""
    recs = {}
    for p in sorted(Path(dryrun_dir).glob("*__pod*.json")):
        r = json.loads(p.read_text())
        if r.get("variant", "baseline") == "baseline":
            recs[(r["arch"], r["shape"], r["mesh"])] = r

    def gb(r):
        if r is None:
            return "-"
        if r["status"] != "ok":
            return r["status"]
        return (f"{r['memory']['live_bytes_per_device'] / 1e9:.1f}"
                + ("" if r["memory"]["fits_hbm"] else "*"))

    order = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    shapes = sorted({s for _, s, _ in recs},
                    key=lambda s: (order.index(s) if s in order
                                   else len(order), s))
    lines = ["| arch | " + " | ".join(shapes) + " |",
             "|---|" + "---|" * len(shapes)]
    for arch in sorted({a for a, _, _ in recs}):
        cells = []
        for shape in shapes:
            one = recs.get((arch, shape, "pod16x16"))
            two = recs.get((arch, shape, "pod2x16x16"))
            if one is None and two is None:
                cells.append("")
                continue
            tail = ""
            if one is not None and one["status"] == "ok":
                tail = (f" {one['roofline']['bottleneck'][:4]}"
                        f" {one['count_s']:.1f} s")
            cells.append(f"{gb(one)} / {gb(two)}{tail}")
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def variants_table(variants, mesh="pod16x16",
                   dryrun_dir=DRYRUN_DIR) -> str:
    """Per variant on `mesh`: cells counted ok and in error (the first
    error), and over the ok cells the range of the roofline step and of
    the live bytes against the baseline (`variant_delta`'s x)."""
    lines = ["| variant | ok | error | step x (min-max) | live GB x "
             "(min-max) |", "|---|---|---|---|---|"]
    for v in variants:
        recs = [json.loads(p.read_text()) for p in sorted(
            Path(dryrun_dir).glob(f"*__{mesh}__variant_{v}.json"))]
        ok = [r for r in recs if r["status"] == "ok"]
        err = [r for r in recs if r["status"] != "ok"]
        steps, mems = [], []
        for r in ok:
            d = variant_delta(r["arch"], r["shape"], v, mesh, dryrun_dir)
            if d:
                steps.append(d["step_time_bound_s"]["x"])
                mems.append(d["mem_gib"]["after"]
                            / max(d["mem_gib"]["before"], 1e-12))

        def rng(xs):
            return f"{min(xs):.3f}-{max(xs):.3f}" if xs else "-"

        first = err[0]["error"].split(":")[0] if err else ""
        lines.append(f"| {v} | {len(ok)} | {len(err)}"
                     f"{' (' + first + ')' if first else ''} | "
                     f"{rng(steps)} | {rng(mems)} |")
    return "\n".join(lines)


def variant_delta(arch, shape, variant, mesh="pod16x16",
                  dryrun_dir=DRYRUN_DIR) -> dict:
    """A variant's roofline terms and live bytes against the baseline's
    on `mesh` (the reference's keys); {} when either record is missing
    or not ok."""
    base = load(mesh, "baseline", dryrun_dir)
    var = load(mesh, variant, dryrun_dir)
    b = next((r for r in base if r["arch"] == arch and r["shape"] == shape),
             None)
    v = next((r for r in var if r["arch"] == arch and r["shape"] == shape),
             None)
    if not b or not v:
        return {}
    out = {"variant": variant}
    for term in ("compute_s", "memory_s", "collective_s",
                 "step_time_bound_s", "roofline_fraction"):
        out[term] = {"before": b["roofline"][term],
                     "after": v["roofline"][term],
                     "x": (v["roofline"][term] /
                           max(b["roofline"][term], 1e-15))}
    out["mem_gib"] = {
        "before": b["memory"]["live_bytes_per_device"] / 2 ** 30,
        "after": v["memory"]["live_bytes_per_device"] / 2 ** 30}
    return out


if __name__ == "__main__":
    print("## Roofline (one H100, baseline)\n")
    print(roofline_table())
    print("\n## Roofline (one device of the 16x16 pod, baseline)\n")
    print(roofline_table("pod16x16"))
    print("\n## Dry-run (one device)\n")
    print(dryrun_table())
    print("\n## Dry-run (both pods)\n")
    print(dryrun_table("pod16x16"))
    print("\n## Per device of each pod\n")
    print(pod_table())
    from repro_torch.launch.variants import VARIANTS
    print("\n## Variants on the 16x16 pod\n")
    print(variants_table(VARIANTS[1:]))
