"""What the benchmark runs, found by name.

`BENCHMARK.json` at the checkout's root lists the cells (``workloads``)
and the metrics. Everything else is a file of its own under
``perfbench/``, found by the name an entry gives:

- a configuration ``configs/<config>.json`` (the sizes as run, the
  published source, the plain reference module that computes it);
- a traffic mix ``mixes/<traffic>.json`` (parameters only), read by the
  generator ``traffic/<kind>.py`` that the mix names;
- a per-layer metric ``metrics/<metric>.py`` with ``read(record)``;
- a plain reference ``reference/<module>.py``.

So a later change adds a cell, a configuration, a mix or a metric by
adding a file and an entry, and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return json.loads((BENCH_DIR / "configs" / f"{_name(name)}.json")
                      .read_text())


def mix(name: str) -> dict:
    return json.loads((BENCH_DIR / "mixes" / f"{_name(name)}.json")
                      .read_text())


def traffic_module(kind: str):
    return importlib.import_module(f"perfbench.traffic.{_name(kind)}")


def reference_module(name: str):
    return importlib.import_module(f"perfbench.reference.{_name(name)}")


def metric_reader(name: str):
    """``read(record) -> float | None`` of ``metrics/<name>.py``. A name
    may hold dots, so the file is loaded by path, not by import name."""
    path = BENCH_DIR / "metrics" / f"{_name(name)}.py"
    if not path.is_file():
        raise KeyError(f"no reader {path.relative_to(ROOT)} for metric "
                       f"{name!r}")
    mod_name = "perfbench.metrics._" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics this cell reports: those listing it under
    ``workloads``, and those that list no cells."""
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those listing it, and
    those without ``workloads`` whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out
