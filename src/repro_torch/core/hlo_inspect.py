"""Op and collective breakdown of a counted step — the port of the JAX
package's ``repro/core/hlo_inspect.py``.

The reference attributes trip-count-weighted bytes of compiled HLO
instructions to their shapes and source ops (``op_name`` metadata),
reading the HLO text the dry run saves with ``--save-hlo``. The port
reads the same breakdown from a `CostCounter` that counted the step
with ``inspect=True``, or from the op log the port's dry run saves in
its place (`op_log`; ``--save-hlo`` writes ``<cell>.ops.json``): bytes
(operands + outputs, `bytes_accessed`'s rule) per (op, output shape,
source), each kernel call as op ``kernel:<name>`` with its ``work``
bytes. The source is the innermost ``torch.profiler.record_function``
range open at the op, else the innermost function of the port on the
Python stack (``models/attention.py:attn_apply``); ops the autograd
engine runs outside any range and any port frame read "autograd".

Each function takes a counter (with ``position=`` one mesh position's
share of a plan's count), an op log (a dict), or the path of a saved
one, and gives the same rows from each.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.core.hlo_cost import CostCounter


def _rows(table: dict) -> list[dict]:
    return [{"op": k[0], "shape": k[1], "source": k[2], **v}
            for k, v in table.items()]


def op_log(counter: CostCounter, position=None) -> dict:
    """The counter's breakdown as the dry run saves it: ``rows`` and
    ``coll_rows`` (lists of ``{op, shape, source, count, bytes}``) and
    ``kernels`` (``{kernel, route, work}`` per call); with `position`,
    that mesh position's share."""
    if not counter.inspect:
        raise ValueError("an op log needs CostCounter(inspect=True)")
    src = counter if position is None else counter.position_bucket(position)
    return {"position": None if position is None else list(position),
            "rows": _rows(src.rows), "coll_rows": _rows(src.coll_rows),
            "kernels": [{"kernel": e["kernel"], "route": e["route"],
                         "work": {k: v for k, v in e.items()
                                  if k not in ("kernel", "route")}}
                        for e in src.entries]}


def _load(src, position=None) -> dict:
    """An op log from a counter, a dict or the path of a saved one."""
    if isinstance(src, CostCounter):
        return op_log(src, position)
    if isinstance(src, (str, Path)):
        return json.loads(Path(src).read_text())
    return src


def _ranked(rows: list, top: int) -> list[dict]:
    out = [dict(r) for r in rows]
    out.sort(key=lambda r: -r["bytes"])
    return out[:top]


def collective_breakdown(src, top: int = 15, position=None) -> list[dict]:
    """Collectives ranked by operand bytes, per (op, shape, source)."""
    if isinstance(src, CostCounter) and not src.inspect:
        table = src.coll_rows if position is None else \
            src.position_bucket(position).coll_rows
        return _ranked(_rows(table), top)
    return _ranked(_load(src, position)["coll_rows"], top)


def top_bytes_ops(src, top: int = 20, position=None) -> list[dict]:
    """Every op and kernel call ranked by operand + output bytes, per (op,
    shape, source); a counter must have been made with
    ``inspect=True``."""
    if isinstance(src, CostCounter) and not src.inspect:
        raise ValueError("top_bytes_ops needs CostCounter(inspect=True)")
    return _ranked(_load(src, position)["rows"], top)


def top_bytes_report(src, top: int = 20, position=None) -> str:
    rows = top_bytes_ops(src, top, position)
    lines = [f"{'bytes/dev':>12} {'count':>7} {'op':22} shape <- source"]
    for r in rows:
        lines.append(f"{r['bytes']:12.3e} {r['count']:7.0f} {r['op']:22} "
                     f"{r['shape']} <- {r['source']}")
    return "\n".join(lines)


def dominant_ops_report(src, top: int = 15, position=None) -> str:
    rows = collective_breakdown(src, top, position)
    lines = [f"{'bytes/dev':>14} {'count':>8} {'op':18} shape/source"]
    for r in rows:
        lines.append(f"{r['bytes']:14.3e} {r['count']:8.0f} {r['op']:18} "
                     f"{r['shape']}  <- {r['source']}")
    return "\n".join(lines)
