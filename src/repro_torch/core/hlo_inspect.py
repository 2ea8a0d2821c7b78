"""Op and collective breakdown of a counted step — the port of the JAX
package's ``repro/core/hlo_inspect.py``.

The reference attributes trip-count-weighted bytes of compiled HLO
instructions to their shapes and source ops (``op_name`` metadata). The
port reads the same breakdown from a `CostCounter` that counted the step
with ``inspect=True``: bytes (operands + outputs, `bytes_accessed`'s
rule) per (op, output shape, source), each kernel call as op
``kernel:<name>`` with its ``work`` bytes. The source is the innermost
``torch.profiler.record_function`` range open at the op, else the
innermost function of the port on the Python stack (``models/
attention.py:attn_apply``); ops the autograd engine runs outside any
range and any port frame read "autograd".
"""
from __future__ import annotations

from repro_torch.core.hlo_cost import CostCounter


def _ranked(rows: dict, top: int) -> list[dict]:
    out = [{"op": k[0], "shape": k[1], "source": k[2], **v}
           for k, v in rows.items()]
    out.sort(key=lambda r: -r["bytes"])
    return out[:top]


def collective_breakdown(counter: CostCounter, top: int = 15) -> list[dict]:
    """Collectives ranked by operand bytes, per (op, shape, source)."""
    return _ranked(counter.coll_rows, top)


def top_bytes_ops(counter: CostCounter, top: int = 20) -> list[dict]:
    """Every op and kernel call ranked by operand + output bytes, per (op,
    shape, source); needs a counter made with ``inspect=True``."""
    if not counter.inspect:
        raise ValueError("top_bytes_ops needs CostCounter(inspect=True)")
    return _ranked(counter.rows, top)


def top_bytes_report(counter: CostCounter, top: int = 20) -> str:
    rows = top_bytes_ops(counter, top)
    lines = [f"{'bytes/dev':>12} {'count':>7} {'op':22} shape <- source"]
    for r in rows:
        lines.append(f"{r['bytes']:12.3e} {r['count']:7.0f} {r['op']:22} "
                     f"{r['shape']} <- {r['source']}")
    return "\n".join(lines)


def dominant_ops_report(counter: CostCounter, top: int = 15) -> str:
    rows = collective_breakdown(counter, top)
    lines = [f"{'bytes/dev':>14} {'count':>8} {'op':18} shape/source"]
    for r in rows:
        lines.append(f"{r['bytes']:14.3e} {r['count']:8.0f} {r['op']:18} "
                     f"{r['shape']}  <- {r['source']}")
    return "\n".join(lines)
