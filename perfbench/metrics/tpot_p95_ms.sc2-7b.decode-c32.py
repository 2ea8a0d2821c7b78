"""Time per output token, 95th percentile over every request finished in
the traced window, (last token - first token) / (tokens - 1), ms. Kept
per layer where the host paces the cell."""
from perfbench.lib import readers


def read(rec):
    return readers.tail(rec, "tpot_p95_ms")
