"""Time to first token, 95th percentile over every request whose first
token came in the traced window, from its send on the client's clock,
ms. Kept per layer where the host paces the cell."""
from perfbench.lib import readers


def read(rec):
    return readers.tail(rec, "ttft_p95_ms")
