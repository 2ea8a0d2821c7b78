"""Model FLOPs of the window over the card's bf16 peak, in %."""
from perfbench.lib import readers


def read(rec):
    return readers.mfu(rec)
