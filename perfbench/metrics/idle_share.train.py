"""Share of the traced window with no device operation running, in %."""
from perfbench.lib import readers


def read(rec):
    return readers.idle_share(rec)
