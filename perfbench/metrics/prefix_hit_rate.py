"""`ServeSession.prefix_hit_rate` at the window's end: prompt pages
adopted from the radix cache over the pages that could be, in %."""
from perfbench.lib import readers


def read(rec):
    return readers.counter(rec, "prefix_hit_rate", 100.0)
