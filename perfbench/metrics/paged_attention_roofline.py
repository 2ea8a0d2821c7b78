"""Paged attention's share of its roofline in the window, in %."""
from perfbench.lib import readers


def read(rec):
    return readers.roofline(rec, "paged_attention")
