"""The SSD scan forward's share of its roofline in the window, in %."""
from perfbench.lib import readers


def read(rec):
    return readers.roofline(rec, "ssd_scan")
