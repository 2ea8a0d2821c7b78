"""Median host time of a serving step (`ServeSession.step`), ms."""
from perfbench.lib import readers


def read(rec):
    return readers.median_step_ms(rec)
