"""Device operations launched inside each serving step."""
from perfbench.lib import readers


def read(rec):
    return readers.kernels_per(rec, "bench.step")
