"""Device operations per training step: every operation of the window
(the backward's are launched from autograd's threads) over the steps."""
from perfbench.lib import readers


def read(rec):
    return readers.kernels_per(rec, "bench.train_step", every_thread=True)
