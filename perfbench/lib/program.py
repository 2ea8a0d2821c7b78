"""The benchmark's side of the program under test (``repro_torch``): its
configuration built from the configuration file, the ranges the
benchmark opens around the program's calls, and the device block of the
result line. Nothing here is timed code of the program.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.profiler import record_function

from perfbench.lib import work


def model_config(c: dict):
    """The program's `ModelConfig` for a configuration file: the
    registered architecture with every size the file states, in the
    file's dtype."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    sizes = {k: v for k, v in c.items() if k in fields and k != "name"}
    return get_config(c["arch"], **sizes, param_dtype=c["dtype"],
                      compute_dtype=c["dtype"])


class KernelCalls:
    """Wraps ``repro_torch.kernels.api.run`` for a traced window: every
    kernel call runs inside a ``bench.kernel.<name>`` range, and the
    calls of the kernels in ``work_of`` keep the arguments their least
    work is computed from (``{name: [(flops, bytes)]}`` in `calls`). The
    lengths a call reads lie on the card: they are copied to the host
    once the window has closed, inside a ``bench.probe`` range that the
    readers leave out."""

    def __init__(self, work_of: dict):
        from repro_torch.kernels import api
        self.api = api
        self.work_of = work_of
        self.pending: dict = {name: [] for name in work_of}
        self.on = False
        self._run = api.run

    def __enter__(self):
        run = self._run

        def traced(name, *args, **kwargs):
            if not self.on:
                return run(name, *args, **kwargs)
            if name in self.pending:
                with record_function("bench.probe"):
                    self.pending[name].append(self.work_of[name](*args))
            with record_function(f"bench.kernel.{name}"):
                return run(name, *args, **kwargs)

        self.api.run = traced
        return self

    def __exit__(self, *exc):
        self.api.run = self._run

    def calls(self) -> dict:
        return {name: [f() for f in fs] for name, fs in self.pending.items()}


def paged_attention_args(q, k_pages, v_pages, k_quant, v_quant, k_scale,
                         v_scale, page_table, lengths, layer=None):
    """A deferred `work.paged_attention_work` of one call: the lengths
    are copied on the device now and read on the host later."""
    k_rows = q.shape[1] if q.ndim == 4 else 1
    lengths = lengths.clone()
    q_meta = torch.empty(q.shape, dtype=q.dtype, device="meta")
    pool_meta = torch.empty(k_pages.shape, dtype=k_pages.dtype,
                            device="meta")
    return lambda: work.paged_attention_work(
        q_meta, pool_meta, lengths.tolist(), k_rows)


def ssd_scan_args(x, b_mat, c_mat, dt, a, **_):
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (x, b_mat, c_mat, dt)]
    return lambda: work.ssd_scan_work(*meta)


@contextlib.contextmanager
def span(name: str, on: bool):
    if on:
        with record_function(name):
            yield
    else:
        yield


def device_block(device: str, count: int = 1) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count,
                "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def sync(device: str):
    if device == "cuda":
        torch.cuda.synchronize()
