"""Meshes for the port: named axes over a grid of torch devices, the
counterpart of ``repro/launch/mesh.py``.

A `Mesh` is axis names over a numpy array of ``torch.device``s. One
controller drives every position of it (`serve.sharding.ServePlan`): a
position is a shard, and several positions may name the same device.
So ``make_serve_mesh(2, 2, devices=["cuda:0"] * 4)`` lays a 2 x 2 plan
onto one card and ``devices=["cpu"] * 8`` carries any plan up to eight
shards on the CPU, as the reference's tests force eight host devices.
An `AbstractMesh` has axis sizes only: the partition rules and the dry
run's serve plans need no device.
"""
from __future__ import annotations

import numpy as np
import torch


class AbstractMesh:
    """Axis names and sizes, no devices."""

    def __init__(self, axis_sizes, axis_names):
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(axis_names)
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"axis sizes {self.axis_sizes} and names "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """Axis names over an array of torch devices (one per position)."""

    def __init__(self, devices: np.ndarray, axis_names):
        devices = np.asarray(devices, dtype=object)
        super().__init__(devices.shape, axis_names)
        self.devices = devices


def _devices(n: int, devices) -> list:
    if devices is None:
        have = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(have)]
        hint = "CUDA devices"
    else:
        have = len(devices)
        hint = "devices given"
    if n > have:
        raise ValueError(f"mesh needs {n} devices, have {have} {hint} "
                         f"(pass devices= to lay several shards on one "
                         f"device)")
    return [torch.device(d) for d in list(devices)[:n]]


def make_serve_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """2-D serving mesh over the first ``data * model`` devices: decode
    rows shard over "data", attention / MLP heads over "model" (the
    layout `serve.sharding.ServePlan` consumes). ``devices`` defaults to
    the CUDA devices; an explicit list may repeat one device. Raises
    `ValueError` when there are fewer devices than positions."""
    n = data * model
    devs = _devices(n, devices)
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(data, model), ("data", "model"))


def make_host_mesh(devices=None) -> Mesh:
    """Every CUDA device (or ``devices``) as a 1-D "data" mesh."""
    devs = _devices(len(devices) if devices is not None
                    else max(1, torch.cuda.device_count()), devices)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, ("data",))


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    """Deviceless mesh of the given axis sizes and names."""
    return AbstractMesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production layouts, deviceless: 16 x 16
    ("data", "model"), or 2 x 16 x 16 with a "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)
