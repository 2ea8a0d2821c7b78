"""Parameter specs and their random init.

A module describes its parameters as a nested dict of ``ParamSpec``
leaves; the same tree gives the shapes, the dtypes, the logical axis
names that `repro_torch.sharding.partition` maps onto a mesh, and the
seeded random init, so they cannot drift apart. The init rules are those
of the JAX package's ``repro/models/common.py`` (fan_in, zeros, ones,
normal, and the mamba2 ``alog`` and RG-LRU ``lambda`` draws), drawn from
an explicit ``torch.Generator`` on the target device so that a full-width
model is initialised on the card, never on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    init: str = "normal"    # normal | zeros | ones | fan_in | alog | lambda
    scale: float = 0.02
    dtype: Optional[str] = None    # override model param dtype (e.g. fp32 norms)
    # logical axis name per dim (None = replicated), as the reference's
    logical: tuple = ()

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def psum_one(parts: list) -> list:
    """The tensor-parallel reduction seam over a single model shard: the
    identity. The mixers' and the MLP's bodies take one entry per model
    shard and a ``psum`` (`serve.sharding.ServePlan.psum` under a mesh
    plan); the unsharded model is their one-shard case."""
    return parts


def stack_specs(tree, n: int):
    """Prepend a leading layer-stack dim of size n (logical axis
    "layers") to every spec in the tree (the reference's scan layout)."""
    if isinstance(tree, ParamSpec):
        return dataclasses.replace(tree, shape=(n,) + tuple(tree.shape),
                                   logical=("layers",) + tuple(tree.logical))
    return {k: stack_specs(v, n) for k, v in tree.items()}


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> ``{"a.b.c": leaf}`` in sorted key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten(flat: dict) -> dict:
    """``{"a.b.c": leaf}`` -> nested dict (inverse of `flatten`)."""
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_leaf(ps: ParamSpec, generator: torch.Generator, device,
              default_dtype: str) -> torch.Tensor:
    dtype = torch_dtype(ps.dtype or default_dtype)
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dtype, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dtype, device=device)
    if ps.init == "fan_in":
        # the reference counts every leading dim, the layer stack included
        fan_in = ps.shape[0] if len(ps.shape) == 1 else math.prod(ps.shape[:-1])
        std = 1.0 / math.sqrt(max(fan_in, 1))
    elif ps.init == "normal":
        std = ps.scale
    elif ps.init in ("alog", "lambda"):
        lo, hi = (1.0, 16.0) if ps.init == "alog" else (0.9, 0.999)
        u = torch.rand(ps.shape, generator=generator, device=device) \
            * (hi - lo) + lo
        # alog: mamba2's A_log = log(uniform[1, 16]); lambda: RG-LRU's
        # Lambda with a = sigmoid(Lambda) uniform in [0.9, 0.999]
        out = torch.log(u) if ps.init == "alog" else torch.log(u / (1 - u))
        return out.to(dtype)
    else:
        raise NotImplementedError(f"init {ps.init!r} is not ported")
    out = torch.empty(ps.shape, dtype=dtype, device=device)
    # draw a stacked leaf one layer at a time: the fp32 draw of a whole
    # (n_layers, d, d_ff) stack would need several times the leaf's bytes
    for part in (out if out.ndim >= 3 else (out,)):
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=device).mul_(std))
    return out


def materialize(spec_tree, generator: torch.Generator, device,
                default_dtype: str) -> dict:
    """Flat ``{name: tensor}`` of seeded random params for a spec tree."""
    return {name: init_leaf(ps, generator, device, default_dtype)
            for name, ps in flatten(spec_tree).items()}
