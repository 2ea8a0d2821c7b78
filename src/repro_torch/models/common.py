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

from repro_torch.kernels import count as _count


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


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _inorder_sum(parts: list) -> list:
    """Parts summed in order on the first part's device, one result per
    part on its device."""
    out = parts[0]
    for t in parts[1:]:
        out = out + t.to(out.device)
    return [out if p.device == out.device else out.to(p.device)
            for p in parts]


def _distinct(outs: list) -> list:
    """`outs` with no tensor object twice: each entry of a seam is its own
    position's tensor."""
    seen, res = set(), []
    for o in outs:
        if id(o) in seen:
            o = o.clone()
        seen.add(id(o))
        res.append(o)
    return res


class Seam:
    """The cross-shard operations of a plan's per-shard bodies (the
    mixers, the MLP, the layer): entry j of a body's per-shard lists is
    model shard ``indices[j]`` of ``size``, at mesh position
    ``positions[j]``. A call sums the entries' parts (the tensor-parallel
    all-reduce); `gather` concatenates them along a dimension (all-gather);
    `combine` merges partial softmax attention by log-sum-exp; `local`
    is the identity over the same entries, for a sublayer every shard
    runs whole (its head count does not divide over the model axis).

    ``reduce`` sums a list of parts (the plan's: an in-order sum on one
    device, NCCL over distinct cards; default in order). A body with
    ``size`` 1 is the unsharded model. ``seq`` > 1 is sequence
    parallelism over the model axis: between sublayers each entry holds
    positions ``[indices[j] S / seq, (indices[j] + 1) S / seq)``;
    `gather_seq` (an all-gather) gives each sublayer the whole sequence
    and `out`, a sublayer's last reduction, becomes a reduce-scatter
    (a whole sublayer's `local` seam takes its own positions). Under a cost counter each seam
    hides its own arithmetic, records the collective per position, and is
    an autograd Function whose backward sums the gradients the same way
    and records that too. ``stand_in`` (a one-position count on
    ``meta``, `train.sharding.TrainPlan`): the entries cover only the
    counted positions, and each result is a ``meta`` tensor of its shape
    that stands in for what the other positions would add."""

    def __init__(self, size: int = 1, indices=None, positions=None,
                 reduce=None, stand_in: bool = False, seq: int = 1,
                 seq_indices=None):
        self.size = int(size)
        self.indices = list(range(self.size)) if indices is None \
            else list(indices)
        self.positions = list(positions) if positions is not None \
            else [None] * len(self.indices)
        self._reduce = reduce or _inorder_sum
        self.stand_in = stand_in
        self.seq = int(seq)
        self.seq_indices = list(self.indices) if seq_indices is None \
            else list(seq_indices)
        self.last: dict = {}        # entry -> its last sum (count roots)

    def __repr__(self):
        return f"Seam(size={self.size}, indices={self.indices})"

    def local(self) -> "Seam":
        """The identity over the same entries (each a whole block, index
        0): a sublayer every shard runs whole."""
        return Seam(1, [0] * len(self.indices), self.positions,
                    stand_in=self.stand_in, seq=self.seq,
                    seq_indices=self.seq_indices)

    def _seq_slice(self, t, j: int):
        n = t.shape[1] // self.seq
        return t.narrow(1, self.seq_indices[j] * n, n)

    def out(self, parts) -> list:
        """A sublayer's last reduction: the sum (`__call__`), or under
        sequence parallelism each entry's positions of it (a
        reduce-scatter; a whole sublayer's own positions)."""
        parts = list(parts)
        if self.seq == 1:
            return self(parts)
        if self.size == 1:
            return [self._seq_slice(p, j) for j, p in enumerate(parts)]
        if _count.active() is None:
            return self._scatter(parts)
        outs = list(_ReduceScatter.apply(self, *parts))
        self.last.update(enumerate(outs))
        return outs

    def _scatter(self, parts: list) -> list:
        if self.stand_in:
            return [torch.empty_like(self._seq_slice(p, j))
                    for j, p in enumerate(parts)]
        return [self._seq_slice(t, j)
                for j, t in enumerate(self._reduce(list(parts)))]

    def gather_seq(self, parts) -> list:
        """Under sequence parallelism, each entry's positions gathered
        into the whole sequence on every entry (an all-gather,
        differentiable: its backward a reduce-scatter); else `parts`."""
        parts = list(parts)
        if self.seq == 1:
            return parts
        if _count.active() is None:
            return self._gather_seq(parts)
        outs = list(_SeqGather.apply(self, *parts))
        self.last.update(enumerate(outs))
        return outs

    def _gather_seq(self, parts: list) -> list:
        if self.stand_in:
            shape = list(parts[0].shape)
            shape[1] *= self.seq
            return [torch.empty(shape, dtype=p.dtype, device=p.device)
                    for p in parts]
        full = torch.cat([p.to(parts[0].device) for p in parts], dim=1)
        return [full.to(p.device) for p in parts]

    def _sum(self, parts: list) -> list:
        if self.stand_in:
            return [torch.empty_like(p) for p in parts]
        return self._reduce(list(parts))

    def __call__(self, parts) -> list:
        parts = list(parts)
        if self.size == 1:
            return parts
        if _count.active() is None:
            return list(self._sum(parts))
        outs = list(_SeamSum.apply(self, *parts))
        self.last.update(enumerate(outs))
        return outs

    def _record(self, kind: str, tensors: list, outs: list) -> list:
        for pos, t, o in zip(self.positions, tensors, outs):
            if isinstance(t, int):
                _count.collective(kind, t, pos)
            else:
                _count.collective(kind, _nbytes(t), pos, t.shape)
            _count.tag(o, pos)
        return outs

    def broadcast(self, x, devices: list) -> list:
        """`x` (on the row's model shard 0) to every entry's device: one
        tensor per entry (a broadcast from shard 0 to the others)."""
        if _count.active() is None:
            return [x.to(dev) for dev in devices]
        return list(_Broadcast.apply(self, devices, x))

    def gather(self, parts: list, dim: int) -> list:
        """The entries' parts concatenated along `dim` in shard order, on
        every entry (an all-gather). Not differentiable: decode only."""
        if self.size == 1:
            return list(parts)
        with _count.hidden():
            if self.stand_in:
                shape = list(parts[0].shape)
                shape[dim] *= self.size
                outs = [torch.empty(shape, dtype=p.dtype, device=p.device)
                        for p in parts]
            else:
                full = torch.cat([p.to(parts[0].device) for p in parts],
                                 dim=dim)
                outs = _distinct([full.to(p.device) for p in parts])
        return self._record("all-gather", parts, outs)

    def combine(self, ms: list, ls: list, accs: list) -> list:
        """Softmax attention over positions split across the entries:
        each entry's running max ``m``, normaliser ``l`` and unnormalised
        output ``acc`` (``m`` and ``l`` broadcastable against ``acc``)
        merge into ``acc / l`` over every position, on every entry (one
        all-reduce of the three)."""
        if self.size == 1:
            return [a / torch.clamp(l, min=1e-30) for l, a in zip(ls, accs)]
        with _count.hidden():
            if self.stand_in:
                outs = [torch.empty_like(a) for a in accs]
            else:
                dev = accs[0].device
                m_all = ms[0]
                for m in ms[1:]:
                    m_all = torch.maximum(m_all, m.to(dev))
                acc, l = 0.0, 0.0
                for m, li, a in zip(ms, ls, accs):
                    w = torch.exp(m.to(dev) - m_all)
                    acc = acc + a.to(dev) * w
                    l = l + li.to(dev) * w
                out = acc / torch.clamp(l, min=1e-30)
                outs = _distinct([out.to(a.device) for a in accs])
        sizes = [_nbytes(m) + _nbytes(l) + _nbytes(a)
                 for m, l, a in zip(ms, ls, accs)]
        return self._record("all-reduce", sizes, outs)


class _SeamSum(torch.autograd.Function):
    """`Seam.__call__` under a counter: the sum hidden, one all-reduce per
    entry forward and one backward."""

    @staticmethod
    def forward(ctx, seam, *parts):
        ctx.seam = seam
        ctx.like = [(p.shape, p.dtype, p.device) for p in parts]
        ctx.set_materialize_grads(False)
        with _count.hidden():
            outs = _distinct([o if o is not p else o.view_as(o)
                              for o, p in zip(seam._sum(list(parts)),
                                              parts)])
        return tuple(seam._record("all-reduce", list(parts), outs))

    @staticmethod
    def backward(ctx, *grads):
        seam = ctx.seam
        with _count.hidden():
            gs = [g if g is not None else
                  torch.zeros(s, dtype=dt, device=dv)
                  for g, (s, dt, dv) in zip(grads, ctx.like)]
            outs = _distinct(seam._sum(gs))
        return (None,) + tuple(seam._record("all-reduce", gs, outs))


class _ReduceScatter(torch.autograd.Function):
    """`Seam.out` under sequence parallelism and a counter: the sum and
    the cut hidden, one reduce-scatter per entry forward; the backward
    gathers the entries' gradients (one all-gather)."""

    @staticmethod
    def forward(ctx, seam, *parts):
        ctx.seam = seam
        ctx.set_materialize_grads(False)
        ctx.like = [(p.shape, p.dtype, p.device) for p in parts]
        with _count.hidden():
            outs = _distinct([o.clone() if o._base is not None else o
                              for o in seam._scatter(list(parts))])
        return tuple(seam._record("reduce-scatter", list(parts), outs))

    @staticmethod
    def backward(ctx, *grads):
        seam = ctx.seam
        with _count.hidden():
            gs = [g if g is not None else
                  torch.zeros(seam._seq_slice(torch.empty(s, device="meta"),
                                              j).shape, dtype=dt, device=dv)
                  for j, (g, (s, dt, dv)) in enumerate(zip(grads, ctx.like))]
            outs = _distinct(seam._gather_seq(gs))
        return (None,) + tuple(seam._record("all-gather", gs, outs))


class _SeqGather(torch.autograd.Function):
    """`Seam.gather_seq` under a counter: the concatenation hidden, one
    all-gather per entry forward; the backward sums the entries'
    gradients and cuts each its positions (one reduce-scatter)."""

    @staticmethod
    def forward(ctx, seam, *parts):
        ctx.seam = seam
        ctx.set_materialize_grads(False)
        ctx.like = [(p.shape, p.dtype, p.device) for p in parts]
        with _count.hidden():
            outs = _distinct(seam._gather_seq(list(parts)))
        return tuple(seam._record("all-gather", list(parts), outs))

    @staticmethod
    def backward(ctx, *grads):
        seam = ctx.seam
        with _count.hidden():
            full = []
            for j, (g, (s, dt, dv)) in enumerate(zip(grads, ctx.like)):
                shape = list(s)
                shape[1] *= seam.seq
                full.append(g if g is not None else
                            torch.zeros(shape, dtype=dt, device=dv))
            outs = _distinct([o.clone() if o._base is not None else o
                              for o in seam._scatter(full)])
        return (None,) + tuple(seam._record("reduce-scatter", full, outs))


class _Broadcast(torch.autograd.Function):
    """`Seam.broadcast` under a counter: one tensor per entry, each its
    position's; the backward sums the entries' gradients."""

    @staticmethod
    def forward(ctx, seam, devices, x):
        ctx.seam = seam
        ctx.like = (x.shape, x.dtype, x.device)
        ctx.set_materialize_grads(False)
        with _count.hidden():
            outs = _distinct([x.to(dev).view_as(x) for dev in devices])
        return tuple(seam._record("collective-broadcast",
                                  [x] * len(outs), outs))

    @staticmethod
    def backward(ctx, *grads):
        s, dt, dv = ctx.like
        with _count.hidden():
            gs = [g for g in grads if g is not None]
            if not gs or ctx.seam.stand_in:
                g = torch.zeros(s, dtype=dt, device=dv)
            else:
                g = gs[0].to(dv)
                for x in gs[1:]:
                    g = g + x.to(dv)
        _count.tag(g, ctx.seam.positions[0] if ctx.seam.indices[0] == 0
                   else None)
        return None, None, g


def as_seam(psum, n: int) -> Seam:
    """`psum` as a `Seam` over `n` entries: a `Seam` as it is; any other
    callable (a list of parts -> a list of sums) as the sum of one."""
    if isinstance(psum, Seam):
        return psum
    return Seam(n, reduce=lambda parts: list(psum(parts))) if n > 1 \
        else Seam(1)


# The tensor-parallel reduction seam over a single model shard: the
# identity. The mixers' and the MLP's bodies take one entry per model
# shard and a seam (`Seam`); the unsharded model is their one-shard case.
psum_one = Seam(1)


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
