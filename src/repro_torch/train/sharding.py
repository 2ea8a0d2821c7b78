"""Training across devices: the FSDP x TP plan of a mesh, the port's
stand-in for what XLA's partitioner does to the reference's sharded
train step (``repro/train/train_step.py`` under ``Trainer(mesh=)``).

One controller holds every shard's tensors and launches each shard's
work in turn, as serving does (`serve.sharding`); a shard is a mesh
position, several positions may share a device. The mesh changes where
tensors live, not what the step computes: the numbers are the
single-device step's (the reference's GSPMD result).

- **Storage.** Every parameter, its fp32 master, m and v (and the
  compressor's residual) are held per shard as the slice
  `sharding.partition.DEFAULT_RULES` gives it: FSDP over ``data``
  through the ``embed`` axis, TP over ``model``. A leaf the rules
  replicate over an axis has one copy per shard of that axis; after the
  backward the copies' gradients are summed, so they apply one identical
  update. At full width a shard holds `ft.elastic.plan_rescale`'s
  ``bytes_per_device``.
- **Compute.** Data shard d takes rows ``[d b/dp, (d+1) b/dp)`` of the
  global batch (of each microbatch, which takes its global rows first,
  as the reference's ``slice_mb``). Its model shards run the serving
  plan's per-shard bodies in ``mode="train"`` (`models.transformer.
  train_stack_tp`) on weights laid out as `serve.sharding.ServePlan`
  lays them (`SERVE_RULES`: heads, kv heads, ffn, SSD heads and the
  RG-LRU width over ``model``, the rest whole); the embedding, final
  norm and LM head run on model shard 0, whose activations go to the
  other shards of the row.
- **The gather** from storage to compute (the FSDP all-gather) is a
  ``torch.cat`` of ``.to(device)`` storage slices inside the autograd
  graph and inside each layer group's remat segment: its backward is the
  reduce-scatter, and a weight several data shards read sums their
  gradients.
- **The seam** (`TrainPlan.psum`): on one device the serving plan's
  in-order sum, which autograd differentiates; over distinct cards an
  NCCL all-reduce inside `AllReduceSum`, whose backward all-reduces the
  gradient.
- **The loss** is the mean of the data shards' means (equal rows); the
  MoE load-balancing loss, a product of two batch means, takes the
  means over the data shards first (`moe.balance_loss`).
- **The norm** that clips counts each logical leaf once: one copy of
  each distinct slice; each position sums the squares of the slices it
  holds the counted copy of, and one all-reduce of the partial sums
  gives every position the norm.
- **Layouts the model axis does not divide** (GSPMD's replication): a
  sublayer whose heads (or SSD heads, RG-LRU width, d_ff) the axis does
  not divide runs whole on every model shard with no seam
  (`ServePlan.compute_specs`); kv heads it does not divide under q heads
  it does are read by each shard as its q block maps them
  (`attention.select_kv`); MLA's latents are whole on every shard, its
  heads split. Each copy of a replicated compute weight takes only its
  own shard's gradient, and the replica sum adds them: the logical
  gradient, counted once.
- **Sequence parallelism** (the ``seq`` rule over ``model``, the
  ``seq_parallel`` variants): between sublayers each model shard holds
  its block of positions; each sublayer gathers its normed input over
  the positions (all-gather) and scatters its output (reduce-scatter,
  `models.common.Seam`), the head gathers the last one. The numbers stay
  the plan's: the same sums, cut by position.
- **Counting** (`core.hlo_cost.CostCounter`): every seam records the
  collective it stands for — the TP sums (all-reduce, forward and
  backward), the FSDP gathers (all-gather; reduce-scatter backward), the
  replica sums, the loss and MoE-statistics means over the data shards
  and the norm (all-reduce) — and marks each position's tensors, so the
  counter keeps a count per position. A plan built with
  ``count_positions`` on ``meta`` runs only those positions' work: the
  seams' results and the other positions' storage slices are ``meta``
  stand-ins of their shapes, and the backward starts where the
  position's work leaves it (`plan_grads`). The dry run
  (`launch.dryrun`) counts a 16 x 16 pod's step this way.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import torch

from repro_torch.kernels import count
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (Seam, flatten, init_leaf, torch_dtype,
                                       unflatten)
from repro_torch.models.transformer import (Model, check_state,
                                            model_logical, model_spec,
                                            run_stack_tp, train_stack_tp)
from repro_torch.serve.sharding import ServePlan, all_reduced, reduce_tensors
from repro_torch.sharding.partition import (DEFAULT_RULES, mesh_axis_sizes,
                                            spec_for)
from repro_torch.train.optimizer import init_opt_state

PLAN_AXES = ("pod", "data", "model")
OPT_LEAVES = ("m", "v", "master")


class AllReduceSum(torch.autograd.Function):
    """The seam over model shards on distinct cards: every output is the
    sum of the parts (an NCCL all-reduce), and so is every part's
    gradient: the sum of the outputs' gradients."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.like = [(p.shape, p.dtype, p.device) for p in parts]
        return tuple(all_reduced(parts))

    @staticmethod
    def backward(ctx, *grads):
        return tuple(all_reduced([
            g if g is not None else torch.zeros(s, dtype=dt, device=dv)
            for g, (s, dt, dv) in zip(grads, ctx.like)]))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _block_shape(index: tuple, shape) -> tuple:
    return tuple(len(range(*sl.indices(n))) for sl, n in zip(index, shape))


class _Gather(torch.autograd.Function):
    """`TrainPlan.gather` under a counter: the FSDP gather's arithmetic
    hidden, one all-gather recorded forward and one reduce-scatter
    backward when the compute slice spans other positions' storage. The
    backward adds each storage block's gradient into the plan's buffer
    (`TrainPlan.grad_buffer`) and returns none to autograd: the sums over
    the positions that read a block are the reduce-scatter's, not ops of
    any one position."""

    @staticmethod
    def forward(ctx, plan, name, d, m, g, keys, *tensors):
        ctx.plan, ctx.name, ctx.pos, ctx.g, ctx.keys = plan, name, (d, m), \
            g, keys
        ctx.save_for_backward(*[t for t in tensors if t is not None])
        ctx.present = [t is not None for t in tensors]
        with count.hidden():
            if plan.device(d, m).type == "meta":
                # shapes only: the concatenation's result, uncomputed
                out = torch.empty(plan.compute_shape(name, m, g),
                                  dtype=plan.dtypes[name], device="meta")
            else:
                out = plan._build(name, d, m, g, dict(zip(keys, tensors)))
            if any(out is t for t in tensors):
                out = out.view_as(out)
        ctx.spans = any(k != (d, m) for k in keys)
        if ctx.spans:
            count.collective("all-gather", plan.slice_bytes(name, d, m, g),
                             (d, m))
        count.tag(out, (d, m))
        return out

    @staticmethod
    def backward(ctx, grad):
        plan, name, g = ctx.plan, ctx.name, ctx.g
        saved = iter(ctx.saved_tensors)
        tensors = [next(saved) if p else None for p in ctx.present]
        if ctx.spans:
            count.collective("reduce-scatter", _nbytes(grad), ctx.pos,
                             grad.shape)
        buf = plan.grad_buffer
        want = [(k, t) for k, t in zip(ctx.keys, tensors)
                if t is not None and buf is not None and k in buf]
        if want and grad.device.type == "meta":
            with count.hidden():
                for k, t in want:
                    if buf[k].get(name) is None:
                        buf[k][name] = torch.empty_like(t)
        elif want:
            with count.hidden(), torch.enable_grad():
                leaves = {k: (t if g is None else t[g]).detach()
                          .requires_grad_() for k, t in want}
                full = {k: (t if g is None or t is None else t[g])
                        for k, t in zip(ctx.keys, tensors)}
                # stand-ins are whole storage slices: cut them to group g
                if g is not None:
                    for k in full:
                        if full[k] is None:
                            full[k] = torch.empty(
                                plan.slice_shape(name, *k)[1:],
                                dtype=plan.dtypes[name], device="meta")
                full.update(leaves)
                out = plan._build(name, *ctx.pos, g, full, sliced=True)
                gs = torch.autograd.grad(out, list(leaves.values()), grad,
                                         allow_unused=True)
                for (k, t), gk in zip(want, gs):
                    if gk is None:
                        continue
                    have = buf[k].get(name)
                    if have is None:
                        have = buf[k][name] = torch.zeros_like(t)
                    (have if g is None else have[g]).add_(gk)
        return (None,) * (6 + len(tensors))


class _RowWeights:
    """The embedding, final norm and LM head gathered onto a row's model
    shard 0: `Model`'s prologue and head over them."""

    inputs = Model.inputs
    embed_in = Model.embed_in
    head = Model.head

    def __init__(self, cfg, params: dict):
        self.cfg = cfg
        self.params = params


class TrainPlan:
    """The FSDP x TP layout of a ("data", "model") mesh (or ("pod",
    "data", "model"): the data shards then run over pod x data) for one
    config; see the module docstring. Construct through `from_mesh`,
    which returns None for a mesh of one position (the unsharded
    trainer). ``rules`` lay out the storage (default `DEFAULT_RULES`; a
    variant's, `launch.variants`). ``count_positions`` (a mesh without
    devices: ``meta``) runs only those positions' work, for counting."""

    def __init__(self, mesh, cfg, rules: Optional[dict] = None,
                 count_positions=None):
        extra = set(mesh.axis_names) - set(PLAN_AXES)
        if extra:
            raise ValueError(f"a training plan lays shards over "
                             f"{PLAN_AXES}, not {sorted(extra)}")
        self.check(cfg, mesh)
        self.serve = ServePlan(mesh)
        self.mesh = mesh
        self.cfg = cfg
        self.sizes = mesh_axis_sizes(mesh)
        self.data_size = self.sizes.get("data", 1)
        self.dp = self.sizes.get("pod", 1) * self.data_size
        self.tp = self.sizes.get("model", 1)
        self.rules = rules or DEFAULT_RULES
        seq = [tuple(c) for c in self.rules.get("seq", [])]
        if seq not in ([], [("model",)]):
            raise NotImplementedError(
                f"the seq rule {seq}: the plan splits positions over the "
                f"model axis only")
        # sequence parallelism (the seq rule over "model"): activations
        # between sublayers split by position over the model shards
        self.seq_parallel = bool(seq) and self.sizes.get("model", 1) > 1
        self.all_shards = [(d, m) for d in range(self.dp)
                           for m in range(self.tp)]
        self.stand_in = count_positions is not None
        if self.stand_in:
            if self.serve.devices is not None:
                raise ValueError("count_positions counts on meta: give an "
                                 "abstract mesh")
            self.shards = sorted({tuple(p) for p in count_positions})
            bad = [p for p in self.shards if p not in self.all_shards]
            if bad:
                raise ValueError(f"positions {bad} are not on {self}")
        else:
            self.shards = list(self.all_shards)
        self.shard_set = set(self.shards)
        self.grad_buffer = None
        self._plan_cache: dict = {}
        logical = model_logical(cfg)
        spec = flatten(model_spec(cfg))
        self.shapes = {n: tuple(ps.shape) for n, ps in spec.items()}
        self.dtypes = {n: torch_dtype(ps.dtype or cfg.param_dtype)
                       for n, ps in spec.items()}
        self.specs = {n: spec_for(self.shapes[n], logical[n], mesh,
                                  self.rules) for n in spec}
        self.compute_specs = self.serve.compute_specs(cfg)
        # the storage shards holding each distinct slice of a leaf: the
        # first of each group is the copy the norm counts
        self.replicas = {}
        for n in spec:
            groups: dict = {}
            for d, m in self.all_shards:
                key = tuple((s.start, s.stop) for s in self.index(n, d, m))
                groups.setdefault(key, []).append((d, m))
            self.replicas[n] = list(groups.values())

    @staticmethod
    def check(cfg, mesh):
        """Raise `ValueError` for a mesh the plan cannot lay out: axes
        other than `PLAN_AXES`. Every config lays out on every such mesh,
        as GSPMD lays out the reference's: what the model axis does not
        divide replicates (see the module docstring)."""
        extra = set(mesh.axis_names) - set(PLAN_AXES)
        if extra:
            raise ValueError(f"a training plan lays shards over "
                             f"{PLAN_AXES}, not {sorted(extra)}")

    @staticmethod
    def from_mesh(mesh, cfg, rules: Optional[dict] = None) \
            -> Optional["TrainPlan"]:
        """None (or a mesh of one position) -> None."""
        if mesh is None or math.prod(mesh.axis_sizes) == 1:
            return None
        return TrainPlan(mesh, cfg, rules)

    def __repr__(self):
        return f"TrainPlan(dp={self.dp}, tp={self.tp})"

    def device(self, d: int = 0, m: int = 0) -> torch.device:
        if self.serve.devices is None:
            return torch.device("meta")
        return self.serve.device(d, m)

    def runs(self, d: int, m: int) -> bool:
        """True when this plan runs position (d, m)'s work."""
        return (d, m) in self.shard_set

    def row(self, d: int) -> list:
        """The model shards of data shard d this plan runs."""
        return [m for m in range(self.tp) if (d, m) in self.shard_set]

    def rows(self) -> list:
        """The data shards this plan runs."""
        return sorted({d for d, _ in self.shards})

    def seam(self, d: int, seq_len: int = 0) -> Seam:
        """Data shard d's model-axis `Seam` over the model shards run;
        under sequence parallelism, for a `seq_len` the model axis
        divides, over positions too."""
        ms = self.row(d)
        sp = self.tp if self.seq_parallel and seq_len % self.tp == 0 \
            and seq_len >= self.tp else 1
        return Seam(self.tp, indices=ms, positions=[(d, m) for m in ms],
                    reduce=self.psum, stand_in=self.stand_in, seq=sp)

    def data_seam(self, ds: list) -> Seam:
        """The `Seam` over the data shards `ds` (each on its model shard
        0): the loss and MoE-statistics sums."""
        return Seam(self.dp, indices=ds, positions=[(d, 0) for d in ds],
                    stand_in=self.stand_in)

    # -- layout ---------------------------------------------------------------
    def _coords(self, d: int, m: int) -> dict:
        return {"pod": d // self.data_size, "data": d % self.data_size,
                "model": m}

    def index(self, name: str, d: int, m: int) -> tuple:
        """Slices of leaf `name` that shard (d, m) stores."""
        coords = self._coords(d, m)
        out = []
        for i, n in enumerate(self.shapes[name]):
            entry = self.specs[name][i] if i < len(self.specs[name]) \
                else None
            if entry is None:
                out.append(slice(None))
                continue
            idx, size = 0, 1
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                idx = idx * self.sizes[ax] + coords[ax]
                size *= self.sizes[ax]
            step = n // size
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def slice_shape(self, name: str, d: int, m: int) -> tuple:
        return _block_shape(self.index(name, d, m), self.shapes[name])

    def slice_bytes(self, name: str, d: int, m: int, g=None) -> int:
        """Bytes of shard (d, m)'s storage slice of `name` (of layer group
        `g` of a stacked leaf)."""
        shape = self.slice_shape(name, d, m)
        n = math.prod(shape[1:] if g is not None else shape)
        return n * torch.empty((), dtype=self.dtypes[name]).element_size()

    def _holder(self, name: str, blocks: tuple, d: int, m: int) -> tuple:
        """The storage shard holding the block of per-dimension indices
        `blocks`, taking (d, m)'s coordinate on every axis the leaf's
        storage does not split (its own copy of a replicated slice)."""
        coords = self._coords(d, m)
        for entry, j in zip(self.specs[name], blocks):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            for ax in reversed(axes):
                coords[ax] = j % self.sizes[ax]
                j //= self.sizes[ax]
        return (coords["pod"] * self.data_size + coords["data"],
                coords["model"])

    def _gather_plan(self, name: str, d: int, m: int, g=None):
        """(per-dimension block ranges, the cut of their concatenation,
        the leading dimensions the group index takes) of compute shard
        (d, m)'s slice of `name`."""
        key = (name, m, g is None)
        if key not in self._plan_cache:
            self._plan_cache[key] = self._make_gather_plan(name, m, g)
        return self._plan_cache[key]

    def _make_gather_plan(self, name: str, m: int, g):
        shape = self.shapes[name]
        spec = self.specs[name]
        want = self.serve.local_index(shape, self.compute_specs[name], 0, m)
        lead = 0 if g is None else 1
        ranges, cuts = [], []
        for i in range(lead, len(shape)):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else \
                (entry if isinstance(entry, tuple) else (entry,))
            step = shape[i] // math.prod(self.sizes[ax] for ax in axes)
            lo, hi, _ = want[i].indices(shape[i])
            first = lo // step
            ranges.append(range(first, -(-hi // step)))
            cuts.append(slice(lo - first * step, hi - first * step))
        return ranges, cuts, lead

    def _keys(self, name: str, d: int, m: int, g=None) -> list:
        """The storage shards compute shard (d, m) reads `name` from, in
        order, each once."""
        key = (name, d, m, g is None)
        if key in self._plan_cache:
            return self._plan_cache[key]
        ranges, _, lead = self._gather_plan(name, d, m, g)
        keys = []
        for blocks in itertools.product(*ranges):
            k = self._holder(name, (0,) * lead + blocks, d, m)
            if k not in keys:
                keys.append(k)
        self._plan_cache[key] = keys
        return keys

    def compute_shape(self, name: str, m: int, g=None) -> tuple:
        """The shape of compute shard m's slice of `name` (of one layer
        group with `g`)."""
        shape = self.shapes[name]
        want = self.serve.local_index(shape, self.compute_specs[name], 0, m)
        out = _block_shape(want, shape)
        return out[1:] if g is not None else out

    def _build(self, name: str, d: int, m: int, g, fetch: dict,
               sliced: bool = False):
        """Compute shard (d, m)'s slice of `name` (of layer group `g`)
        from the storage slices `fetch[(hd, hm)]` (None: a ``meta``
        stand-in of its shape; ``sliced``: already group g's)."""
        ranges, cuts, lead = self._gather_plan(name, d, m, g)
        dev = self.device(d, m)

        def block(k):
            t = fetch.get(k)
            if t is None:
                t = torch.empty(self.slice_shape(name, *k),
                                dtype=self.dtypes[name], device="meta")
            elif sliced:
                return t.to(dev)
            return (t if g is None else t[g]).to(dev)

        def build(i: int, blocks: tuple):
            if i == len(ranges):
                return block(self._holder(name, (0,) * lead + blocks, d, m))
            parts = [build(i + 1, blocks + (j,)) for j in ranges[i]]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=i)

        out = build(0, ())
        if any(c != slice(0, n) for c, n in zip(cuts, out.shape)):
            out = out[tuple(cuts)]
        return out

    def gather(self, store: list, name: str, d: int, m: int, g=None):
        """Compute shard (d, m)'s weight `name` (of layer group `g` of a
        stacked leaf) from the storage slices `store[d][m][name]`: the
        blocks it needs, each ``.to`` its device, concatenated and
        sliced to the compute spec's block. Differentiable; under a
        counter `_Gather`."""
        keys = self._keys(name, d, m, g)
        fetch = {k: store[k[0]][k[1]].get(name) for k in keys}
        if count.active() is None:
            return self._build(name, d, m, g, fetch)
        return _Gather.apply(self, name, d, m, g, keys,
                             *[fetch[k] for k in keys])

    # -- reductions -----------------------------------------------------------
    @staticmethod
    def psum(parts: list) -> list:
        """The tensor-parallel seam over one data shard's model shards,
        differentiable: one device sums in order (`ServePlan.psum`),
        distinct cards all-reduce (`AllReduceSum`)."""
        if len({p.device for p in parts}) <= 1:
            return ServePlan.psum(parts)
        return list(AllReduceSum.apply(*parts))

    def leaf_amax(self, parts: list) -> list:
        """``max |x|`` of a logical leaf from its slices, one per shard in
        `shards` order: one result per shard, on its device (the
        compressor's scale, `grad_compression`)."""
        return reduce_tensors([torch.max(torch.abs(p)) for p in parts],
                              "max")

    def reduce_replicas(self, grads: list) -> None:
        """Sum, in place of each, the gradients of every copy of a
        replicated slice (`grads[d][m][name]`): one all-reduce per copy."""
        counting = count.active() is not None
        for name, groups in self.replicas.items():
            for group in groups:
                if len(group) < 2:
                    continue
                members = [p for p in group if p in self.shard_set]
                if not members:
                    continue
                parts = [grads[d][m][name] for d, m in members]
                if not counting:
                    sums = reduce_tensors(parts)
                else:
                    with count.hidden():
                        sums = list(parts) if self.stand_in else \
                            [s.clone() for s in reduce_tensors(parts)]
                    for pos, part, s in zip(members, parts, sums):
                        count.collective("all-reduce", _nbytes(part), pos,
                                         part.shape)
                        count.tag(s, pos)
                for (d, m), s in zip(members, sums):
                    grads[d][m][name] = s

    def global_norms(self, grads: list) -> list:
        """sqrt of the fp32 sum of squares over every logical leaf, each
        distinct slice counted once: ``[d][m]``, each position's copy on
        its device. Each position sums the slices it holds the counted
        copy of (in name order); one all-reduce adds the positions'
        sums in position order."""
        first = {}
        for name, groups in self.replicas.items():
            for group in groups:
                first.setdefault(group[0], []).append(name)
        partial = []
        for d, m in self.shards:
            with count.at((d, m)):
                total = torch.zeros((), dtype=torch.float32,
                                    device=self.device(d, m))
                for name in first.get((d, m), []):
                    total = total + torch.sum(torch.square(
                        grads[d][m][name].to(torch.float32)))
            partial.append(total)
        seam = Seam(len(self.all_shards), positions=self.shards,
                    stand_in=self.stand_in)
        out = [[None] * self.tp for _ in range(self.dp)]
        for (d, m), s in zip(self.shards, seam(partial)):
            with count.at((d, m)):
                out[d][m] = torch.sqrt(s)
        return out

    def global_norm(self, grads: list):
        """`global_norms`' value on the first position run ((0, 0))."""
        d, m = self.shards[0]
        return self.global_norms(grads)[d][m]

    # -- state ----------------------------------------------------------------
    def scatter(self, name: str, full, dtype=None) -> list:
        """A logical leaf as ``[d][m]`` copies of each shard's slice on
        its device (the shards this plan runs)."""
        out = [[None] * self.tp for _ in range(self.dp)]
        for d, m in self.shards:
            part = full[self.index(name, d, m)]
            out[d][m] = torch.empty(part.shape, dtype=dtype or part.dtype,
                                    device=self.device(d, m)).copy_(part)
        return out

    def shard_tree(self, flat: dict, dtype=None) -> list:
        """A flat ``{name: logical tensor}`` dict as ``[d][m] -> {name:
        slice}``."""
        out = [[{} for _ in range(self.tp)] for _ in range(self.dp)]
        for name, full in flat.items():
            parts = self.scatter(name, full, dtype)
            for d, m in self.shards:
                out[d][m][name] = parts[d][m]
        return out

    def logical(self, shards: list, name: str, device="cpu"):
        """Leaf `name` of ``shards[d][m]`` as one logical tensor on
        `device` (the host by default), from one copy of each distinct
        slice."""
        first = shards[0][0][name]
        out = torch.empty(self.shapes[name], dtype=first.dtype,
                          device=device)
        for group in self.replicas[name]:
            d, m = group[0]
            out[self.index(name, d, m)] = shards[d][m][name].detach()
        return out

    def logical_tree(self, shards: list, device="cpu") -> dict:
        return {n: self.logical(shards, n, device) for n in shards[0][0]}

    def tag_state(self, trees: list) -> None:
        """Under a counter, mark every tensor of ``trees[d][m]`` (params,
        optimizer state, gradients) as position (d, m)'s."""
        if count.active() is None:
            return
        for d, m in self.shards:
            count.tag(trees[d][m], (d, m))


class _Gathered:
    """Compute shard (d, m)'s per-layer params, gathered on demand
    (`run_stack_tp` indexes the layers in order)."""

    def __init__(self, model, d: int, m: int):
        self.model, self.d, self.m = model, d, m
        self.index = []
        gs = model.cfg.group_size()
        n_groups = model.cfg.num_layers // gs
        self.index = [(g, i) for g in range(n_groups) for i in range(gs)]
        self.index += [(None, i) for i in
                       range(model.cfg.num_layers - n_groups * gs)]

    def __getitem__(self, layer: int) -> dict:
        g, i = self.index[layer]
        return self.model._layer(self.d, self.m, g, i)


class ShardedTrainModel:
    """A model's weights stored by a `TrainPlan` (``shards[d][m]``: a flat
    ``{name: tensor}`` of shard (d, m)'s slices on its device), and the
    training loss over the plan. Without ``state`` the weights are drawn
    as `Model(cfg, seed=)` draws them, leaf by leaf on shard (0, 0)'s
    device, each sliced into its shards and freed: equal to the 1x1
    model's to the bit, with one leaf's extra memory at the peak. On a
    mesh without devices the slices are ``meta`` tensors (no draw),
    those of the positions the plan runs only."""

    def __init__(self, cfg, plan: TrainPlan, seed: int = 0,
                 state: Optional[dict] = None):
        self.cfg = cfg
        self.plan = plan
        self.shards = [[{} for _ in range(plan.tp)] for _ in range(plan.dp)]
        self._roots: list = []
        abstract = plan.device(0, 0).type == "meta" and state is None
        if state is not None:
            state = check_state(cfg, state)
        elif not abstract:
            dev = plan.device(0, 0)
            gen = torch.Generator(device=dev).manual_seed(seed)
        for name, ps in flatten(model_spec(cfg)).items():
            if abstract:
                for d, m in plan.shards:
                    self.shards[d][m][name] = torch.empty(
                        plan.slice_shape(name, d, m),
                        dtype=plan.dtypes[name], device="meta")
                continue
            full = state[name] if state is not None else \
                init_leaf(ps, gen, dev, cfg.param_dtype)
            parts = plan.scatter(name, full)
            del full
            for d, m in plan.shards:
                self.shards[d][m][name] = parts[d][m]
        self._layer_names = {}
        for name in flatten(model_spec(cfg)):
            head, _, rest = name.partition(".")
            if head in ("groups", "tail"):
                key, _, leaf = rest.partition(".")
                self._layer_names.setdefault((head, key), []).append(
                    (name, leaf))

    @property
    def device(self) -> torch.device:
        return self.plan.device(*self.plan.shards[0])

    def train_params(self) -> list:
        """Every storage slice made trainable: ``[d][m] -> {name:
        tensor}``, the tensors the step updates in place."""
        for d, m in self.plan.shards:
            for p in self.shards[d][m].values():
                p.requires_grad_(True)
        return self.shards

    def leaves(self) -> list:
        """Every storage slice, shard by shard in `TrainPlan.shards`
        order, name by name."""
        return [t for d, m in self.plan.shards
                for t in self.shards[d][m].values()]

    def held_bytes(self, opt: list) -> list:
        """Bytes shard (d, m) holds, ``[d][m]``: its parameter slices and
        its optimizer state's (`opt`, ``[d][m]``) step, m, v and master."""
        out = [[0] * self.plan.tp for _ in range(self.plan.dp)]
        for d, m in self.plan.shards:
            o = opt[d][m]
            out[d][m] = _nbytes(o["step"]) + sum(
                _nbytes(t) for tree in [self.shards[d][m]]
                + [o[k] for k in OPT_LEAVES if k in o]
                for t in tree.values())
        return out

    def logical_params(self, device="cpu") -> dict:
        """The weights as logical tensors on `device` (the host)."""
        return self.plan.logical_tree(self.shards, device)

    # -- forward --------------------------------------------------------------
    def _layer(self, d: int, m: int, g, i: int) -> dict:
        """Compute shard (d, m)'s params of layer i of group g (g None:
        tail layer i), gathered from storage."""
        key = ("groups", f"l{i}") if g is not None else ("tail", f"t{i}")
        return unflatten({leaf: self.plan.gather(self.shards, name, d, m, g)
                          for name, leaf in self._layer_names[key]})

    def _row_weights(self, d: int) -> _RowWeights:
        names = [n for n in self.plan.shapes
                 if n.startswith(("embed.", "final_norm"))]
        return _RowWeights(self.cfg, unflatten(
            {n: self.plan.gather(self.shards, n, d, 0) for n in names}))

    def _row_inputs(self, d: int, rows: dict, grad: bool):
        """Data shard d's prologue: (x, positions, image embeddings) on its
        model shard 0 (the row weights' `Model.inputs`), or ``meta``
        stand-ins of their shapes when the plan does not run (d, 0) (a
        stand-in x requires grad when `grad`, so the backward reaches
        it)."""
        plan = self.plan
        if plan.runs(d, 0):
            row = self._row_weights(d)
            dev = plan.device(d, 0)

            def to0(k):
                return rows[k].to(dev) if rows.get(k) is not None else None

            with count.at((d, 0)):
                x, positions, image = row.inputs(
                    to0("tokens"), to0("embeds"), to0("image_embeds"))
            return row, x, positions, image
        cfg = self.cfg
        lead = next(iter(rows.values())).shape[:2]
        with count.hidden():
            x = torch.empty(tuple(lead) + (cfg.d_model,), device="meta",
                            dtype=torch_dtype(cfg.compute_dtype))
            positions = torch.empty(tuple(lead), dtype=torch.int32,
                                    device="meta")
            image = rows.get("image_embeds")
            image = None if image is None else torch.empty(
                image.shape, dtype=x.dtype, device="meta")
        if grad:
            x.requires_grad_(True)
            self._roots.append(("input", x))
        return None, x, positions, image

    def shard_forward(self, d: int, rows: dict, backend: str = "auto"):
        """Data shard d's forward over its rows of a batch (``tokens`` or
        ``embeds``, ``image_embeds``): (logits (b/dp, s, V) on the row's
        model shard 0, the MoE layers' ``(me, ce)`` pairs); (None, [])
        when the plan does not run (d, 0)."""
        plan = self.plan
        ms = plan.row(d)
        devs = [plan.device(d, m) for m in ms]
        row, x, positions, image = self._row_inputs(d, rows, True)
        seam = plan.seam(d, x.shape[1])
        xs = seam.broadcast(x, devs)
        if seam.seq > 1:
            xs = [seam._seq_slice(x, j) for j, x in enumerate(xs)]
        xs, stats = train_stack_tp(
            self.cfg,
            lambda g, i: [self._layer(d, m, g, i) for m in ms],
            xs, seam,
            positions=[positions.to(dev) for dev in devs], backend=backend,
            cross_embeds=None if image is None
            else [image.to(dev) for dev in devs])
        xs = seam.gather_seq(xs)
        for j, m in enumerate(ms):
            if m and j in seam.last:
                self._roots.append(("seam", seam.last[j]))
        if row is None:
            return None, []
        with count.at((d, 0)):
            return row.head(xs[0]), stats

    def loss(self, batch: dict, loss_fn, backend: str = "auto"):
        """The global loss of a batch (or microbatch) of global rows:
        ``loss_fn(logits, labels)`` (a mean) on each data shard's rows,
        their mean, and the MoE load-balancing loss of the means over the
        data shards. Returns (loss, aux), fp32 scalars on shard (0, 0)'s
        device (stand-ins when the plan does not run (0, 0))."""
        plan = self.plan
        n = next(iter(batch.values())).shape[0]
        if n % plan.dp:
            raise ValueError(f"{n} rows do not split over {plan.dp} data "
                             f"shards")
        per = n // plan.dp
        self._roots = []
        losses, stats = {}, {}
        for d in plan.rows():
            rows = {k: v[d * per:(d + 1) * per] for k, v in batch.items()}
            logits, st = self.shard_forward(d, rows, backend)
            if logits is not None:
                with count.at((d, 0)):
                    losses[d] = loss_fn(
                        logits, rows["labels"].to(logits.device))
                stats[d] = st
        ds = sorted(losses)
        dseam = plan.data_seam(ds)
        sums = dseam([losses[d] for d in ds]) if ds else []
        layer_sums = [[dseam([stats[d][layer][k] for d in ds])
                       for k in (0, 1)]
                      for layer in range(len(stats[ds[0]]) if ds else 0)]
        for j, d in enumerate(ds):
            if d:
                self._roots += [("seam", sums[j])] + [
                    ("seam", ls[k][j]) for ls in layer_sums for k in (0, 1)]
        if not plan.runs(0, 0):
            return None, None
        dev = plan.device(0, 0)
        with count.at((0, 0)):
            loss = sums[0] / plan.dp
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for me, ce in layer_sums:
                aux = aux + moe_mod.balance_loss(
                    self.cfg, me[0] / plan.dp, ce[0] / plan.dp)
        return loss, aux

    def run(self, d: int, rows: dict, *, mode: str, caches=None, pos=None,
            backend: str = "auto"):
        """Data shard d's prefill (``mode="prefill"``: last-position
        logits, per-layer lists of the model shards' caches) or decode
        step (``"decode"``: one token a row over ``caches`` at position
        `pos`, updated in place: logits (b, V), caches), the weights
        gathered layer by layer; logits None when the plan does not run
        (d, 0). No gradient."""
        plan = self.plan
        ms = plan.row(d)
        devs = [plan.device(d, m) for m in ms]
        row, x, positions, image = self._row_inputs(d, rows, False)
        seam = plan.seam(d, x.shape[1] if mode == "prefill" else 0)
        xs = seam.broadcast(x, devs)
        if seam.seq > 1:
            xs = [seam._seq_slice(x, j) for j, x in enumerate(xs)]
        pos_in = [positions.to(dev) for dev in devs] if mode == "prefill" \
            else [pos] * len(ms)
        xs, caches = run_stack_tp(
            self.cfg, [_Gathered(self, d, m) for m in ms], xs, seam,
            mode=mode, positions=pos_in, caches=caches, backend=backend,
            cross_embeds=None if image is None
            else [image.to(dev) for dev in devs])
        xs = seam.gather_seq(xs)
        if row is None:
            return None, caches
        with count.at((d, 0)):
            return row.head(xs[0][:, -1:])[:, 0], caches


def init_plan_opt_state(params: list, oc) -> list:
    """Each shard's `init_opt_state` over its slices: ``[d][m]``."""
    return [[init_opt_state(p, oc) if p else {} for p in row]
            for row in params]


def shard_opt_state(plan: TrainPlan, opt: dict) -> list:
    """A logical optimizer state ``{"step", "m", "v"[, "master"]}`` (a
    checkpoint's, or a JAX run's through `convert`) as ``[d][m]``
    per-shard states: each shard its own step and its slices, fp32."""
    out = [[{"step": opt["step"].to(plan.device(d, m), copy=True)}
            for m in range(plan.tp)] for d in range(plan.dp)]
    for key in OPT_LEAVES:
        if key in opt:
            for d, row in enumerate(plan.shard_tree(opt[key],
                                                    torch.float32)):
                for m, shard in enumerate(row):
                    out[d][m][key] = shard
    return out


def logical_opt_state(plan: TrainPlan, opt: list) -> dict:
    """`shard_opt_state`'s inverse: logical leaves on the host."""
    out = {"step": opt[0][0]["step"].detach().cpu()}
    for key in OPT_LEAVES:
        if key in opt[0][0]:
            out[key] = plan.logical_tree([[o[key] for o in row]
                                          for row in opt])
    return out
