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
  each distinct slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import MLA
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import flatten, init_leaf, unflatten
from repro_torch.models.transformer import (Model, check_state,
                                            model_logical, model_spec,
                                            train_stack_tp)
from repro_torch.serve.sharding import ServePlan, all_reduced, reduce_tensors
from repro_torch.sharding.partition import (DEFAULT_RULES, mesh_axis_sizes,
                                            spec_for)
from repro_torch.train.optimizer import init_opt_state

PLAN_AXES = ("data", "model")
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
    """The FSDP x TP layout of a ("data", "model") mesh for one config;
    see the module docstring. Construct through `from_mesh`, which
    returns None for a mesh of one position (the unsharded trainer)."""

    def __init__(self, mesh, cfg):
        extra = set(mesh.axis_names) - set(PLAN_AXES)
        if extra:
            raise ValueError(f"a training plan lays shards over "
                             f"{PLAN_AXES}, not {sorted(extra)}")
        self.check(cfg, mesh)
        self.serve = ServePlan(mesh)
        self.mesh = mesh
        self.dp, self.tp = self.serve.dp, self.serve.tp
        self.sizes = mesh_axis_sizes(mesh)
        self.shards = [(d, m) for d in range(self.dp) for m in range(self.tp)]
        logical = model_logical(cfg)
        spec = flatten(model_spec(cfg))
        self.shapes = {n: tuple(ps.shape) for n, ps in spec.items()}
        self.specs = {n: spec_for(self.shapes[n], logical[n], mesh,
                                  DEFAULT_RULES) for n in spec}
        self.compute_specs = self.serve.param_specs(cfg)
        # the storage shards holding each distinct slice of a leaf: the
        # first of each group is the copy the norm counts
        self.replicas = {}
        for n in spec:
            groups: dict = {}
            for d, m in self.shards:
                key = tuple((s.start, s.stop) for s in self.index(n, d, m))
                groups.setdefault(key, []).append((d, m))
            self.replicas[n] = list(groups.values())

    @staticmethod
    def check(cfg, mesh):
        """Raise when the port cannot train `cfg` on `mesh`: a mixer with
        no per-shard training body (`NotImplementedError`), or head / ffn
        / kv-head counts the model axis does not divide (`ValueError`)."""
        if MLA in {mx for mx, _ in cfg.layer_kinds()}:
            raise NotImplementedError(
                f"{cfg.name}: MLA layers have no per-shard training body "
                f"(their q / kv low-rank norms span the sharded q_lora and "
                f"kv_lora axes; ROADMAP Queue 1 item 6d)")
        plan = ServePlan(mesh)
        plan.check_config(cfg)
        plan.replicate_heads(cfg.num_kv_heads, cfg.name)

    @staticmethod
    def from_mesh(mesh, cfg) -> Optional["TrainPlan"]:
        """None (or a mesh of one position) -> None."""
        if mesh is None or math.prod(mesh.axis_sizes) == 1:
            return None
        return TrainPlan(mesh, cfg)

    def __repr__(self):
        return f"TrainPlan(dp={self.dp}, tp={self.tp})"

    def device(self, d: int = 0, m: int = 0) -> torch.device:
        return self.serve.device(d, m)

    # -- layout ---------------------------------------------------------------
    def index(self, name: str, d: int, m: int) -> tuple:
        """Slices of leaf `name` that shard (d, m) stores."""
        return self.serve.local_index(self.shapes[name], self.specs[name],
                                      d, m)

    def _holder(self, name: str, blocks: tuple, d: int, m: int) -> tuple:
        """The storage shard holding the block of per-dimension indices
        `blocks`, taking (d, m)'s coordinate on every axis the leaf's
        storage does not split (its own copy of a replicated slice)."""
        coords = {"data": d, "model": m}
        for entry, j in zip(self.specs[name], blocks):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            for ax in reversed(axes):
                coords[ax] = j % self.sizes[ax]
                j //= self.sizes[ax]
        return coords["data"], coords["model"]

    def gather(self, store: list, name: str, d: int, m: int, g=None):
        """Compute shard (d, m)'s weight `name` (of layer group `g` of a
        stacked leaf) from the storage slices `store[d][m][name]`: the
        blocks it needs, each ``.to`` its device, concatenated and
        sliced to the compute spec's block. Differentiable."""
        shape = self.shapes[name]
        spec = self.specs[name]
        want = self.serve.local_index(shape, self.compute_specs[name], d, m)
        lead = 0 if g is None else 1
        dev = self.device(d, m)
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

        def build(k: int, blocks: tuple):
            if k == len(ranges):
                hd, hm = self._holder(name, (0,) * lead + blocks, d, m)
                t = store[hd][hm][name]
                return (t if g is None else t[g]).to(dev)
            parts = [build(k + 1, blocks + (j,)) for j in ranges[k]]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=k)

        out = build(0, ())
        if any(c != slice(0, n) for c, n in zip(cuts, out.shape)):
            out = out[tuple(cuts)]
        return out

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
        replicated slice (`grads[d][m][name]`)."""
        for name, groups in self.replicas.items():
            for group in groups:
                if len(group) > 1:
                    sums = reduce_tensors([grads[d][m][name]
                                           for d, m in group])
                    for (d, m), s in zip(group, sums):
                        grads[d][m][name] = s

    def global_norm(self, grads: list):
        """sqrt of the fp32 sum of squares over every logical leaf (in
        name order), each distinct slice counted once, on shard (0, 0)'s
        device."""
        dev = self.device(0, 0)
        total = 0.0
        for name, groups in self.replicas.items():
            for d, m in (g[0] for g in groups):
                g = grads[d][m][name]
                total = total + torch.sum(torch.square(
                    g.to(torch.float32))).to(dev)
        return torch.sqrt(total)

    # -- state ----------------------------------------------------------------
    def scatter(self, name: str, full, dtype=None) -> list:
        """A logical leaf as ``[d][m]`` copies of each shard's slice on
        its device."""
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


class ShardedTrainModel:
    """A model's weights stored by a `TrainPlan` (``shards[d][m]``: a flat
    ``{name: tensor}`` of shard (d, m)'s slices on its device), and the
    training loss over the plan. Without ``state`` the weights are drawn
    as `Model(cfg, seed=)` draws them, leaf by leaf on shard (0, 0)'s
    device, each sliced into its shards and freed: equal to the 1x1
    model's to the bit, with one leaf's extra memory at the peak."""

    def __init__(self, cfg, plan: TrainPlan, seed: int = 0,
                 state: Optional[dict] = None):
        self.cfg = cfg
        self.plan = plan
        self.shards = [[{} for _ in range(plan.tp)] for _ in range(plan.dp)]
        if state is not None:
            state = check_state(cfg, state)
        else:
            dev = plan.device(0, 0)
            gen = torch.Generator(device=dev).manual_seed(seed)
        for name, ps in flatten(model_spec(cfg)).items():
            full = state[name] if state is not None else \
                init_leaf(ps, gen, dev, cfg.param_dtype)
            parts = plan.scatter(name, full)
            del full
            for d, m in plan.shards:
                self.shards[d][m][name] = parts[d][m]
        self._layer_names = {}
        for name in self.shards[0][0]:
            head, _, rest = name.partition(".")
            if head in ("groups", "tail"):
                key, _, leaf = rest.partition(".")
                self._layer_names.setdefault((head, key), []).append(
                    (name, leaf))

    @property
    def device(self) -> torch.device:
        return self.plan.device(0, 0)

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
        def nbytes(t):
            return t.numel() * t.element_size()

        out = [[0] * self.plan.tp for _ in range(self.plan.dp)]
        for d, m in self.plan.shards:
            o = opt[d][m]
            out[d][m] = nbytes(o["step"]) + sum(
                nbytes(t) for tree in [self.shards[d][m]]
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
        names = [n for n in self.shards[0][0]
                 if n.startswith(("embed.", "final_norm"))]
        return _RowWeights(self.cfg, unflatten(
            {n: self.plan.gather(self.shards, n, d, 0) for n in names}))

    def shard_forward(self, d: int, rows: dict, backend: str = "auto"):
        """Data shard d's forward over its rows of a batch (``tokens`` or
        ``embeds``, ``image_embeds``): (logits (b/dp, s, V) on the row's
        model shard 0, the MoE layers' ``(me, ce)`` pairs)."""
        plan = self.plan
        devs = [plan.device(d, m) for m in range(plan.tp)]
        row = self._row_weights(d)

        def to0(k):
            return rows[k].to(devs[0]) if rows.get(k) is not None else None

        x, positions, image = row.inputs(to0("tokens"), to0("embeds"),
                                         to0("image_embeds"))
        xs, stats = train_stack_tp(
            self.cfg,
            lambda g, i: [self._layer(d, m, g, i) for m in range(plan.tp)],
            [x.to(dev) for dev in devs], plan.psum,
            positions=[positions.to(dev) for dev in devs], backend=backend,
            cross_embeds=None if image is None
            else [image.to(dev) for dev in devs])
        return row.head(xs[0]), stats

    def loss(self, batch: dict, loss_fn, backend: str = "auto"):
        """The global loss of a batch (or microbatch) of global rows:
        ``loss_fn(logits, labels)`` (a mean) on each data shard's rows,
        their mean, and the MoE load-balancing loss of the means over the
        data shards. Returns (loss, aux), fp32 scalars on shard (0, 0)'s
        device."""
        plan = self.plan
        dev = self.device
        n = next(iter(batch.values())).shape[0]
        if n % plan.dp:
            raise ValueError(f"{n} rows do not split over {plan.dp} data "
                             f"shards")
        per = n // plan.dp
        losses, stats = [], []
        for d in range(plan.dp):
            rows = {k: v[d * per:(d + 1) * per] for k, v in batch.items()}
            logits, st = self.shard_forward(d, rows, backend)
            losses.append(loss_fn(logits, rows["labels"].to(logits.device))
                          .to(dev))
            stats.append(st)
        loss = losses[0]
        for x in losses[1:]:
            loss = loss + x
        loss = loss / plan.dp
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for layer in zip(*stats):
            me, ce = (reduce_tensors([s[k].to(dev) for s in layer])[0]
                      / plan.dp for k in (0, 1))
            aux = aux + moe_mod.balance_loss(self.cfg, me, ce)
        return loss, aux


def init_plan_opt_state(params: list, oc) -> list:
    """Each shard's `init_opt_state` over its slices: ``[d][m]``."""
    return [[init_opt_state(p, oc) for p in row] for row in params]


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
