"""Mesh-aware serving plan: how a decode batch, its page pool and the
fused step map onto a mesh, the port of ``repro/serve/sharding.py``.

One `ServePlan` is derived from a mesh (`launch.mesh.make_serve_mesh`)
and threaded from launcher to kernel:

- decode rows (and so each row's KV pages) shard over the ``data`` axis:
  shard ``s`` of ``dp`` owns rows ``[s * b/dp, (s+1) * b/dp)`` and ALL
  pages of the sequences decoding in them, so per-shard paged attention
  never gathers a remote page (the thesis's data-centric argument
  carried across devices: the pages live where the attention runs);
- attention / MLP heads shard over the ``model`` axis through
  `sharding.partition.SERVE_RULES` (embeddings, lm_head and norms
  replicate: no per-token all-gather), with the two tensor-parallel
  reduction seams (attention out-projection, MLP down-projection)
  summed in the step;
- the page-pool tensors carry the `kernels.paged_attention.spec
  .head_sharded_specs` layout: capacity over ``data``, kv heads over
  ``model``.

The reference runs one controller over a ``shard_map``; so does the port,
without one: the controller holds every shard's weights and state and
launches each shard's work in turn. A shard is a mesh position, and its
tensors live on that position's device; several positions may share a
device (one card carrying a 2 x 2 plan, or the CPU in the tests). The
reduction seam is `ServePlan.psum` (`reduce_tensors`): over shards on one
device an in-order sum (shard 0, then 1, ...), over distinct cards an
NCCL all-reduce. A
plan of one shard is None: the exact unsharded path.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, CROSS_ATTN, LOCAL_ATTN, MLA,
                                      MLP_DENSE, RGLRU, SSD)
from repro_torch.kernels.paged_attention.spec import head_sharded_specs
from repro_torch.models.common import Seam, flatten, unflatten
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.transformer import (Model, model_logical, model_spec,
                                            pad_caches, run_stack_tp)
from repro_torch.sharding.partition import (COMPUTE_RULES, SERVE_RULES, P,
                                            mesh_axis_sizes, spec_for)

POOL_ARGS = ("k_pages", "v_pages", "k_quant", "v_quant",
             "k_scale", "v_scale")

# NCCL's ncclRedOp_t values (`torch.cuda.nccl` names only SUM)
NCCL_OPS = {"sum": 0, "max": 2}


def all_reduce_(tensors: list, op: str = "sum") -> None:
    """NCCL all-reduce in place over tensors on distinct CUDA devices."""
    from torch.cuda import nccl
    nccl.all_reduce(tensors, op=NCCL_OPS[op])


def all_reduced(ts: list, op: str = "sum") -> list:
    """Copies of tensors on distinct CUDA devices, each the sum (or max)
    of them all: one NCCL all-reduce."""
    outs = [t.contiguous().clone() for t in ts]
    all_reduce_(outs, op)
    return outs


def reduce_tensors(ts: list, op: str = "sum") -> list:
    """The sum (or max) of tensors of one shape, one result per input on
    its device. On one device an in-order sum (inputs 0, 1, ...); over
    distinct CUDA devices one NCCL all-reduce; otherwise in order on the
    first input's device, copied back."""
    devs = [t.device for t in ts]
    if len(set(devs)) == len(ts) > 1 and all(d.type == "cuda" for d in devs):
        return all_reduced(ts, op)
    combine = torch.add if op == "sum" else torch.maximum
    out = ts[0]
    for t in ts[1:]:
        out = combine(out, t.to(devs[0]))
    if len(set(devs)) == 1:
        return [out] * len(ts)
    return [out.to(d) for d in devs]


class ServePlan:
    """dp (rows over "data") x tp (heads over "model") serving layout of
    one mesh; see the module docstring. Construct through `from_mesh`,
    which returns None for a mesh of one position."""

    def __init__(self, mesh):
        sizes = mesh_axis_sizes(mesh)
        self.mesh = mesh
        self.dp = int(sizes.get("data", 1))
        self.tp = int(sizes.get("model", 1))
        self.devices = None
        devices = getattr(mesh, "devices", None)
        if devices is not None:
            self.devices = np.asarray(devices, dtype=object) \
                .reshape(self.dp, self.tp)
            for d in range(self.dp):
                row = list(self.devices[d])
                if len(set(row)) not in (1, len(row)):
                    raise ValueError(
                        f"data shard {d} lays its model shards on devices "
                        f"{row}: a model row must be one device (summed "
                        f"in order) or distinct devices (all-reduced)")

    @staticmethod
    def from_mesh(mesh) -> Optional["ServePlan"]:
        """None (or a mesh of one position) -> None: the unsharded
        serving stack."""
        if mesh is None:
            return None
        plan = ServePlan(mesh)
        return plan if plan.dp * plan.tp > 1 else None

    def __repr__(self):
        return f"ServePlan(dp={self.dp}, tp={self.tp})"

    # -- devices and the reduction seam --------------------------------------
    def device(self, d: int = 0, m: int = 0) -> torch.device:
        """The device of shard (d, m); (0, 0) is the controller's, where
        control blocks land and sampled tokens are gathered."""
        if self.devices is None:
            raise ValueError(f"{self}: an abstract mesh has no devices")
        return self.devices[d, m]

    @staticmethod
    def psum(parts: list) -> list:
        """The tensor-parallel reduction seam over one data shard's model
        shards: a list of per-shard parts -> a list of sums, one per
        shard (`reduce_tensors`: parts on one device sum in shard order,
        deterministic; parts on distinct CUDA devices go through one NCCL
        all-reduce)."""
        if len(parts) == 1:
            return list(parts)
        devs = {p.device for p in parts}
        if len(devs) not in (1, len(parts)):
            raise ValueError(f"reduction over devices {devs}: parts must "
                             f"share one device or each have their own")
        return reduce_tensors(parts)

    # -- validation ----------------------------------------------------------
    def check_config(self, cfg):
        """Fail at engine construction when the model's head / ffn dims
        cannot split over the model axis (the reference's check and
        message)."""
        if self.tp == 1:
            return
        mixers = {m for m, _ in cfg.layer_kinds()}
        mlps = {ml for _, ml in cfg.layer_kinds()}
        checks = []
        if mixers & {ATTN, LOCAL_ATTN, MLA, CROSS_ATTN}:
            checks.append(("num_heads", cfg.num_heads))
            # kv heads the model axis cannot divide (e.g. MQA) are fine
            # as long as each shard's q-head block still maps onto whole
            # kv heads: the pool then replicates the head axis
            if cfg.num_kv_heads % self.tp and \
                    (cfg.num_heads // max(self.tp, 1)) % cfg.num_kv_heads:
                checks.append(("num_kv_heads", cfg.num_kv_heads))
        if MLP_DENSE in mlps:
            checks.append(("d_ff", cfg.d_ff))
        if SSD in mixers:
            nh = (cfg.ssm_expand * cfg.d_model) // cfg.ssm_head_dim
            checks.append(("ssm_heads", nh))
        if RGLRU in mixers:
            checks.append(("lru_width", cfg.lru_width))
        bad = [f"{name}={n}" for name, n in checks if n % self.tp]
        if bad:
            raise ValueError(
                f"{cfg.name}: {', '.join(bad)} not divisible by the "
                f"model-axis size {self.tp} — pick a mesh whose model "
                f"axis divides the head and ffn dims")

    def replicate_heads(self, hkv: int, name: str = "model") -> bool:
        """True when every model shard holds all `hkv` kv heads: one kv
        head (MQA) on tp > 1. More kv heads than one that the model axis
        does not divide raise `ValueError`: each shard would pair its q
        heads with kv heads at the wrong group size. `check_config`, as
        the reference's, lets such a plan through when a shard's q block
        divides into the kv heads (qwen3-moe-30b-a3b at tp 8)."""
        if hkv <= 0 or hkv % self.tp == 0:
            return False
        if hkv > 1:
            raise ValueError(
                f"{name}: num_kv_heads={hkv} not divisible by the "
                f"model-axis size {self.tp}, and more than one kv head "
                f"cannot replicate — pick a mesh whose model axis divides "
                f"the kv heads")
        return True

    # -- decode rows over the data axis --------------------------------------
    def pad_rows(self, n: int) -> int:
        """Rows the decode batch must carry so every data shard gets an
        equal block (extra rows are seq -1 padding)."""
        return -(-n // self.dp) * self.dp

    def shard_of_row(self, row: int, n_rows: int) -> int:
        """Data shard owning row `row` of an `n_rows`-row batch (equal
        contiguous blocks; `n_rows` must be a multiple of dp)."""
        return row // (n_rows // self.dp)

    # -- layouts --------------------------------------------------------------
    def _drop_missing(self, spec, drop=()) -> P:
        sizes = mesh_axis_sizes(self.mesh)
        return P(*(None if ax in drop or (ax is not None and ax not in sizes)
                   else ax for ax in spec))

    def pool_specs(self, replicate_heads: bool = False) -> tuple:
        """`P`s of the six layer-stacked pool tensors, in
        `DevicePagePool.arrays` order. ``replicate_heads`` strips the
        "model" entry (kv heads that do not divide the model axis); an
        axis the mesh does not carry replicates, as `spec_for` falls
        back."""
        specs = head_sharded_specs(layer_stacked=True)
        drop = {"model"} if replicate_heads else set()
        return tuple(self._drop_missing(specs[a], drop) for a in POOL_ARGS)

    def _param_spec(self, shape, logical) -> P:
        logical = tuple(logical)
        if "experts" in logical:
            # MoE subtrees replicate wholesale: top-k routing is local per
            # token and scores every expert
            return P()
        return spec_for(shape, logical, self.mesh, SERVE_RULES)

    def param_specs(self, model) -> dict:
        """Flat ``{name: P}`` over the model's parameters (a `Model` or
        its config)."""
        cfg = getattr(model, "cfg", model)
        logical = model_logical(cfg)
        return {n: self._param_spec(ps.shape, logical[n])
                for n, ps in flatten(model_spec(cfg)).items()}

    def whole_sublayers(self, cfg) -> set:
        """The sublayer keys (``attn``, ``mla``, ``ssm``, ``rglru``,
        ``mlp``) whose head count (heads, SSD heads, RG-LRU width, d_ff)
        the model axis does not divide: every shard runs them whole, as
        GSPMD replicates what the axis cannot split."""
        if self.tp == 1:
            return set()
        kinds = cfg.layer_kinds()
        mixers = {m for m, _ in kinds}
        sizes = {"attn": (cfg.num_heads, mixers & {ATTN, LOCAL_ATTN,
                                                   CROSS_ATTN}),
                 "mla": (cfg.num_heads, mixers & {MLA}),
                 "ssm": (ssm_dims(cfg)[1], mixers & {SSD}),
                 "rglru": (cfg.lru_width, mixers & {RGLRU}),
                 "mlp": (cfg.d_ff, {ml for _, ml in kinds} & {MLP_DENSE})}
        return {k for k, (n, has) in sizes.items() if has and n % self.tp}

    def compute_specs(self, model) -> dict:
        """Flat ``{name: P}`` of the weights each shard computes with
        (`sharding.partition.COMPUTE_RULES`; MoE subtrees and the
        sublayers of `whole_sublayers` whole). Equal to `param_specs` for
        every config `check_config` accepts but MLA."""
        cfg = getattr(model, "cfg", model)
        logical = model_logical(cfg)
        whole = self.whole_sublayers(cfg)
        out = {}
        for n, ps in flatten(model_spec(cfg)).items():
            parts = n.split(".")
            sub = parts[2] if parts[0] in ("groups", "tail") else None
            if sub in whole or "experts" in logical[n]:
                out[n] = P()
            else:
                out[n] = spec_for(ps.shape, logical[n], self.mesh,
                                  COMPUTE_RULES)
        return out

    def seam(self, d: int = 0) -> Seam:
        """Data shard d's model-axis `Seam` over every model shard, its
        sum `psum`."""
        return Seam(self.tp, positions=[(d, m) for m in range(self.tp)],
                    reduce=self.psum)

    def local_index(self, shape, spec, d: int, m: int) -> tuple:
        """Slices of the block of a `shape` tensor laid out by `spec`
        that shard (d, m) holds."""
        sizes = mesh_axis_sizes(self.mesh)
        coords = {"data": d, "model": m}
        out = []
        for i, n in enumerate(shape):
            entry = spec[i] if i < len(spec) else None
            if entry is None:
                out.append(slice(None))
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            idx, size = 0, 1
            for ax in axes:
                idx = idx * sizes[ax] + coords.get(ax, 0)
                size *= sizes[ax]
            step = n // size
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def shard_params(self, model, params: dict) -> list:
        """Each shard's slice of a flat state dict, copied onto that
        shard's device: ``[d][m] -> {name: tensor}``. A replicated leaf is
        copied once per shard, as each of several cards would hold it."""
        specs = self.compute_specs(model)
        out = []
        for d in range(self.dp):
            row = []
            for m in range(self.tp):
                dev = self.device(d, m)
                flat = {}
                for name, v in params.items():
                    part = v[self.local_index(v.shape, specs[name], d, m)]
                    flat[name] = torch.empty(part.shape, dtype=part.dtype,
                                             device=dev).copy_(part)
                row.append(flat)
            out.append(row)
        return out


class ShardWeights:
    """One shard's weights in `Model`'s trees: ``params`` in the
    reference layout and ``layers`` as per-layer views, over the shard's
    slices."""

    embed_in = Model.embed_in
    head = Model.head

    def __init__(self, cfg, flat: dict):
        self.cfg = cfg
        self.params = unflatten(flat)
        gs = cfg.group_size()
        groups = self.params["groups"]
        self.layers = [
            unflatten({n: t[g] for n, t in flatten(groups[f"l{i}"]).items()})
            for g in range(cfg.num_layers // gs) for i in range(gs)]
        self.layers += [self.params["tail"][f"t{i}"]
                        for i in range(len(self.params.get("tail", {})))]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in flatten(self.params).values())


class ShardedModel:
    """A model's weights laid out by a `ServePlan`: ``shards[d][m]`` is
    shard (d, m)'s `ShardWeights`, on its device. No shard holds an
    unsharded copy of a sharded weight.

    `prefill` is the tensor-parallel prefill of one data shard: every
    layer runs on each model shard's heads (the flash, SSD-scan and
    RG-LRU-scan kernels at the shard's width) and the seams sum the
    partial outputs. `forward_prefill_dense` / `forward_decode_dense`
    are the engine's dense-cache path over the plan (every mixer, MLA
    and cross-attention included): rows split over the data shards, each
    model shard keeps its own caches (its kv heads; MLA's latents
    whole)."""

    def __init__(self, cfg, plan: ServePlan, params: dict):
        self.cfg = cfg
        self.plan = plan
        self.kinds = cfg.layer_kinds()
        flats = plan.shard_params(cfg, params)
        self.shards = [[ShardWeights(cfg, f) for f in row] for row in flats]
        self.paged_mixers = {m for m, _ in self.kinds} <= \
            {ATTN, LOCAL_ATTN, SSD, RGLRU}
        self.rep_heads = plan.replicate_heads(cfg.num_kv_heads, cfg.name) \
            if self.paged_mixers else False

    @property
    def device(self) -> torch.device:
        return self.plan.device(0, 0)

    def parameters(self):
        """Shard (0, 0)'s tensors (their device is the controller's)."""
        return iter(flatten(self.shards[0][0].params).values())

    def nbytes(self) -> int:
        return sum(w.nbytes() for row in self.shards for w in row)

    def _merge(self, kind, caches: list) -> dict:
        """One layer's per-shard caches as the unsharded layer's, on the
        host: kv heads, SSD heads and RG-LRU width concatenated in shard
        order; replicated leaves (MQA heads, the SSD conv taps) from
        shard 0."""
        mixer = kind[0]

        def cat(name, dim):
            return torch.cat([c[name].cpu() for c in caches], dim=dim)

        if mixer in (ATTN, LOCAL_ATTN):
            if self.rep_heads:
                return {n: caches[0][n].cpu() for n in ("k", "v")}
            return {"k": cat("k", 2), "v": cat("v", 2)}
        if mixer == SSD:
            return {"conv": caches[0]["conv"].cpu(), "state": cat("state", 1)}
        return {"h": cat("h", -1), "conv": cat("conv", -1)}

    def _prefill_rows(self, tokens, d: int, backend: str, all_logits: bool):
        """Data shard d's prefill of `tokens` (b, s): (logits on the
        controller's device, per-layer lists of the model shards'
        caches)."""
        ws = self.shards[d]
        devs = [self.plan.device(d, m) for m in range(len(ws))]
        xs = [w.embed_in(tokens.to(dev)) for w, dev in zip(ws, devs)]
        b, s = tokens.shape
        positions = [torch.arange(s, dtype=torch.int32, device=dev)
                     .expand(b, s) for dev in devs]
        xs, caches = run_stack_tp(self.cfg, [w.layers for w in ws], xs,
                                  self.plan.seam(d), mode="prefill",
                                  positions=positions, backend=backend)
        x = xs[0] if all_logits else xs[0][:, -1:]
        logits = ws[0].head(x)
        if not all_logits:
            logits = logits[:, 0]
        return logits.to(self.device), caches

    def prefill(self, tokens, d: int = 0, *, backend: str = "auto",
                all_logits: bool = False):
        """Prefill `tokens` (b, s) on data shard `d` through the model's
        layer body (`run_stack_tp`). Returns (logits on the controller's
        device: (b, V) at the last position, or (b, s, V) with
        ``all_logits``; the per-layer caches merged as the unsharded
        model's, on the host)."""
        if not self.paged_mixers:
            raise NotImplementedError(
                f"{self.cfg.name}: the paged path has no MLA or "
                f"cross-attention layers; serve through generate")
        logits, caches = self._prefill_rows(tokens, d, backend, all_logits)
        return logits, [self._merge(kind, c) for kind, c
                        in zip(self.kinds, caches)]

    def _row_blocks(self, b: int) -> list:
        """Rows of a dense batch per data shard: equal contiguous blocks
        (the first data shards take one more when dp does not divide b)."""
        return [blk for blk in np.array_split(np.arange(b), self.plan.dp)
                if len(blk)]

    def forward_prefill_dense(self, tokens, capacity: int,
                              backend: str = "auto"):
        """The dense-cache prefill over the plan: each data shard prefills
        its rows, each model shard keeps its caches, padded to `capacity`
        (`pad_caches`). Returns (last-position logits (b, V) on the
        controller's device, the decode state)."""
        logits, state = [], []
        for d, rows in enumerate(self._row_blocks(tokens.shape[0])):
            lg, caches = self._prefill_rows(tokens[rows], d, backend, False)
            per_shard = [pad_caches([c[m] for c in caches], capacity,
                                    self.cfg)
                         for m in range(self.plan.tp)]
            logits.append(lg)
            state.append([[ps[layer] for ps in per_shard]
                          for layer in range(len(self.kinds))])
        return torch.cat(logits), state

    def forward_decode_dense(self, tokens, state, pos: int):
        """One token step of every row (tokens (b, 1)) over the state of
        `forward_prefill_dense`, caches updated in place. Returns logits
        (b, V) on the controller's device."""
        out = []
        for d, (rows, caches) in enumerate(zip(
                self._row_blocks(tokens.shape[0]), state)):
            ws = self.shards[d]
            devs = [self.plan.device(d, m) for m in range(len(ws))]
            xs = [w.embed_in(tokens[rows].to(dev))
                  for w, dev in zip(ws, devs)]
            xs, _ = run_stack_tp(self.cfg, [w.layers for w in ws], xs,
                                 self.plan.seam(d), mode="decode",
                                 positions=[pos] * len(ws), caches=caches)
            out.append(ws[0].head(xs[0])[:, 0].to(self.device))
        return torch.cat(out)

    def forward_prefill(self, tokens, backend: str = "auto", *,
                        row_shards=None):
        """`Model.forward_prefill` over the plan: row i of `tokens` (b, s)
        prefills on data shard ``row_shards[i]`` (default 0). Returns
        (last-position logits (b, V) on the controller's device, caches
        merged on the host in row order)."""
        b = tokens.shape[0]
        row_shards = list(row_shards) if row_shards is not None else [0] * b
        logits = [None] * b
        parts = []
        for d in sorted(set(row_shards)):
            rows = [i for i in range(b) if row_shards[i] == d]
            lg, caches = self.prefill(tokens[rows], d, backend=backend)
            for j, i in enumerate(rows):
                logits[i] = lg[j]
            parts.append((rows, caches))
        order = torch.as_tensor([i for rows, _ in parts for i in rows])
        inv = torch.argsort(order)
        merged = []
        for layer in range(len(self.kinds)):
            merged.append({n: torch.cat([c[layer][n] for _, c in parts])[inv]
                           for n in parts[0][1][layer]})
        return torch.stack(logits), merged


def plan_param_bytes(cfg, plan: ServePlan) -> int:
    """Bytes of weights every shard of `plan` holds together, counted from
    the spec (each shard's slice, replicated leaves once per shard)."""
    specs = plan.param_specs(cfg)
    sizes = mesh_axis_sizes(plan.mesh)
    total = 0
    for name, ps in flatten(model_spec(cfg)).items():
        elt = torch.empty((), dtype=getattr(
            torch, ps.dtype or cfg.param_dtype)).element_size()
        div = 1
        for e in specs[name]:
            if e is not None:
                for ax in (e if isinstance(e, tuple) else (e,)):
                    div *= sizes[ax]
        total += math.prod(ps.shape) // div * elt * plan.dp * plan.tp
    return total
