"""Logical-axis -> mesh-axis partitioning rules (FSDP x TP x EP,
pod-aware), the port of ``repro/sharding/partition.py``.

Every parameter, cache and batch leaf carries a tuple of logical axis
names (`models.common.ParamSpec.logical`); the rules engine maps them to
mesh axes with divisibility checks and no mesh axis used twice in one
leaf. Non-divisible cases (36 heads on a 16-way model axis, 40 experts,
kv = 8) fall back to the next candidate or to replication.

The engine is plain Python over axis names and sizes, so it runs on a
deviceless mesh (`launch.mesh.make_abstract_mesh`) as well as on one of
torch devices. A spec is a `P`: one entry per leading dimension (a mesh
axis name, a tuple of them, or None), trailing Nones dropped, equal to
``tuple()`` of the reference's ``PartitionSpec``. `tree_shardings` and
`with_shardings` map a whole state: each leaf's `P` beside a ``meta``
tensor of its logical shape (`train.train_step.abstract_state`,
`ft.elastic.plan_rescale`). The reference's ``constrain`` and
``activation_sharding`` have no counterpart: they ask XLA to place an
activation, and here the training plan (`train.sharding.TrainPlan`)
fixes every activation's shard by construction.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

# candidates per logical axis, in priority order; entries are mesh-axis
# tuples (a tuple means "shard over the product of those axes").
DEFAULT_RULES: dict = {
    "batch": [("pod", "data"), ("data",)],
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "ffn": [("model",)],
    "experts": [("model",)],
    "ssm_inner": [("model",)],
    "ssm_proj": [("model",)],
    "ssm_heads": [("model",)],
    "lru": [("model",)],
    "kv_lora": [("model",)],
    "q_lora": [("model",)],
    "embed": [("pod", "data"), ("data",)],     # FSDP
    "kv_seq": [("model",)],                    # fallback cache sharding
    "seq": [],
    "head_dim": [],
    "layers": [],
    "lru_out": [],
    "capacity": [],
}

# Serving-time rules (`serve.sharding.ServePlan`): inference holds no
# optimizer state worth FSDP-sharding, and the fused decode step cannot
# afford an embedding all-gather per token: embeddings, lm_head and norms
# replicate, only head / ffn dims are tensor-parallel over "model", and
# the decode rows ride "data". "vocab" replicates so that every shard
# sees full logits (sampling needs no collective); "experts" replicates
# because top-k routing is local per token and scores every expert.
SERVE_RULES: dict = {**DEFAULT_RULES,
                     "embed": [],
                     "vocab": [],
                     "experts": [],
                     # SSD in/conv projections replicate: the decode step
                     # computes them at full width and slices the local
                     # head block (B/C channels are shared across heads)
                     "ssm_proj": [],
                     "batch": [("data",)]}

# The per-shard compute layout of a plan (`serve.sharding.ServePlan.
# compute_specs`, the weights the bodies run on, in serving and in
# training): SERVE_RULES with MLA's low-rank latents whole on every shard,
# so that its q / kv norms see the full latent; its heads (wuq, wuk, wuv,
# wo) still split over "model".
COMPUTE_RULES: dict = {**SERVE_RULES, "q_lora": [], "kv_lora": []}

# axes resolved before others (so e.g. kv_heads takes "model" before kv_seq)
PRIORITY = [
    "vocab", "heads", "kv_heads", "ffn", "experts", "ssm_inner", "ssm_heads",
    "lru", "kv_lora", "q_lora", "embed", "batch", "kv_seq",
]


class P(tuple):
    """A partition spec: one entry per leading dimension, a mesh axis
    name, a tuple of names (the product of those axes) or None
    (replicated). A tuple, so it equals ``tuple(jax_partition_spec)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a `launch.mesh.Mesh` or `AbstractMesh`."""
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh, rules: Optional[dict] = None) -> P:
    """The `P` of one leaf: logical axes resolved in `PRIORITY` order,
    each taking its first candidate whose mesh axes exist, are not yet
    used by this leaf, and divide the dimension."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    assign: dict[int, tuple] = {}
    used: set = set()

    def prio(item):
        name = item[1]
        return PRIORITY.index(name) if name in PRIORITY else len(PRIORITY)

    order = sorted(((i, ln) for i, ln in enumerate(logical) if ln),
                   key=prio)
    for i, ln in order:
        for cand in rules.get(ln, []):
            cand = tuple(ax for ax in cand if ax in sizes)
            if not cand or any(ax in used for ax in cand):
                continue
            prod = math.prod(sizes[ax] for ax in cand)
            if shape[i] % prod == 0 and shape[i] >= prod:
                assign[i] = cand
                used.update(cand)
                break
    entries = []
    for i in range(len(shape)):
        if i in assign:
            cand = assign[i]
            entries.append(cand if len(cand) > 1 else cand[0])
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _is_logical(x) -> bool:
    """A tuple of logical axis names (or Nones): a leaf of a logical tree,
    not a node."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(abstract_tree, logical_tree, mesh,
                   rules: Optional[dict] = None):
    """The `P` of every leaf of `abstract_tree` (nested dicts of tensors
    or anything with a ``shape``), from the logical axes at the same path
    of `logical_tree`: the reference's ``tree_shardings``, its
    ``NamedSharding``s as their specs."""
    if _is_logical(logical_tree):
        return spec_for(abstract_tree.shape, logical_tree, mesh, rules)
    return {k: tree_shardings(abstract_tree[k], logical_tree[k], mesh, rules)
            for k in abstract_tree}


class Sharded(NamedTuple):
    """A leaf of `with_shardings`: a ``meta`` tensor of the logical shape
    and dtype, and its `P` on the mesh."""
    meta: torch.Tensor
    spec: P


def with_shardings(abstract_tree, logical_tree, mesh, rules=None):
    """`Sharded` leaves (the reference's ``ShapeDtypeStruct`` with a
    sharding): each leaf of `abstract_tree` as a ``meta`` tensor beside
    its `tree_shardings` spec."""
    if _is_logical(logical_tree):
        a = abstract_tree
        return Sharded(torch.empty(a.shape, dtype=a.dtype, device="meta"),
                       spec_for(a.shape, logical_tree, mesh, rules))
    return {k: with_shardings(abstract_tree[k], logical_tree[k], mesh, rules)
            for k in abstract_tree}


def dp_axes(mesh) -> tuple:
    return tuple(ax for ax in ("pod", "data") if ax in mesh.axis_names)


def batch_logical(cfg, kind: str) -> dict:
    """Logical axes for the input batch of a given step kind."""
    if kind == "train":
        out = {"labels": ("batch", "seq")}
        if cfg.external_embed:
            out["embeds"] = ("batch", "seq", None)
        else:
            out["tokens"] = ("batch", "seq")
        if cfg.n_img_tokens:
            out["image_embeds"] = ("batch", None, None)
        return out
    if kind == "prefill":
        out = {}
        if cfg.external_embed:
            out["embeds"] = ("batch", "seq", None)
        else:
            out["tokens"] = ("batch", "seq")
        if cfg.n_img_tokens:
            out["image_embeds"] = ("batch", None, None)
        return out
    if kind == "decode":
        out = {}
        if cfg.external_embed:
            out["embeds"] = ("batch", None, None)
        else:
            out["tokens"] = ("batch", None)
        return out
    raise ValueError(kind)
