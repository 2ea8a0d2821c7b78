"""Elastic scaling plan: map a checkpoint taken on one mesh onto another —
the port of ``repro/ft/elastic.py``.

Checkpoints store logical (unsharded) leaves, so restoring onto a new
mesh is slicing each leaf into the new plan's shards (`train.trainer`).
This module adds the planning layer: the state's `P` on a target mesh
(`DEFAULT_RULES`, as `train.sharding.TrainPlan` stores it), the bytes
each device then holds, and whether they fit its memory. As the
reference's, the verdict is memory's alone: the plan lays out every
config on every ("data", "model") mesh.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.roofline import H100_SXM
from repro_torch.models.transformer import model_logical
from repro_torch.sharding.partition import mesh_axis_sizes, tree_shardings
from repro_torch.train.optimizer import OptimizerConfig, opt_state_logical
from repro_torch.train.train_step import abstract_state

# the budget of one device: an H100's memory as the card reports it
# (`torch.cuda.get_device_properties(0).total_memory`, 85,017,493,504
# bytes; `core.roofline.H100_SXM`). The reference's default is a TPU's
# 16 GiB of HBM
HBM_BYTES = int(H100_SXM.hbm_gib * 2 ** 30)


@dataclasses.dataclass
class ElasticPlan:
    ok: bool
    reasons: list
    shardings: object | None
    bytes_per_device: int


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def plan_rescale(model, oc: OptimizerConfig, mesh,
                 hbm_bytes: int = HBM_BYTES) -> ElasticPlan:
    """The training state of `model` (a `Model`, a
    `train.sharding.ShardedTrainModel` or a config) on `mesh` (devices or
    an `AbstractMesh`): ``shardings`` the `P` of every leaf of
    `abstract_state`, ``bytes_per_device`` the params, m, v, master and
    step one device holds (each leaf's bytes over its shard factor), not
    ok when that passes `hbm_bytes`."""
    cfg = getattr(model, "cfg", model)
    reasons = []
    abstract = abstract_state(cfg, oc)
    logical = model_logical(cfg)
    shardings = tree_shardings(abstract, {
        "params": logical, "opt": opt_state_logical(logical, oc)}, mesh)
    sizes = mesh_axis_sizes(mesh)
    total = 0
    for leaf, spec in zip(_leaves(abstract), _leaves(shardings)):
        nbytes = math.prod(leaf.shape) * leaf.element_size()
        factor = 1
        for entry in spec:
            if entry is not None:
                for ax in (entry if isinstance(entry, tuple) else (entry,)):
                    factor *= sizes[ax]
        total += nbytes // factor
    if total > hbm_bytes:
        reasons.append(f"state {total / 2 ** 30:.1f} GiB/device exceeds HBM "
                       f"budget {hbm_bytes / 2 ** 30:.0f} GiB")
    return ElasticPlan(not reasons, reasons, shardings, total)
