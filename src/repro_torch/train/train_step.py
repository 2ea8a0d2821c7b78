"""Training step: loss, gradients (optionally microbatched) and the AdamW
update — the port of the JAX package's ``repro/train/train_step.py``.

A state is ``{"params": {name: tensor}, "opt": {"step", "m", "v",
"master"}}`` (plus ``"grad_comp"`` with a gradient hook), the params
being the model's own trainable tensors (`Model.train_params`), so the
step updates the model in place. A batch is a dict of tensors on the
model's device: ``labels`` (b, s) and ``tokens`` (b, s) or ``embeds``
(b, s, d), and ``image_embeds`` for a cross-attention config.

On a mesh (`make_train_step(..., mesh=)`) the model is a
`train.sharding.ShardedTrainModel` and every leaf of the state is a
``[d][m]`` list of its shards' slices; the step computes what the
single-device step computes (`train.sharding`). `abstract_state` and
`abstract_batch` give the reference's abstract trees, with each leaf's
`P` on a mesh when one is given.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch.kernels import count
from repro_torch.models.common import flatten, torch_dtype, unflatten
from repro_torch.models.transformer import Model, model_logical, model_spec
from repro_torch.sharding.partition import batch_logical, with_shardings
from repro_torch.train.optimizer import (OptimizerConfig, abstract_opt_state,
                                         adamw_update, global_norm,
                                         init_opt_state, opt_state_logical)
from repro_torch.train.sharding import (ShardedTrainModel, TrainPlan,
                                        init_plan_opt_state)

AUX_LOSS_WEIGHT = 0.01


def cross_entropy(logits, labels):
    """Mean over every position of -log softmax (fp32) at the label, the
    padded last label of each row (the pipeline's 0) counted as the
    reference counts it."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -ll.mean()


def make_loss_fn(model: Model, backend: str = "auto"):
    """loss_fn(batch) -> (total, {"loss", "aux_loss"}), total = loss +
    `AUX_LOSS_WEIGHT` * aux, through ``model.forward_train``."""

    def loss_fn(batch):
        logits, aux = model.forward_train(
            batch.get("tokens"), embeds=batch.get("embeds"),
            image_embeds=batch.get("image_embeds"), backend=backend)
        loss = cross_entropy(logits, batch["labels"])
        total = loss + AUX_LOSS_WEIGHT * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def make_train_step(model, oc: OptimizerConfig, mesh=None,
                    num_microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    backend: str = "auto"):
    """Returns train_step(state, batch) -> (state, metrics), metrics fp32
    scalars on the model's device: total_loss, loss, aux_loss, grad_norm,
    lr. With ``num_microbatches > 1`` the batch splits along its first
    axis, the gradients add up in fp32 and are divided by the count, and
    loss and aux_loss are the last microbatch's, as the reference's
    scan. grad_transform: optional hook ``(grads, state) -> (grads,
    extra_state)`` (e.g. the int8 error-feedback compressor; under a plan
    ``make_error_feedback_compressor(plan)``). A `ShardedTrainModel` (or
    `mesh`, which must then be its plan's) trains over its plan
    (`train.sharding`): microbatch i is the global rows ``[i mb, (i+1)
    mb)`` (the reference's ``slice_mb``), split over the data shards; the
    copies of a replicated slice sum their gradients; the norm counts
    each logical leaf once; each shard updates its slices with the
    global clip scale. A mesh of more than one position with a `Model`
    raises `ValueError`.

    One body serves both: the unsharded state is the plan's layout of
    one shard, ``[[params]]``."""
    if isinstance(model, ShardedTrainModel):
        if mesh is not None and mesh is not model.plan.mesh:
            raise ValueError(f"{model.plan} lays the model on another mesh")
        plan = model.plan
        shards = plan.shards

        def grads_of(params, batch):
            return plan_grads(model, batch, backend)

        reduce, norm = plan.reduce_replicas, plan.global_norms

        def wrap(x):
            return x

        unwrap = wrap
    else:
        if TrainPlan.from_mesh(mesh, model.cfg) is not None:
            raise ValueError("a mesh of more than one position trains a "
                             "ShardedTrainModel(cfg, TrainPlan(mesh, cfg))")
        loss_fn = make_loss_fn(model, backend)
        plan, shards = None, [(0, 0)]

        def grads_of(params, batch):
            total, mets = loss_fn(batch)
            grads = torch.autograd.grad(total, list(params[0][0].values()))
            mets = {k: v.detach() for k, v in mets.items()}
            return total.detach(), mets, [[dict(zip(params[0][0], grads))]]

        def reduce(grads):
            return None

        def norm(grads):
            return [[global_norm(grads[0][0])]]

        def wrap(x):
            return [[x]]

        def unwrap(x):
            return x[0][0]

    def compute_grads(params, batch):
        rows = next(iter(batch.values())).shape[0]
        if plan is not None and rows % (plan.dp * num_microbatches):
            raise ValueError(
                f"global batch {rows} does not divide over {plan.dp} data "
                f"shards x {num_microbatches} microbatches")
        if num_microbatches <= 1:
            total, mets, grads = grads_of(params, batch)
            reduce(grads)
            return total, mets, grads
        mb = rows // num_microbatches
        acc = [[{} for _ in row] for row in params]
        for d, m in shards:
            with count.at((d, m)):
                acc[d][m] = {n: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for n, p in params[d][m].items()}
        tot = 0.0
        for i in range(num_microbatches):
            t, mets, g = grads_of(params, {k: x[i * mb:(i + 1) * mb]
                                           for k, x in batch.items()})
            for d, m in shards:
                with count.at((d, m)):
                    for n in acc[d][m]:
                        acc[d][m][n] = acc[d][m][n] + g[d][m][n]
            tot = tot + t if t is not None else tot
        reduce(acc)
        grads = [[{} for _ in row] for row in acc]
        for d, m in shards:
            with count.at((d, m)):
                grads[d][m] = {n: g / num_microbatches
                               for n, g in acc[d][m].items()}
        return tot / num_microbatches, mets, grads

    def train_step(state, batch):
        params, opt = wrap(state["params"]), wrap(state["opt"])
        if plan is not None:
            plan.tag_state(params)
            plan.tag_state(opt)
        total, mets, grads = compute_grads(params, batch)
        comp_state = state.get("grad_comp")
        if grad_transform is not None:
            grads, comp_state = grad_transform(unwrap(grads), comp_state)
            grads = wrap(grads)
        gnorms = norm(grads)
        lr = None
        for d, m in shards:
            with count.at((d, m)):
                _, opt[d][m], opt_mets = adamw_update(
                    params[d][m], grads[d][m], opt[d][m], oc,
                    gnorm=gnorms[d][m].to(opt[d][m]["step"].device))
            if lr is None:
                lr = opt_mets["lr"]
        gnorm = gnorms[shards[0][0]][shards[0][1]]
        new_state = {"params": unwrap(params), "opt": unwrap(opt)}
        if comp_state is not None:
            new_state["grad_comp"] = comp_state
        metrics = {"total_loss": total, **mets, "grad_norm": gnorm,
                   "lr": lr}
        return new_state, metrics

    return train_step


def plan_grads(model: ShardedTrainModel, batch: dict,
               backend: str = "auto"):
    """The loss of a batch of global rows over a plan and the gradient of
    every storage slice: (total, {"loss", "aux_loss"}, ``[d][m] -> {name:
    gradient}``), each copy of a replicated slice holding only what its
    own compute shards gave it (`TrainPlan.reduce_replicas` sums them).
    A slice no compute shard read (a replicated norm beside the one model
    shard 0 uses) gets zeros.

    Under a cost counter the gathers' backward adds each block's gradient
    into the plan's buffer (`train.sharding._Gather`), and each gradient
    is marked as its position's. A one-position count
    (``count_positions``) starts the backward where each position's work
    leaves it: the loss at (0, 0); the loss and MoE-statistics sums a
    data shard's model shard 0 hands on; the last tensor-parallel sum of
    any other model shard; each with a ``meta`` stand-in gradient."""
    plan = model.plan
    counting = count.active() is not None
    # under a counter every remat segment recomputes whole (the flag is
    # taken when the segment runs forward), so that each position's
    # recompute is the same whichever positions run
    with set_checkpoint_early_stop(not counting):
        loss, aux = model.loss(batch, cross_entropy, backend)
    total = None
    if loss is not None:
        with count.at((0, 0)):
            total = loss + AUX_LOSS_WEIGHT * aux
    # one backward thread: with shards on distinct cards the engine would
    # run each card's nodes on a thread of its own, and two of them would
    # unpack one remat segment's saved tensors at once (the segment spans
    # a row's cards; `torch.utils.checkpoint` recomputes it unlocked)
    if not counting:
        with torch.autograd.set_multithreading_enabled(False):
            gs = iter(torch.autograd.grad(total, model.leaves(),
                                          allow_unused=True,
                                          materialize_grads=True))
        grads = [[{n: next(gs) for n in model.shards[d][m]}
                  for m in range(plan.tp)] for d in range(plan.dp)]
        return total.detach(), {"loss": loss.detach(),
                                "aux_loss": aux.detach()}, grads
    roots, outs = ([total], [None]) if total is not None else ([], [])
    inputs = model.leaves()
    if plan.stand_in:
        for kind, t in model._roots:
            if kind == "input":
                inputs.append(t)
            elif t.requires_grad:
                roots.append(t)
                with count.hidden():
                    outs.append(torch.empty_like(t))
    plan.grad_buffer = {p: {} for p in plan.shards}
    try:
        with torch.autograd.set_multithreading_enabled(False):
            if roots:
                torch.autograd.grad(roots, inputs, outs, allow_unused=True)
        buf = plan.grad_buffer
    finally:
        plan.grad_buffer = None
    grads = [[{} for _ in range(plan.tp)] for _ in range(plan.dp)]
    for d, m in plan.shards:
        with count.hidden():
            grads[d][m] = {n: buf[(d, m)].get(n) if buf[(d, m)].get(n)
                           is not None else torch.zeros_like(t)
                           for n, t in model.shards[d][m].items()}
        count.tag(grads[d][m], (d, m))
    if total is None:
        return None, {"loss": None, "aux_loss": None}, grads
    return total.detach(), {"loss": loss.detach(),
                            "aux_loss": aux.detach()}, grads


def init_state(model, oc: OptimizerConfig) -> dict:
    """The model's weights, made trainable, and a fresh optimizer state
    (a `ShardedTrainModel`'s: ``[d][m]`` lists of its shards')."""
    params = model.train_params()
    if isinstance(model, ShardedTrainModel):
        return {"params": params, "opt": init_plan_opt_state(params, oc)}
    return {"params": params, "opt": init_opt_state(params, oc)}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_state(model, oc: OptimizerConfig, mesh=None,
                   rules=None) -> dict:
    """`init_state`'s logical structure, shapes and dtypes as ``meta``
    tensors (no storage): a restore template. With `mesh`, each leaf is a
    `partition.Sharded` (the meta tensor beside its `P` by `rules`,
    default `DEFAULT_RULES`), as the reference's ``abstract_state``.
    `model` is a `Model`, a `ShardedTrainModel` or a config."""
    cfg = getattr(model, "cfg", model)
    params = {n: _meta(ps.shape, torch_dtype(ps.dtype or cfg.param_dtype))
              for n, ps in flatten(model_spec(cfg)).items()}
    abstract = {"params": params, "opt": abstract_opt_state(params, oc)}
    if mesh is None:
        return abstract
    logical = model_logical(cfg)
    return with_shardings(abstract, {"params": logical,
                                     "opt": opt_state_logical(logical, oc)},
                          mesh, rules)


def abstract_batch(model, seq: int, global_batch: int, mesh=None,
                   kind: str = "train", rules=None) -> dict:
    """``meta`` tensors for a step's batch, as the reference's
    ``abstract_batch``: tokens (int32) or an external-embedding config's
    embeds, labels for training, image embeddings for a cross-attention
    config outside decode; with `mesh`, `partition.Sharded` leaves by
    `partition.batch_logical`."""
    cfg = getattr(model, "cfg", model)
    out = {}
    if kind == "train":
        out["labels"] = _meta((global_batch, seq), torch.int32)
    s_in = 1 if kind == "decode" else seq
    act = torch_dtype(cfg.compute_dtype)
    if cfg.external_embed:
        out["embeds"] = _meta((global_batch, s_in, cfg.d_model), act)
    else:
        out["tokens"] = _meta((global_batch, s_in), torch.int32)
    if cfg.n_img_tokens and kind != "decode":
        out["image_embeds"] = _meta((global_batch, cfg.n_img_tokens,
                                     cfg.d_model), act)
    if mesh is None:
        return out
    return with_shardings(out, batch_logical(cfg, kind), mesh, rules)


def state_tree(state: dict) -> dict:
    """A state as plain nested dicts, every flat name split at its dots:
    the reference's pytree, as the checkpointer takes it."""
    return unflatten(flatten(state))


def state_from_tree(tree: dict) -> dict:
    """`state_tree`'s inverse for ``params`` and ``opt``: the params and
    the optimizer's m, v and master as flat ``{name: tensor}`` dicts."""
    return {"params": flatten(tree["params"]),
            "opt": {k: flatten(v) if isinstance(v, dict) else v
                    for k, v in tree["opt"].items()}}
