"""Training step: loss, gradients (optionally microbatched) and the AdamW
update — the port of the JAX package's ``repro/train/train_step.py`` at
one device (no mesh: the sharded abstract state waits for one).

A state is ``{"params": {name: tensor}, "opt": {"step", "m", "v",
"master"}}`` (plus ``"grad_comp"`` with a gradient hook), the params
being the model's own trainable tensors (`Model.train_params`), so the
step updates the model in place. A batch is a dict of tensors on the
model's device: ``labels`` (b, s) and ``tokens`` (b, s) or ``embeds``
(b, s, d), and ``image_embeds`` for a cross-attention config.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import flatten, unflatten
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)

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


def make_train_step(model: Model, oc: OptimizerConfig,
                    num_microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    backend: str = "auto"):
    """Returns train_step(state, batch) -> (state, metrics), metrics fp32
    scalars on the model's device: total_loss, loss, aux_loss, grad_norm,
    lr. With ``num_microbatches > 1`` the batch splits along its first
    axis, the gradients add up in fp32 and are divided by the count, and
    loss and aux_loss are the last microbatch's, as the reference's
    scan. grad_transform: optional hook ``(grads, state) -> (grads,
    extra_state)`` (e.g. the int8 error-feedback compressor)."""
    loss_fn = make_loss_fn(model, backend)

    def grads_of(params, batch):
        total, mets = loss_fn(batch)
        grads = torch.autograd.grad(total, list(params.values()))
        mets = {k: v.detach() for k, v in mets.items()}
        return total.detach(), mets, dict(zip(params, grads))

    def compute_grads(params, batch):
        if num_microbatches <= 1:
            return grads_of(params, batch)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
        tot = 0.0
        for i in range(num_microbatches):
            mbatch = {}
            for k, x in batch.items():
                mb = x.shape[0] // num_microbatches
                mbatch[k] = x[i * mb:(i + 1) * mb]
            t, mets, g = grads_of(params, mbatch)
            for n in acc:
                acc[n] = acc[n] + g[n]
            tot = tot + t
        grads = {n: g / num_microbatches for n, g in acc.items()}
        return tot / num_microbatches, mets, grads

    def train_step(state, batch):
        params = state["params"]
        total, mets, grads = compute_grads(params, batch)
        comp_state = state.get("grad_comp")
        if grad_transform is not None:
            grads, comp_state = grad_transform(grads, comp_state)
        new_params, new_opt, opt_mets = adamw_update(params, grads,
                                                     state["opt"], oc)
        new_state = {"params": new_params, "opt": new_opt}
        if comp_state is not None:
            new_state["grad_comp"] = comp_state
        metrics = {"total_loss": total, **mets, **opt_mets}
        return new_state, metrics

    return train_step


def init_state(model: Model, oc: OptimizerConfig) -> dict:
    """The model's weights, made trainable, and a fresh optimizer state."""
    params = model.train_params()
    return {"params": params, "opt": init_opt_state(params, oc)}


def abstract_state(model: Model, oc: OptimizerConfig) -> dict:
    """`init_state`'s structure, shapes and dtypes as tensors on the
    ``meta`` device (no storage): a restore template."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    params = {n: meta(p.shape, p.dtype)
              for n, p in flatten(model.params).items()}
    f32 = {n: meta(p.shape, torch.float32) for n, p in params.items()}
    opt = {"step": meta((), torch.int32), "m": f32, "v": dict(f32)}
    if oc.use_master:
        opt["master"] = dict(f32)
    return {"params": params, "opt": opt}


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
