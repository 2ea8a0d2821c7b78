"""AdamW with fp32 master weights and moments — the port of the JAX
package's ``repro/train/optimizer.py``.

Parameters, gradients and every optimizer leaf are flat ``{name:
tensor}`` dicts over the model's parameter names. The arithmetic is the
reference's, step for step and in its order: the clip scale from the
fp32 global norm, then per leaf ``m = b1 m + (1 - b1) g``, ``v = b2 v +
(1 - b2) g g``, the bias-corrected ``mh``, ``vh``, and ``pm - lr (mh /
(sqrt(vh) + eps) + wd pm)``, each product and sum rounded to fp32 where
the reference rounds it (``torch.optim.AdamW`` applies its decoupled
decay in another order). The schedule (linear warmup, then cosine to a
tenth) is computed on the step counter's device, in fp32, so a step
reads nothing back to the host. Updates are in place: the master, the
moments and the parameters keep their storage.

Under a training plan (`train.sharding`) every optimizer leaf takes its
parameter's logical axes (`opt_state_logical`), so it is sharded as the
parameter is (ZeRO-style); each shard updates its slices with the clip
scale of the global norm, which the plan computes over each logical leaf
once and passes in.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    use_master: bool = True


def lr_at(oc: OptimizerConfig, step):
    """The learning rate at `step` (an int32 tensor), an fp32 tensor."""
    step = step.to(torch.float32)
    warm = oc.lr * (step + 1) / max(oc.warmup_steps, 1)
    t = torch.clamp((step - oc.warmup_steps) /
                    max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = oc.lr * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < oc.warmup_steps, warm, cos)


def init_opt_state(params: dict, oc: OptimizerConfig) -> dict:
    """``{"step": int32 scalar, "m", "v"[, "master"]}``, each of the last
    three a flat dict of fp32 tensors beside `params`; the master is a
    copy even where a parameter is already fp32."""
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = next(iter(params.values())).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "m": {n: f32(p) for n, p in params.items()},
             "v": {n: f32(p) for n, p in params.items()}}
    if oc.use_master:
        state["master"] = {n: p.detach().to(torch.float32, copy=True)
                           for n, p in params.items()}
    return state


def abstract_opt_state(abstract_params: dict, oc: OptimizerConfig) -> dict:
    """`init_opt_state`'s structure, shapes and dtypes over flat ``{name:
    tensor}`` params (any device, ``meta`` included) as ``meta``
    tensors."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    state = {"step": torch.empty((), dtype=torch.int32, device="meta"),
             "m": {n: f32(p) for n, p in abstract_params.items()},
             "v": {n: f32(p) for n, p in abstract_params.items()}}
    if oc.use_master:
        state["master"] = {n: f32(p) for n, p in abstract_params.items()}
    return state


def opt_state_logical(params_logical: dict, oc: OptimizerConfig) -> dict:
    """The logical axes of the optimizer state: each moment and master
    leaf its parameter's, the step none."""
    state = {"step": (), "m": dict(params_logical),
             "v": dict(params_logical)}
    if oc.use_master:
        state["master"] = dict(params_logical)
    return state


def global_norm(tree: dict):
    """sqrt of the sum over leaves (in name order) of each leaf's fp32
    sum of squares."""
    total = 0.0
    for g in tree.values():
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict,
                 oc: OptimizerConfig, gnorm=None):
    """One AdamW step, in place: `params`, and the ``m``, ``v`` and
    ``master`` leaves of `opt_state`, are updated where they lie and
    ``opt_state["step"]`` is replaced by ``step + 1``. `gnorm` is the
    global gradient norm when `grads` are one shard's slices of a larger
    state (default: `global_norm` of `grads`). Returns (params,
    opt_state, metrics) with metrics ``{"grad_norm", "lr"}`` as fp32
    tensors on the state's device."""
    step = opt_state["step"]
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(oc.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(oc, step)
    b1, b2 = oc.beta1, oc.beta2
    stepf = step.to(torch.float32) + 1
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    master = opt_state.get("master")
    for name, p in params.items():
        # the reference's expressions, each rounding where it rounds, with
        # at most three leaf-sized temporaries alive at once
        g = grads[name].to(torch.float32) * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        gg = (1 - b2) * g
        v.mul_(b2).add_(gg.mul_(g))
        del g, gg
        upd = torch.div(v, bc2).sqrt_().add_(oc.eps)     # sqrt(vh) + eps
        upd = torch.div(m, bc1).div_(upd)                # mh / that
        pm = master[name] if master is not None \
            else p.detach().to(torch.float32, copy=True)
        upd.add_(oc.weight_decay * pm)
        pm.sub_(upd.mul_(lr))
        p.copy_(pm)
    opt_state["step"] = step + 1
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
