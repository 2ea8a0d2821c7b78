"""int8 error-feedback gradient compression — the port of the JAX
package's ``repro/train/grad_compression.py``.

Two pieces, as in the reference:

1. ``make_error_feedback_compressor`` — a ``grad_transform`` hook for
   `repro_torch.train.train_step.make_train_step`: each gradient leaf
   (plus the residual carried from the last step) is quantized to int8
   with one symmetric per-leaf scale, the dequantized value replaces the
   gradient and what quantization lost carries to the next step (error
   feedback keeps SGD unbiased in the long run). Under a training plan
   (``plan=``) the leaves are the shards' slices and the scale is that of
   the logical leaf: ``max |x|`` over every slice of it, as the reference
   quantizes the logical gradient.
2. ``compressed_psum`` — the wire-level form: over the shards of one mesh
   axis, each part goes out as int8 plus one fp32 scale (about a quarter
   of an fp32 all-reduce's bytes), and every shard sums the dequantized
   parts. On one device the gather is the list of parts itself; over
   distinct cards it is an NCCL all-gather of the int8 parts and scales.
"""
from __future__ import annotations

import torch


def quantize_int8(x, amax=None):
    """Symmetric int8 with one scale: ``(q int8, scale fp32 scalar)``,
    scale ``amax / 127`` (1 for an all-zero x); `amax` defaults to
    ``max |x|``."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _compress(g, resid, amax=None):
    """One leaf: (the dequantized ``g + resid`` in g's dtype, the new fp32
    residual)."""
    total = g.to(torch.float32) + resid
    q, scale = quantize_int8(total, amax)
    deq = dequantize_int8(q, scale)
    return deq.to(g.dtype), total - deq


def make_error_feedback_compressor(plan=None):
    """grad_transform(grads, state) -> (compressed grads, new state), over
    flat ``{name: tensor}`` dicts; the state is the fp32 residual. With a
    `train.sharding.TrainPlan`, grads and state are per-shard lists
    (``[d][m] -> {name: tensor}``) and each leaf's scale is its logical
    leaf's (`TrainPlan.leaf_amax`)."""

    def zeros(grads):
        return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for n, g in grads.items()}

    def transform(grads: dict, state):
        if state is None:
            state = zeros(grads)
        new_g, new_state = {}, {}
        for name, g in grads.items():
            new_g[name], new_state[name] = _compress(g, state[name])
        return new_g, new_state

    def transform_plan(grads: list, state):
        shards = [(d, m) for d in range(plan.dp) for m in range(plan.tp)]
        if state is None:
            state = [[zeros(g) for g in row] for row in grads]
        new_g = [[{} for _ in row] for row in grads]
        new_state = [[{} for _ in row] for row in grads]
        for name in grads[0][0]:
            totals = [grads[d][m][name].to(torch.float32)
                      + state[d][m][name] for d, m in shards]
            amaxes = plan.leaf_amax(totals)
            for (d, m), amax in zip(shards, amaxes):
                new_g[d][m][name], new_state[d][m][name] = _compress(
                    grads[d][m][name], state[d][m][name], amax)
        return new_g, new_state

    return transform if plan is None else transform_plan


def _all_gather(parts: list) -> list:
    """Every part on every part's device: ``out[i]`` is the list of all
    parts on part i's device. Parts on one device are the list itself;
    on distinct CUDA devices one NCCL all-gather."""
    devs = {p.device for p in parts}
    if len(devs) == 1:
        return [list(parts)] * len(parts)
    if len(devs) != len(parts):
        raise ValueError(f"gather over devices {devs}: parts must share "
                         f"one device or each have their own")
    from torch.cuda import nccl
    n = len(parts)
    ins = [p.contiguous().reshape(-1) for p in parts]
    outs = [torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
            for x in ins]
    nccl.all_gather(ins, outs)
    return [list(o.view(n, *parts[0].shape).unbind(0)) for o in outs]


def compressed_psum(parts: list) -> list:
    """The sum over one mesh axis with int8 on the wire: ``parts`` holds
    each shard's tensor; every shard quantizes its part with its own
    scale, gathers the int8 parts and the scales, and sums ``scale_i *
    q_i`` in shard order. Returns one fp32 sum per shard, on its
    device."""
    qs, scales = zip(*(quantize_int8(p) for p in parts))
    out = []
    for q_all, s_all in zip(_all_gather(list(qs)), _all_gather(list(scales))):
        total = s_all[0] * q_all[0].to(torch.float32)
        for s, q in zip(s_all[1:], q_all[1:]):
            total = total + s * q.to(torch.float32)
        out.append(total)
    return out


def data_parallel_mean_compressed(grads: list, mesh, axis: str = "data"):
    """The compressed data-parallel mean: ``grads`` holds one flat
    ``{name: tensor}`` dict per shard of `mesh`'s `axis` (the reference's
    replicated gradient tree, one copy a shard); each leaf is
    `compressed_psum` over the shards divided by their count. Returns one
    dict per shard."""
    n = dict(zip(mesh.axis_names, mesh.axis_sizes))[axis]
    if len(grads) != n:
        raise ValueError(f"{len(grads)} gradient trees for the {n} shards "
                         f"of mesh axis {axis!r}")
    out = [{} for _ in grads]
    for name in grads[0]:
        for i, s in enumerate(compressed_psum([g[name] for g in grads])):
            out[i][name] = s / n
    return out
