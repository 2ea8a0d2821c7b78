"""A training job: the program's train step over batches of the mix's
size, for as long as the window lasts.

Set-up builds one training state, the program's `Model` over the
benchmark's weights with ``make_train_step`` (the `Trainer`'s step: its
loss, the gradients through the layers' kernels and their autograd
functions, remat as the configuration states, AdamW with fp32 master
weights), and drives it through its first ``check_steps`` steps, which
also warm every shape. The readings the check needs are taken from them:
each step's loss, each leaf's norm of the first gradient as the
optimizer gets it (its first moment over ``1 - beta1`` after one step),
and each leaf's norm of the master weights' change after the last. The
same state then runs the window: steps over fresh batches, each step
closed by reading its loss (as the `Trainer` does), until the first step
boundary past ``--seconds``. Batches are token ids drawn on the card
from the seed, every row different; labels are the next tokens.

After the window the program's state is freed and the plain reference
runs the same first steps from the same weights and batches in fp32.
"""
from __future__ import annotations

import gc
import time

import torch

from perfbench.lib import harness, program, spec, trace, work
from perfbench.reference import adamw, plain


def batch(seed: int, step: int, b: int, s: int, vocab: int, device):
    gen = plain.generator(seed, device, 1000 + step)
    t = torch.randint(0, vocab, (b, s + 1), generator=gen, device=device,
                      dtype=torch.int64)
    return {"tokens": t[:, :-1].to(torch.int32).contiguous(),
            "labels": t[:, 1:].to(torch.int32).contiguous()}


def leaf_norms(tree: dict) -> dict:
    """``{name: fp32 norm}`` read to the host in one transfer."""
    names = list(tree)
    norms = torch.stack([torch.linalg.vector_norm(tree[n].float())
                         for n in names]).tolist()
    return dict(zip(names, norms))


def worst_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    names = [n for n in ref if keep is None or n in keep]
    med = work.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def program_steps(ctx, cfg, weights, oc, n: int):
    """The program's state after `n` steps, and the readings."""
    from repro_torch.models.transformer import Model
    from repro_torch.train import train_step as ts
    mix = ctx.mix
    model = Model(cfg, device=ctx.device,
                  state={k: v.clone() for k, v in weights.items()})
    step_fn = ts.make_train_step(model, oc,
                                 num_microbatches=mix["microbatches"])
    st = ts.init_state(model, oc)
    losses, grad0 = [], None
    for s in range(n):
        st, mets = step_fn(st, batch(ctx.seed, s, mix["batch"],
                                     mix["seq_len"], cfg.vocab_size,
                                     ctx.device))
        losses.append(float(mets["loss"]))
        if s == 0:
            grad0 = {k: v / (1 - oc.beta1) for k, v in
                     leaf_norms(st["opt"]["m"]).items()}
    change = leaf_norms({k: st["opt"]["master"][k] - weights[k].float()
                         for k in weights})
    return model, step_fn, st, {"loss": losses, "grad": grad0,
                                "change": change}


def reference_steps(ctx, weights, n: int, prec: str = "fp32") -> dict:
    c, mix = ctx.config, ctx.mix
    ref = spec.reference_module(c["reference"])
    master = {k: v.float().clone().requires_grad_(True)
              for k, v in weights.items()}
    opt = adamw.AdamW(master, mix["optimizer"])
    losses, grad0 = [], None
    for s in range(n):
        b = batch(ctx.seed, s, mix["batch"], mix["seq_len"],
                  c["vocab_size"], ctx.device)
        loss, grads = ref.loss_and_grads(c, master, b["tokens"],
                                         b["labels"], prec)
        opt.update(grads)
        losses.append(loss)
        if s == 0:
            grad0 = {k: v / (1 - opt.o["beta1"]) for k, v in
                     leaf_norms(opt.m).items()}
        del grads
    with torch.no_grad():
        change = leaf_norms({k: master[k] - weights[k].float()
                             for k in weights})
    return {"loss": losses, "grad": grad0, "change": change}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers the check compares: the worst step's loss gap over
    the reference's loss, and the worst leaf's gaps of the first
    gradient's norm and of the change's norm. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by
    round-off alone under Adam and are left out of the change."""
    med = work.median(ref["grad"].values())
    moved = {n for n, g in ref["grad"].items() if g >= 1e-3 * med}
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(prog["loss"], ref["loss"])),
            "grad_gap": worst_gap(prog["grad"], ref["grad"]),
            "change_gap": worst_gap(prog["change"], ref["change"], moved)}


def run(ctx) -> harness.Result:
    from repro_torch.train.optimizer import OptimizerConfig
    c, mix = ctx.config, ctx.mix
    cfg = program.model_config(c)
    ref = spec.reference_module(c["reference"])
    weights = ref.weights(c, ctx.seed, ctx.device)
    oc = OptimizerConfig(**mix["optimizer"])
    n0 = mix["check_steps"]
    model, step_fn, st, readings = program_steps(ctx, cfg, weights, oc, n0)
    b, s = mix["batch"], mix["seq_len"]
    prof = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    calls = program.KernelCalls({"ssd_scan": program.ssd_scan_args}) \
        if ctx.trace else None
    window = program.span("bench.window", ctx.trace)
    program.sync(ctx.device)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    steps = 0
    if calls is not None:
        calls.__enter__()
        calls.on = True
    with window:
        while True:
            bt = batch(ctx.seed, n0 + steps, b, s, cfg.vocab_size,
                       ctx.device)
            with program.span("bench.train_step", ctx.trace):
                st, mets = step_fn(st, bt)
                float(mets["loss"])
            steps += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    t1 = time.perf_counter()
    if calls is not None:
        calls.on = False
        calls.__exit__(None, None, None)
    if prof is not None:
        prof.__exit__(None, None, None)
    device = program.device_block(ctx.device)
    del model, step_fn, st, mets
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    tokens = steps * b * s
    metrics = {"train_tok_s": tokens / (t1 - t0), "setup_s": setup_s}
    record, breakdown = None, None
    if prof is not None:
        tr = trace.reduce(prof)
        flops = 3 * work.forward_flops(c, tokens)
        record = {"trace": tr, "kind": device["kind"], "config": c,
                  "calls": calls.calls(), "steps": steps, "flops": flops,
                  "window_s": t1 - t0}
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tr.breakdown()
        del prof
    truth = reference_steps(ctx, weights, n0)
    got = compare(readings, truth)
    # a number whose limits file gives no limit is read, not compared
    checks = [(k, v, ctx.limits[k]["limit"] if k in ctx.limits else 0.0)
              for k, v in got.items()]
    control = compare(reference_steps(ctx, weights, n0, "fp8"), truth) \
        if ctx.control else None
    return harness.Result(attempted=n0 + steps, failed=0, metrics=metrics,
                          checks=checks, device=device, record=record,
                          breakdown=breakdown, control=control)
