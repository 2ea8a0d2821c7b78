"""Decoder stack over the reference's parameter layout: every mixer of the
JAX package — global (ATTN) and sliding-window (LOCAL_ATTN) attention,
cross-attention (CROSS_ATTN), multi-head latent attention (MLA), Mamba2
SSD and RG-LRU — with dense or mixture-of-experts MLPs or none, token or
external (frame) embeddings.

Parameters keep the JAX package's pytree (``repro/models/transformer.py``):
``groups`` leaves carry a leading ``n_groups`` stack axis (one entry per
period of the layer pattern) and a non-divisible remainder lives under
``tail`` per layer, so ``state_dict()`` names read ``groups.l0.attn.wq``
exactly like the reference's pytree paths and `repro_torch.convert`
carries params over leaf for leaf. PyTorch runs eagerly, so the stack is
a Python loop over per-layer views of the stacked leaves.

`Model.forward_train` is the reference's training forward: the views are
taken inside each call, so that under autograd every view records its
slice of the stacked parameter (views made before ``requires_grad`` was
set carry no ``grad_fn``, and their gradient would be lost), and each
layer group runs under ``torch.utils.checkpoint`` when the config asks
for remat, as the reference's ``jax.checkpoint`` of its scan body. Its
body, `train_stack_tp`, takes per-shard lists like the serving bodies:
the training plan (`train.sharding`) runs it over a mesh's model axis.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, CROSS_ATTN, LOCAL_ATTN, MLA,
                                      MLP_DENSE, MLP_MOE, MLP_NONE, RGLRU,
                                      SSD, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (as_seam, flatten, materialize,
                                       psum_one, stack_specs, torch_dtype,
                                       unflatten)
from repro_torch.models.layers import (embed_apply, embed_spec, lm_head_apply,
                                       mlp_apply, mlp_spec, norm_spec,
                                       rms_norm)


def layer_spec(cfg: ModelConfig, mixer: str, mlp: str):
    d = cfg.d_model
    s = {"norm1": norm_spec(d)}
    if mixer in (ATTN, LOCAL_ATTN):
        s["attn"] = attn.attn_spec(cfg)
    elif mixer == CROSS_ATTN:
        s["attn"] = attn.attn_spec(cfg, cross=True)
    elif mixer == MLA:
        s["mla"] = attn.mla_spec(cfg)
    elif mixer == SSD:
        s["ssm"] = ssm_mod.ssm_spec(cfg)
    elif mixer == RGLRU:
        s["rglru"] = rglru_mod.rglru_spec(cfg)
    else:
        raise ValueError(mixer)
    if mlp == MLP_DENSE:
        s["norm2"] = norm_spec(d)
        s["mlp"] = mlp_spec(cfg)
    elif mlp == MLP_MOE:
        s["norm2"] = norm_spec(d)
        s["moe"] = moe_mod.moe_spec(cfg)
    return s


def mlp_tail_tp(cfg: ModelConfig, kind, ps, xs, psum):
    """Post-mixer half of a layer over a plan's model axis (norm2 + dense
    or MoE MLP residual, the MLP output tanh-gated on a cross layer;
    nothing for MLP_NONE): ``ps`` and ``xs`` hold one entry per model
    shard. A dense MLP's up / down projections are ffn-sharded, so the
    down projection emits a partial sum that one reduction completes; MoE
    subtrees replicate, so every shard runs the whole expert stack.
    Returns (xs, aux): aux the MoE layer's load-balancing statistics
    ``(me, ce)`` (`moe.moe_stats`, model shard 0's), None for other
    MLPs; training turns them into its loss (`moe.balance_loss`), serving
    drops them, as the reference's serving does. When the model axis does
    not divide ``d_ff`` every shard runs the whole MLP (`Seam.local`)."""
    mixer, mlp = kind[0], kind[1]
    if mlp == MLP_NONE:
        return xs, None
    psum = as_seam(psum, len(ps))
    if mlp == MLP_DENSE and psum.size > 1 and \
            ps[0]["mlp"]["up"].shape[-1] == cfg.d_ff:
        psum = psum.local()
    hs = psum.gather_seq([rms_norm(x, p["norm2"]) for p, x in zip(ps, xs)])
    aux = None
    if mlp == MLP_MOE:
        outs = [moe_mod.moe_stats(cfg, p["moe"], h) for p, h in zip(ps, hs)]
        ys, aux = psum.local().out([y for y, _, _ in outs]), outs[0][1:]
    else:
        ys = psum.out([mlp_apply(cfg, p["mlp"], h) for p, h in zip(ps, hs)])
    if mixer == CROSS_ATTN:
        ys = [torch.tanh(p["attn"]["gate_ffn"]).to(y.dtype) * y
              for p, y in zip(ps, ys)]
    return [x + y for x, y in zip(xs, ys)], aux


def mlp_tail(cfg: ModelConfig, kind, p, x):
    """`mlp_tail_tp` on one shard — shared by the dense stack and the
    serve layer's fused paged decode step. Returns (x, aux)."""
    xs, aux = mlp_tail_tp(cfg, kind, [p], [x], psum_one)
    return xs[0], aux


def _whole_heads(cfg: ModelConfig, kind, p) -> bool:
    """True when a shard's attention or MLA params hold every head: the
    model axis does not divide them, and the mixer runs whole."""
    mixer = kind[0]
    if mixer == MLA:
        return p["mla"]["wuq"].shape[-2] == cfg.num_heads
    if mixer in (ATTN, LOCAL_ATTN, CROSS_ATTN):
        return p["attn"]["wq"].shape[-2] == cfg.num_heads
    return False


def mixer_apply_tp(cfg: ModelConfig, kind, ps, hs, psum, *, mode,
                   positions, caches, backend: str = "auto",
                   cross_embeds=None):
    """A layer's mixer on its normed input over a plan's model axis:
    ``ps``, ``hs``, ``positions``, ``caches`` and ``cross_embeds`` hold
    one entry per model shard, ``psum`` is the plan's `Seam` (or a
    callable summing a list of parts). An attention or MLA mixer runs
    each shard's heads and its row-sharded out projection meets in one
    reduction; a shard reads the kv heads its q block maps to
    (`attention.select_kv`); a mixer whose heads the model axis does not
    divide runs whole on every shard, unreduced; a decode over caches
    whose positions split over the shards (``"seq_split"`` in the cache)
    combines partial attention (`attention.attn_decode_seq_tp`,
    `mla_decode_seq_tp`). The SSD and RG-LRU bodies reduce inside
    (`ssm_apply_tp`, `rglru_apply_tp`). ``cross_embeds`` reach only a
    CROSS_ATTN layer. Returns the lists (y, cache), y reduced."""
    mixer = kind[0]
    psum = as_seam(psum, len(ps))
    if mixer == SSD:
        return ssm_mod.ssm_apply_tp(cfg, [p["ssm"] for p in ps], hs, psum,
                                    mode=mode, caches=caches,
                                    backend=backend)
    if mixer == RGLRU:
        return rglru_mod.rglru_apply_tp(cfg, [p["rglru"] for p in ps], hs,
                                        psum, mode=mode, caches=caches,
                                        backend=backend)
    if mode == "decode" and caches[0] is not None and \
            caches[0].get("seq_split"):
        # the positions split over the model axis whether or not the
        # heads do: the seam combines them, and sums the out projection
        # only where the heads split
        if mixer == MLA:
            return attn.mla_decode_seq_tp(
                cfg, [p["mla"] for p in ps], hs, psum,
                pos=int(positions[0]), caches=caches)
        return attn.attn_decode_seq_tp(
            cfg, [p["attn"] for p in ps], hs, psum, pos=int(positions[0]),
            caches=caches, window=cfg.window if mixer == LOCAL_ATTN else 0)
    if psum.size > 1 and _whole_heads(cfg, kind, ps[0]):
        psum = psum.local()
    if mixer == MLA:
        outs = [attn.mla_apply(cfg, p["mla"], h, mode=mode,
                               positions=pos, cache=c)
                for p, h, pos, c in zip(ps, hs, positions, caches)]
    else:
        outs = [attn.attn_apply(
            cfg, attn.select_kv(cfg, p["attn"], psum.size, m), h,
            mode=mode, positions=pos, cache=c,
            window=cfg.window if mixer == LOCAL_ATTN else 0, backend=backend,
            cross_embeds=xe if mixer == CROSS_ATTN else None)
            for m, p, h, pos, c, xe in zip(psum.indices, ps, hs, positions,
                                           caches, cross_embeds)]
    return psum.out([y for y, _ in outs]), [c for _, c in outs]


def layer_tp(cfg: ModelConfig, kind, ps, xs, psum, *, mode, positions,
             caches, backend: str = "auto", cross_embeds=None):
    """One layer over a plan's model axis — norm1, the mixer, its
    residual and the MLP tail — every argument but ``kind`` and ``psum``
    one entry per model shard. Under sequence parallelism (``psum.seq``)
    each ``xs`` entry holds its positions, ``positions`` the whole
    sequence's: each sublayer gathers its normed input and scatters its
    output (`Seam.gather_seq`, `Seam.out`). Returns (xs, caches, aux), aux
    as `mlp_tail_tp`'s."""
    psum = as_seam(psum, len(xs))
    hs = psum.gather_seq([rms_norm(x, p["norm1"]) for p, x in zip(ps, xs)])
    ys, cs = mixer_apply_tp(cfg, kind, ps, hs, psum, mode=mode,
                            positions=positions, caches=caches,
                            backend=backend, cross_embeds=cross_embeds)
    xs, aux = mlp_tail_tp(cfg, kind, ps, [x + y for x, y in zip(xs, ys)],
                          psum)
    return xs, cs, aux


def run_stack_tp(cfg: ModelConfig, layers, xs, psum, *, mode, positions,
                 caches=None, backend: str = "auto", cross_embeds=None):
    """Every layer in order over a plan's model axis: ``layers[m]`` is
    model shard m's per-layer params, ``xs``, ``positions`` and
    ``cross_embeds`` one entry per shard, ``caches`` (or None) per layer
    a list over the shards. Returns (xs, per-layer lists of per-shard
    caches)."""
    tp = len(xs)
    psum = as_seam(psum, tp)
    cross_embeds = cross_embeds if cross_embeds is not None else [None] * tp
    out = []
    for layer, kind in enumerate(cfg.layer_kinds()):
        xs, cs, _ = layer_tp(
            cfg, kind, [ws[layer] for ws in layers], xs, psum, mode=mode,
            positions=positions,
            caches=caches[layer] if caches is not None else [None] * tp,
            backend=backend, cross_embeds=cross_embeds)
        out.append(cs)
    return xs, out


def train_stack_tp(cfg: ModelConfig, layer_params, xs, psum, *, positions,
                   backend: str = "auto", cross_embeds=None):
    """The training forward of every layer over a plan's model axis:
    ``xs``, ``positions`` and ``cross_embeds`` hold one entry per model
    shard, and ``layer_params(g, i)`` returns the shards' params of layer
    i of group g (``g`` None: tail layer i). It is called inside each
    layer group's remat segment, so whatever it gathers is gathered again
    in the backward rather than kept. Each group is one
    ``torch.utils.checkpoint`` segment when ``cfg.remat != "none"``, as
    the reference's ``jax.checkpoint`` of its scan body; tail layers are
    not. Returns (xs, stats): stats one ``(me, ce)`` pair per MoE layer,
    in layer order (`moe.balance_loss`)."""
    tp = len(xs)
    psum = as_seam(psum, tp)
    cross_embeds = cross_embeds if cross_embeds is not None else [None] * tp
    kinds = cfg.layer_kinds()
    gs = cfg.group_size()
    n_groups = cfg.num_layers // gs

    def run(kind, ps, xs, stats):
        xs, _, st = layer_tp(cfg, kind, ps, xs, psum, mode="train",
                             positions=positions, caches=[None] * tp,
                             backend=backend, cross_embeds=cross_embeds)
        return xs, stats if st is None else stats + (st,)

    def group_body(g, *xs):
        xs, stats = list(xs), ()
        for i, kind in enumerate(kinds[:gs]):
            xs, stats = run(kind, layer_params(g, i), xs, stats)
        return tuple(xs), stats

    stats = ()
    for g in range(n_groups):
        if cfg.remat != "none":
            # the forward draws no random numbers: no RNG state to stash
            # and restore around the recompute
            xs, st = checkpoint(group_body, g, *xs, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            xs, st = group_body(g, *xs)
        stats += st
    for i, kind in enumerate(kinds[n_groups * gs:]):
        xs, stats = run(kind, layer_params(None, i), list(xs), stats)
    return list(xs), list(stats)


def model_spec(cfg: ModelConfig) -> dict:
    """The reference's parameter pytree as `ParamSpec` leaves."""
    kinds = cfg.layer_kinds()
    gs = cfg.group_size()
    n_groups = cfg.num_layers // gs
    group = {f"l{i}": layer_spec(cfg, *k) for i, k in enumerate(kinds[:gs])}
    s = {"embed": embed_spec(cfg),
         "groups": stack_specs(group, n_groups),
         "final_norm": norm_spec(cfg.d_model)}
    tail = kinds[n_groups * gs:]
    if tail:
        s["tail"] = {f"t{i}": layer_spec(cfg, *k) for i, k in enumerate(tail)}
    return s


def model_logical(cfg: ModelConfig) -> dict:
    """Flat ``{name: logical axes}`` of the model's parameters, the names
    of `model_spec` as `flatten` gives them."""
    return {n: tuple(ps.logical) for n, ps in
            flatten(model_spec(cfg)).items()}


def check_state(cfg: ModelConfig, state: dict) -> dict:
    """Check a flat ``{name: tensor}`` state against the model spec, name
    for name and shape for shape, and cast each leaf to its spec dtype."""
    specs = flatten(model_spec(cfg))
    if set(state) != set(specs):
        raise ValueError(
            f"state names differ from the model's: missing "
            f"{sorted(set(specs) - set(state))}, unexpected "
            f"{sorted(set(state) - set(specs))}")
    out = {}
    for name, ps in specs.items():
        v = torch.as_tensor(state[name])
        if tuple(v.shape) != tuple(ps.shape):
            raise ValueError(f"{name}: shape {tuple(v.shape)} != "
                             f"{tuple(ps.shape)}")
        out[name] = v.to(torch_dtype(ps.dtype or cfg.param_dtype))
    return out


class _Tree(nn.Module):
    """A nested dict of tensors as a module tree, so that ``state_dict()``
    names follow the reference pytree paths."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))


class Model(nn.Module):
    """Decoder stack over one config. ``state`` (a flat ``{name: tensor}``
    dict, e.g. from `repro_torch.convert.params_from_numpy`) supplies the
    weights; without it they are drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device``. On ``device="meta"`` without a state the
    weights are meta tensors of the spec's shapes and dtypes (no storage,
    no draw): the abstract model `launch.dryrun` counts a step of."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0,
                 state: dict | None = None):
        super().__init__()
        self.cfg = cfg
        self.kinds = cfg.layer_kinds()
        device = torch.device(device)
        if state is None and device.type == "meta":
            flat = {n: torch.empty(ps.shape, device=device, dtype=torch_dtype(
                        ps.dtype or cfg.param_dtype))
                    for n, ps in flatten(model_spec(cfg)).items()}
        elif state is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            flat = materialize(model_spec(cfg), gen, device, cfg.param_dtype)
        else:
            flat = {n: v.to(device)
                    for n, v in check_state(cfg, state).items()}
        self.weights = _Tree(unflatten(flat))
        # plain nested dicts of the same tensors for the forward code:
        # `params` in the reference layout, `layers` as per-layer views
        # of the stacked leaves in global layer order
        self.params = unflatten(dict(self.weights.named_parameters()))
        self.group_size = cfg.group_size()
        self.n_groups = cfg.num_layers // self.group_size
        self.layers = [self.group_layer(g, i)
                       for g in range(self.n_groups)
                       for i in range(self.group_size)]
        self.layers += [self.params["tail"][f"t{i}"]
                        for i in range(len(self.params.get("tail", {})))]

    def group_layer(self, g: int, i: int) -> dict:
        """Layer `i` of group `g`: views of the stacked leaves."""
        return unflatten({n: t[g] for n, t in
                          flatten(self.params["groups"][f"l{i}"]).items()})

    def param_count(self) -> int:
        """The number of parameter elements (the reference's
        ``Model.param_count``); on ``meta`` it allocates nothing."""
        return sum(p.numel() for p in self.weights.parameters())

    def train_params(self) -> dict:
        """Make every weight trainable and return them as a flat ``{name:
        parameter}`` dict in the reference's tree order (names sorted
        level by level, as `flatten`) — the tensors the model computes
        with, so an in-place update is the model's. Serving never calls
        this: its weights keep ``requires_grad=False``."""
        params = flatten(self.params)
        for p in params.values():
            p.requires_grad_(True)
        return params

    # -- forward -------------------------------------------------------------
    def embed_in(self, tokens=None, embeds=None):
        """Token ids (b, s) through the embedding table, or — for an
        external-embedding config — ``embeds`` (b, s, d) as given, in the
        compute dtype. As the reference's ``batch_in["embeds"]``, a
        missing ``embeds`` raises `KeyError`."""
        cfg = self.cfg
        if cfg.external_embed:
            if embeds is None:
                raise KeyError("embeds")
            return embeds.to(torch_dtype(cfg.compute_dtype))
        return embed_apply(cfg, self.params["embed"], tokens)

    def head(self, x):
        x = rms_norm(x, self.params["final_norm"])
        return lm_head_apply(self.cfg, self.params["embed"], x)

    def inputs(self, tokens=None, embeds=None, image_embeds=None):
        """A full-sequence forward's prologue: (x (b, s, d) from
        `embed_in`, positions (b, s) int32, ``image_embeds`` in x's
        dtype or None)."""
        x = self.embed_in(tokens, embeds)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        if image_embeds is not None:
            image_embeds = image_embeds.to(x.dtype)
        return x, positions, image_embeds

    def run_stack(self, x, *, mode, positions, caches=None,
                  backend: str = "auto", cross_embeds=None):
        """Every layer in order, over the views built at init
        (`run_stack_tp` on one shard). Returns (x, per-layer caches).
        `backend` picks the prefill kernels' implementation
        (`kernels.api.run`); ``cross_embeds`` (b, n, d) feed the
        cross-attention layers."""
        xs, out = run_stack_tp(
            self.cfg, [self.layers], [x], psum_one, mode=mode,
            positions=[positions],
            caches=[[c] for c in caches] if caches is not None else None,
            backend=backend, cross_embeds=[cross_embeds])
        return xs[0], [c[0] for c in out]

    def forward_prefill(self, tokens=None, backend: str = "auto", *,
                        embeds=None, image_embeds=None):
        """tokens: (b, s) — or, for an external-embedding config,
        ``embeds`` (b, s, d); ``image_embeds`` (b, n_img_tokens, d) feed
        the cross-attention layers. Returns (last-position logits (b, V),
        caches: per layer ``{"k", "v"}`` of shape (b, s, hkv, hd) for
        self-attention layers, ``{"xk", "xv"}`` (b, n, hkv, hd) for
        cross layers, ``{"ckv", "krope"}`` for MLA, ``{"conv", "state"}``
        for SSD and ``{"h", "conv"}`` for RG-LRU layers). Self-attention
        runs through the flash-attention kernel, the SSD and RG-LRU scans
        through theirs (`backend` as in `kernels.api.run`)."""
        x, positions, image_embeds = self.inputs(tokens, embeds,
                                                 image_embeds)
        x, caches = self.run_stack(x, mode="prefill", positions=positions,
                                   backend=backend,
                                   cross_embeds=image_embeds)
        return self.head(x[:, -1:])[:, 0], caches

    def forward_train(self, tokens=None, *, embeds=None, image_embeds=None,
                      backend: str = "auto"):
        """The training forward over every position, as the reference's
        ``forward_train``: tokens (b, s), or ``embeds`` (b, s, d) for an
        external-embedding config; ``image_embeds`` feed the cross
        layers. Attention, SSD and RG-LRU run through their kernels'
        autograd Functions (`backend` as in `kernels.api.run`); each
        layer group is one remat segment when ``cfg.remat != "none"``
        (`train_stack_tp` on one shard). Returns (logits (b, s, V), aux),
        aux the fp32 sum of the MoE layers' load-balancing losses."""
        x, positions, image_embeds = self.inputs(tokens, embeds,
                                                 image_embeds)
        tail = self.params.get("tail", {})

        def layer_params(g, i):
            return [self.group_layer(g, i) if g is not None
                    else tail[f"t{i}"]]

        xs, stats = train_stack_tp(self.cfg, layer_params, [x], psum_one,
                                   positions=[positions], backend=backend,
                                   cross_embeds=[image_embeds])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for me, ce in stats:
            aux = aux + moe_mod.balance_loss(self.cfg, me, ce)
        return self.head(xs[0]), aux

    def cache_spec(self, batch: int, capacity: int):
        """`cache_spec` of this model's config."""
        return cache_spec(self.cfg, batch, capacity)

    def forward_decode(self, tokens, caches, pos: int, *, embeds=None):
        """One token step over capacity-sized caches (see `pad_caches`),
        updated in place. tokens: (b, 1), or ``embeds`` (b, 1, d) for an
        external-embedding config. Returns logits (b, V)."""
        x, _ = self.run_stack(self.embed_in(tokens, embeds), mode="decode",
                              positions=pos, caches=caches)
        return self.head(x)[:, 0]


def layer_cache_spec(cfg: ModelConfig, kind, batch: int, capacity: int):
    """One layer's decode cache at `capacity`: ({name: ``meta`` tensor},
    {name: logical axes}), the reference's ``layer_cache_spec``. A
    sliding-window layer holds ``min(window, capacity)`` rows."""
    mixer = kind[0]
    cdt = torch_dtype(cfg.compute_dtype)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim

    def meta(shape, dtype=cdt):
        return torch.empty(shape, dtype=dtype, device="meta")

    kv_log = ("batch", "kv_seq", "kv_heads", "head_dim")
    if mixer in (ATTN, LOCAL_ATTN):
        cap = min(cfg.window, capacity) if mixer == LOCAL_ATTN else capacity
        shp = (batch, cap, hkv, hd)
        return {"k": meta(shp), "v": meta(shp)}, {"k": kv_log, "v": kv_log}
    if mixer == CROSS_ATTN:
        shp = (batch, cfg.n_img_tokens, hkv, hd)
        log = ("batch", None, "kv_heads", "head_dim")
        return {"xk": meta(shp), "xv": meta(shp)}, {"xk": log, "xv": log}
    if mixer == MLA:
        return ({"ckv": meta((batch, capacity, cfg.kv_lora_rank)),
                 "krope": meta((batch, capacity, cfg.qk_rope_dim))},
                {"ckv": ("batch", "kv_seq", None),
                 "krope": ("batch", "kv_seq", None)})
    if mixer == SSD:
        _, nh, conv_dim = ssm_mod.ssm_dims(cfg)
        return ({"conv": meta((batch, cfg.ssm_conv_width - 1, conv_dim)),
                 "state": meta((batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                               torch.float32)},
                {"conv": ("batch", None, "ssm_inner"),
                 "state": ("batch", "ssm_heads", None, None)})
    if mixer == RGLRU:
        w = cfg.lru_width
        return ({"h": meta((batch, w), torch.float32),
                 "conv": meta((batch, 3, w), torch.float32)},
                {"h": ("batch", "lru"), "conv": ("batch", None, "lru")})
    raise ValueError(mixer)


def cache_spec(cfg: ModelConfig, batch: int, capacity: int):
    """Every layer's decode cache: (per-layer ``{name: meta tensor}``,
    per-layer ``{name: logical axes}``), in layer order — the port's cache
    layout, with the reference's shapes and axes (its
    ``Model.cache_spec`` stacks the groups' layers)."""
    specs = [layer_cache_spec(cfg, k, batch, capacity)
             for k in cfg.layer_kinds()]
    return [a for a, _ in specs], [lg for _, lg in specs]


CACHE_KEYS = {ATTN: ("k", "v"), LOCAL_ATTN: ("k", "v"),
              CROSS_ATTN: ("xk", "xv"), MLA: ("ckv", "krope"),
              SSD: ("conv", "state"), RGLRU: ("conv", "h")}


def pad_caches(caches, capacity: int, cfg: ModelConfig | None = None):
    """Expand prefill caches to decode capacity along the sequence axis:
    self-attention ``k`` / ``v`` and MLA's ``ckv`` / ``krope``. With
    `cfg`, a sliding-window layer's cache becomes a ring buffer of
    ``min(window, capacity)`` rows (the last ones of a longer prefill,
    ring-aligned when the prefill length is a multiple of the window),
    and each layer's cache must hold its mixer's leaves: a cross layer
    prefilled without image embeddings emits self-attention ``k`` / ``v``
    where ``xk`` / ``xv`` belong, and that raises `ValueError`, as the
    reference's tree map over the cache spec does. Cross-attention and
    recurrent state pass through."""
    kinds = cfg.layer_kinds() if cfg is not None else [None] * len(caches)

    def fit(a, rows):
        if a.shape[1] >= rows:
            return a[:, a.shape[1] - rows:].clone()
        z = a.new_zeros((a.shape[0], rows - a.shape[1]) + a.shape[2:])
        return torch.cat([a, z], dim=1)

    out = []
    for layer, (kind, c) in enumerate(zip(kinds, caches)):
        if kind is not None and tuple(sorted(c)) != CACHE_KEYS[kind[0]]:
            raise ValueError(
                f"layer {layer} ({kind[0]}): cache leaves {sorted(c)}, "
                f"want {list(CACHE_KEYS[kind[0]])}")
        rows = capacity
        if kind is not None and kind[0] == LOCAL_ATTN:
            rows = min(cfg.window, capacity)
        out.append({n: fit(a, rows) if n in ("k", "v", "ckv", "krope")
                    else a for n, a in c.items()})
    return out
