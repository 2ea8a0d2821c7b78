"""Decoder stack over the reference's parameter layout: global (ATTN) and
sliding-window (LOCAL_ATTN) attention, Mamba2 SSD and RG-LRU mixers, with
dense MLPs or none.

Parameters keep the JAX package's pytree (``repro/models/transformer.py``):
``groups`` leaves carry a leading ``n_groups`` stack axis (one entry per
period of the layer pattern) and a non-divisible remainder lives under
``tail`` per layer, so ``state_dict()`` names read ``groups.l0.attn.wq``
exactly like the reference's pytree paths and `repro_torch.convert`
carries params over leaf for leaf. PyTorch runs eagerly, so the stack is
a Python loop over per-layer views of the stacked leaves.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLP_DENSE, MLP_NONE,
                                      RGLRU, SSD, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (flatten, materialize, stack_specs,
                                       torch_dtype, unflatten)
from repro_torch.models.layers import (embed_apply, embed_spec, lm_head_apply,
                                       mlp_apply, mlp_spec, norm_spec,
                                       rms_norm)


def layer_spec(cfg: ModelConfig, mixer: str, mlp: str):
    if mixer not in (ATTN, LOCAL_ATTN, SSD, RGLRU) or \
            mlp not in (MLP_DENSE, MLP_NONE):
        raise NotImplementedError(
            f"{cfg.name}: layer ({mixer}, {mlp}) is not ported — the port "
            f"runs attn/local_attn/ssd/rglru mixers with dense MLPs or none")
    d = cfg.d_model
    s = {"norm1": norm_spec(d)}
    if mixer in (ATTN, LOCAL_ATTN):
        s["attn"] = attn.attn_spec(cfg)
    elif mixer == SSD:
        s["ssm"] = ssm_mod.ssm_spec(cfg)
    else:
        s["rglru"] = rglru_mod.rglru_spec(cfg)
    if mlp == MLP_DENSE:
        s["norm2"] = norm_spec(d)
        s["mlp"] = mlp_spec(cfg)
    return s


def mlp_tail(cfg: ModelConfig, kind, p, x):
    """Post-mixer half of a layer (norm2 + dense MLP residual; nothing for
    MLP_NONE) — shared by the dense stack and the serve layer's fused
    paged decode step."""
    if kind[1] == MLP_NONE:
        return x
    return x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["norm2"]))


def mixer_apply(cfg: ModelConfig, kind, p, h, *, mode, positions,
                cache=None, backend: str = "auto"):
    """A layer's mixer on its normed input. Returns (y, cache)."""
    mixer = kind[0]
    if mixer in (ATTN, LOCAL_ATTN):
        return attn.attn_apply(
            cfg, p["attn"], h, mode=mode, positions=positions, cache=cache,
            window=cfg.window if mixer == LOCAL_ATTN else 0, backend=backend)
    if mixer == SSD:
        return ssm_mod.ssm_apply(cfg, p["ssm"], h, mode=mode, cache=cache,
                                 backend=backend)
    return rglru_mod.rglru_apply(cfg, p["rglru"], h, mode=mode, cache=cache,
                                 backend=backend)


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
    with ``seed`` on ``device``."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0,
                 state: dict | None = None):
        super().__init__()
        self.cfg = cfg
        self.kinds = cfg.layer_kinds()
        device = torch.device(device)
        if state is None:
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
        groups = self.params["groups"]
        n_groups = next(iter(flatten(groups).values())).shape[0]
        self.layers = [
            unflatten({n: t[g] for n, t in flatten(groups[f"l{i}"]).items()})
            for g in range(n_groups) for i in range(len(groups))]
        self.layers += [self.params["tail"][f"t{i}"]
                        for i in range(len(self.params.get("tail", {})))]

    # -- forward -------------------------------------------------------------
    def embed_in(self, tokens):
        return embed_apply(self.cfg, self.params["embed"], tokens)

    def head(self, x):
        x = rms_norm(x, self.params["final_norm"])
        return lm_head_apply(self.cfg, self.params["embed"], x)

    def run_stack(self, x, *, mode, positions, caches=None,
                  backend: str = "auto"):
        """Every layer in order. Returns (x, per-layer caches). `backend`
        picks the prefill kernels' implementation (`kernels.api.run`)."""
        out = []
        for layer, (kind, p) in enumerate(zip(self.kinds, self.layers)):
            h = rms_norm(x, p["norm1"])
            y, c = mixer_apply(
                self.cfg, kind, p, h, mode=mode, positions=positions,
                cache=caches[layer] if caches is not None else None,
                backend=backend)
            x = mlp_tail(self.cfg, kind, p, x + y)
            out.append(c)
        return x, out

    def forward_prefill(self, tokens, backend: str = "auto"):
        """tokens: (b, s). Returns (last-position logits (b, V), caches:
        per layer ``{"k", "v"}`` of shape (b, s, hkv, hd) for attention
        layers, ``{"conv", "state"}`` for SSD and ``{"h", "conv"}`` for
        RG-LRU layers). Attention runs through the flash-attention kernel,
        the SSD and RG-LRU scans through theirs (`backend` as in
        `kernels.api.run`)."""
        x = self.embed_in(tokens)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        x, caches = self.run_stack(x, mode="prefill", positions=positions,
                                   backend=backend)
        return self.head(x[:, -1:])[:, 0], caches

    def forward_decode(self, tokens, caches, pos: int):
        """One token step over capacity-sized caches (see `pad_caches`),
        updated in place. tokens: (b, 1). Returns logits (b, V)."""
        x, _ = self.run_stack(self.embed_in(tokens), mode="decode",
                              positions=pos, caches=caches)
        return self.head(x)[:, 0]


def pad_caches(caches, capacity: int, cfg: ModelConfig | None = None):
    """Expand prefill caches to decode capacity along the sequence axis.
    With `cfg`, a sliding-window layer's cache becomes a ring buffer of
    ``min(window, capacity)`` rows (the last ones of a longer prefill,
    ring-aligned when the prefill length is a multiple of the window);
    recurrent state passes through."""
    kinds = cfg.layer_kinds() if cfg is not None \
        else [(ATTN, None)] * len(caches)

    def fit(a, rows):
        if a.shape[1] >= rows:
            return a[:, a.shape[1] - rows:].clone()
        z = a.new_zeros((a.shape[0], rows - a.shape[1]) + a.shape[2:])
        return torch.cat([a, z], dim=1)

    out = []
    for (mixer, _), c in zip(kinds, caches):
        if "k" not in c:
            out.append(dict(c))
            continue
        rows = min(cfg.window, capacity) if mixer == LOCAL_ATTN else capacity
        out.append({"k": fit(c["k"], rows), "v": fit(c["v"], rows)})
    return out
