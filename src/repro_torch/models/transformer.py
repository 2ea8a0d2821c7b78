"""Decoder stack: ATTN + dense-MLP layers over the reference's parameter
layout.

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

from repro_torch.configs.base import ATTN, MLP_DENSE, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (flatten, materialize, stack_specs,
                                       torch_dtype, unflatten)
from repro_torch.models.layers import (embed_apply, embed_spec, lm_head_apply,
                                       mlp_apply, mlp_spec, norm_spec,
                                       rms_norm)


def layer_spec(cfg: ModelConfig, mixer: str, mlp: str):
    if mixer != ATTN or mlp != MLP_DENSE:
        raise NotImplementedError(
            f"{cfg.name}: layer ({mixer}, {mlp}) is not ported — the port "
            f"runs global-attention layers with dense MLPs")
    d = cfg.d_model
    return {"norm1": norm_spec(d), "attn": attn.attn_spec(cfg),
            "norm2": norm_spec(d), "mlp": mlp_spec(cfg)}


def mlp_tail(cfg: ModelConfig, p, x):
    """Post-mixer half of a layer (norm2 + dense MLP residual) — shared by
    the dense stack and the serve layer's fused paged decode step."""
    return x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["norm2"]))


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
        picks the prefill attention implementation (`kernels.api.run`)."""
        out = []
        for layer, p in enumerate(self.layers):
            h = rms_norm(x, p["norm1"])
            y, c = attn.attn_apply(
                self.cfg, p["attn"], h, mode=mode, positions=positions,
                cache=caches[layer] if caches is not None else None,
                backend=backend)
            x = mlp_tail(self.cfg, p, x + y)
            out.append(c)
        return x, out

    def forward_prefill(self, tokens, backend: str = "auto"):
        """tokens: (b, s). Returns (last-position logits (b, V), caches:
        per layer ``{"k", "v"}`` of shape (b, s, hkv, hd)). Attention runs
        through the flash-attention kernel (`backend` as in
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


def pad_caches(caches, capacity: int):
    """Expand prefill caches to decode capacity along the sequence axis."""
    def pad(a):
        z = a.new_zeros((a.shape[0], capacity - a.shape[1]) + a.shape[2:])
        return torch.cat([a, z], dim=1)
    return [{"k": pad(c["k"]), "v": pad(c["v"])} for c in caches]
