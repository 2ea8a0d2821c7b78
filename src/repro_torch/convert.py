"""Carry the JAX package's params into the port (the models', a training
state's: `train_state_from_numpy`, and the Sibyl agent's:
`sibyl_params_from_numpy`).

`params_from_numpy` takes the ``Model.init`` pytree of the JAX package
with every leaf already converted to a numpy array (the caller does
``jax.tree.map(np.asarray, params)``: the port never imports jax) and
returns the port's flat state dict. Leaves map one for one by their
pytree path and keep their shape: the port's `Model` stores every weight
in the reference's layout (``wq`` as (d, hq, hd), ``wo`` as (hq, hd, d),
stacked groups leading), so nothing is transposed anywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import flatten
from repro_torch.models.transformer import check_state


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy


def params_from_numpy(cfg: ModelConfig, tree: dict) -> dict:
    """Nested dict of numpy arrays (the reference pytree) -> flat
    ``{"groups.l0.attn.wq": tensor}`` state on the CPU, checked name for
    name and shape for shape against the port's model spec."""
    return check_state(cfg, {name: _to_torch(v)
                             for name, v in flatten(tree).items()})


def train_state_from_numpy(cfg: ModelConfig, state_tree: dict) -> dict:
    """The reference's train state ``{"params", "opt": {"step", "m", "v"[,
    "master"]}}`` as numpy (``jax.tree.map(np.asarray, state)``) -> the
    port's: params through `params_from_numpy`, the moments and the
    master as flat fp32 dicts over the same names, the step an int32
    scalar; all on the CPU. A reference ``grad_comp`` residual is
    dropped, as the reference's own restore drops it."""
    params = params_from_numpy(cfg, state_tree["params"])
    opt_tree = state_tree["opt"]
    opt = {"step": torch.tensor(int(np.asarray(opt_tree["step"])),
                                dtype=torch.int32)}
    for key in ("m", "v", "master"):
        if key not in opt_tree:
            continue
        flat = {n: _to_torch(v).to(torch.float32)
                for n, v in flatten(opt_tree[key]).items()}
        if set(flat) != set(params):
            raise ValueError(f"opt {key}: names differ from the params'")
        for n, v in flat.items():
            if v.shape != params[n].shape:
                raise ValueError(f"opt {key} {n}: shape {tuple(v.shape)} "
                                 f"!= {tuple(params[n].shape)}")
        opt[key] = flat
    return {"params": params, "opt": opt}


def sibyl_params_from_numpy(tree: dict) -> dict:
    """The reference Sibyl agent's ``params`` dict (w1, b1, w2, b2, w3,
    b3, as numpy: ``jax.tree.map(np.asarray, agent.params)``) -> a
    `QNet` state dict of float32 CPU tensors, name for name and shape for
    shape (both keep weights as (in, out)). Serves the target network and
    Adam's moments too, which share the params' structure."""
    from repro_torch.core.sibyl.agent import PARAM_NAMES
    from repro_torch.core.sibyl.env import N_FEATURES
    if set(tree) != set(PARAM_NAMES):
        raise ValueError(f"Sibyl params {sorted(tree)}, want "
                         f"{sorted(PARAM_NAMES)}")
    state = {n: torch.from_numpy(np.array(tree[n], np.float32))
             for n in PARAM_NAMES}
    hidden, n_actions = state["w1"].shape[1], state["w3"].shape[1]
    want = {"w1": (N_FEATURES, hidden), "b1": (hidden,),
            "w2": (hidden, hidden), "b2": (hidden,),
            "w3": (hidden, n_actions), "b3": (n_actions,)}
    for n, shape in want.items():
        if tuple(state[n].shape) != shape:
            raise ValueError(f"Sibyl param {n}: shape "
                             f"{tuple(state[n].shape)}, want {shape}")
    return state
