"""Architecture/shape/mesh -> hardware-independent feature vectors
(NAPEL's LLVM-IR 'application profile' analogue: the profile of an LM cell
is its config-derived compute/memory/communication character) — a copy of
the JAX package's ``repro/core/napel/features.py`` over the port's
`ModelConfig` and `InputShape` (numpy: equal to the reference's to the
bit). The port counts one device, mesh (1, 1); the napkin keeps the
reference's mesh arithmetic so that its features and baselines stay the
reference's."""
from __future__ import annotations

import math

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
KINDS = ("train", "prefill", "decode")

FEATURE_NAMES = [
    "log_layers", "log_d_model", "log_heads", "log_kv_heads", "log_d_ff",
    "log_vocab", "log_params", "log_active_params", "experts", "top_k",
    "log_seq", "log_batch", "log_tokens", "arith_intensity",
    "attn_fraction", "state_bytes_frac", "mesh_data", "mesh_model",
    "mesh_pod", "chips",
] + [f"family_{f}" for f in FAMILIES] + [f"kind_{k}" for k in KINDS]


def analytic_costs(cfg: ModelConfig, shape: InputShape,
                   mesh_shape: tuple) -> np.ndarray:
    """Napkin per-device (flops, bytes, collective bytes) — the structural
    baseline whose bounded residual NAPEL's forest learns.

    Accounts for SPMD replication: when heads/ffn don't divide the model
    axis, that compute is *duplicated* on every model rank (the dry-run
    measures this waste; the napkin must too)."""
    ms = tuple(mesh_shape) if len(mesh_shape) == 3 else (1,) + tuple(mesh_shape)
    pod, data, model = ms
    dp = float(pod * data)
    chips = float(np.prod(mesh_shape))
    n = float(cfg.active_param_count())
    L, d = cfg.num_layers, cfg.d_model
    # replication factors across the model axis
    heads_div = cfg.num_heads and cfg.num_heads % model == 0
    ffn_div = cfg.d_ff and cfg.d_ff % model == 0
    attn_shards = float(model if heads_div else 1)
    ffn_shards = float(model if ffn_div else 1)
    # rough split of matmul work between attention-side and ffn-side
    attn_frac = 0.35 if cfg.attention_based else 0.0
    if cfg.family == "ssm":
        ffn_shards = float(model if (cfg.ssm_expand * d) % model == 0 else 1)
    eff_s = float(min(shape.seq_len, cfg.window or shape.seq_len))
    hqhd = float(cfg.num_heads * max(cfg.head_dim, 1))

    def matmul_dev(total):
        return total * (attn_frac / attn_shards +
                        (1 - attn_frac) / ffn_shards) / dp

    if shape.kind == "train":
        T = float(shape.seq_len * shape.global_batch)
        passes = 3.0 if cfg.remat != "none" else 2.0
        mm = (2.0 * passes + 2.0) * n * T          # 8NT with full remat
        attn = 0.0
        if cfg.attention_based:
            # qk + pv einsums, fwd + bwd(2x) + remat fwd
            attn = (passes + 0.5) * 4.0 * shape.global_batch * eff_s * \
                shape.seq_len * hqhd * L
        ssd = 0.0
        if cfg.family == "ssm":
            nh = cfg.ssm_expand * d // max(cfg.ssm_head_dim, 1)
            # chunk-quadratic SSD terms (cb / y_intra / states einsums)
            ssd = (passes + 0.5) * 2.0 * T * cfg.ssm_chunk * nh * \
                (cfg.ssm_head_dim + 2 * cfg.ssm_state) * L
        flops = matmul_dev(mm) + attn / (dp * attn_shards) + \
            ssd / (dp * ffn_shards)
        act = T * d * 2.0
        score = shape.global_batch * cfg.num_heads * shape.seq_len * eff_s \
            * 4.0 if cfg.attention_based else \
            T * cfg.ssm_chunk * (cfg.ssm_expand * d //
                                 max(cfg.ssm_head_dim, 1)) * 4.0
        nbytes = (passes + 1.0) * L * \
            (10.0 * act / dp + score / (dp * attn_shards)) + \
            3.0 * 14.0 * n / chips
        coll = passes * 2.0 * L * act / dp + 14.0 * n / chips * 3.0
    elif shape.kind == "prefill":
        T = float(shape.seq_len * shape.global_batch)
        mm = 2.0 * n * T
        attn = 4.0 * shape.global_batch * shape.seq_len * eff_s * hqhd * L \
            if cfg.attention_based else 0.0
        flops = matmul_dev(mm) + attn / (dp * attn_shards)
        act = T * d * 2.0
        score = shape.global_batch * cfg.num_heads * shape.seq_len * eff_s * 4.0
        nbytes = L * (8.0 * act / dp + score / (dp * attn_shards)) + \
            2.0 * n / chips
        coll = 2.0 * L * act / dp + 2.0 * n / chips
    else:  # decode
        T = float(shape.global_batch)
        mm = 2.0 * n * T
        cache = 2.0 * cfg.num_kv_heads * max(cfg.head_dim, 1) * eff_s * \
            2.0 * L * T
        if cfg.family == "ssm":
            cache = (cfg.ssm_expand * d * cfg.ssm_state * 4.0 * L * T /
                     max(cfg.ssm_head_dim, 1))
        flops = matmul_dev(mm) + cache / dp
        nbytes = 2.0 * n / chips + 3.0 * cache / dp
        coll = T * d * 2.0 * L * 2.0 / dp + n * 0.01 / chips
    return np.maximum(np.array([flops, nbytes, coll]), 1.0)


def featurize(cfg: ModelConfig, shape: InputShape, mesh_shape: tuple) -> np.ndarray:
    n = cfg.param_count()
    na = cfg.active_param_count()
    tokens = shape.seq_len * shape.global_batch
    if shape.kind == "decode":
        tokens = shape.global_batch
    # napkin arithmetic intensity: flops per param byte touched
    flops = (6 if shape.kind == "train" else 2) * na * tokens
    bytes_touched = n * 2 + tokens * cfg.d_model * 2
    attn_flops = 0.0
    if cfg.attention_based and shape.kind != "decode":
        attn_flops = 4.0 * tokens * min(shape.seq_len, cfg.window or
                                        shape.seq_len) * cfg.num_heads * \
            max(cfg.head_dim, 1)
    mesh = dict(zip(("pod", "data", "model"),
                    mesh_shape if len(mesh_shape) == 3 else
                    (1,) + tuple(mesh_shape)))
    state_bytes = 0.0
    if shape.kind == "decode":
        state_bytes = (cfg.num_kv_heads * cfg.head_dim * 2 * 2 *
                       min(shape.seq_len, cfg.window or shape.seq_len)
                       * cfg.num_layers * shape.global_batch)
    vec = [
        math.log2(cfg.num_layers), math.log2(cfg.d_model),
        math.log2(max(cfg.num_heads, 1)), math.log2(max(cfg.num_kv_heads, 1)),
        math.log2(max(cfg.d_ff, 1)), math.log2(cfg.vocab_size),
        math.log2(n), math.log2(na),
        float(cfg.num_experts), float(cfg.top_k),
        math.log2(shape.seq_len), math.log2(shape.global_batch),
        math.log2(tokens), flops / max(bytes_touched, 1),
        attn_flops / max(flops, 1), state_bytes / max(bytes_touched, 1),
        float(mesh["data"]), float(mesh["model"]), float(mesh["pod"]),
        float(np.prod(mesh_shape)),
    ]
    vec += [1.0 if cfg.family == f else 0.0 for f in FAMILIES]
    vec += [1.0 if shape.kind == k else 0.0 for k in KINDS]
    return np.array(vec, np.float64)
