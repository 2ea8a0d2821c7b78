"""Named variants of a dry-run cell — the port of the JAX package's
``repro/launch/variants.py``.

A variant transforms (ModelConfig, sharding rules) before a dry-run cell
is counted; `launch.dryrun.run_cell` counts the variant's step and
`core.report.variant_delta` reads its roofline against the baseline's.
Each encodes one hypothesis: the SSD chunk, sequence parallelism,
microbatching, remat, MLA's latents whole, padded heads or experts, the
decode cache unsplit over its positions, the experts over the data axis.
The rules are `sharding.partition.DEFAULT_RULES` with the named axes
replaced; `train.sharding.TrainPlan` stores the state by them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.partition import DEFAULT_RULES


def _rules(**updates) -> dict:
    r = {k: list(v) for k, v in DEFAULT_RULES.items()}
    for k, v in updates.items():
        r[k] = v
    return r


def apply(variant: str, cfg: ModelConfig):
    """(cfg', rules') for a named variant; rules' None means the default
    rules. An unknown name raises `ValueError`."""
    if variant == "baseline":
        return cfg, None

    # mamba2 / SSD (memory-bound)
    if variant.startswith("ssm_chunk"):
        q = int(variant.removeprefix("ssm_chunk"))
        return dataclasses.replace(cfg, ssm_chunk=q), None
    if variant == "ssm_bf16":
        return dataclasses.replace(cfg, ssm_bf16_intra=True), None
    if variant == "ssm_bf16_sp":
        return (dataclasses.replace(cfg, ssm_bf16_intra=True),
                _rules(seq=[("model",)]))

    # sequence parallelism: activations' seq dim over the model axis
    if variant == "seq_parallel":
        return cfg, _rules(seq=[("model",)])

    # microbatched training (memory)
    if variant.startswith("microbatch"):
        n = int(variant.removeprefix("microbatch"))
        return dataclasses.replace(cfg, train_microbatches=n), None

    if variant == "no_remat":
        return dataclasses.replace(cfg, remat="none"), None

    # MLA's latents whole on every shard (collective-bound prefill)
    if variant == "mla_replicate_latent":
        return cfg, _rules(kv_lora=[], q_lora=[])

    # attention heads padded to a model-axis multiple (40 -> 48): +20%
    # attention params and flops, split 16 ways instead of replicated
    if variant.startswith("pad_heads"):
        h = int(variant.removeprefix("pad_heads"))
        return dataclasses.replace(
            cfg, num_heads=h,
            num_kv_heads=h if cfg.num_kv_heads == cfg.num_heads
            else cfg.num_kv_heads), None

    # the combined best-of for the minicpm3 prefill cell
    if variant == "mla_opt":
        cfg2 = dataclasses.replace(cfg, num_heads=48, num_kv_heads=48)
        return cfg2, _rules(kv_lora=[], q_lora=[])

    # MoE experts padded to a model-axis multiple (40 -> 48)
    if variant.startswith("pad_experts"):
        e = int(variant.removeprefix("pad_experts"))
        return dataclasses.replace(cfg, num_experts=e), None

    # granite combined: pad heads and experts
    if variant == "granite_opt":
        return dataclasses.replace(cfg, num_heads=32, num_kv_heads=8,
                                   num_experts=48), None

    # the decode cache unsplit over its positions
    if variant == "kv_seq_unsharded":
        return cfg, _rules(kv_seq=[])

    # experts over the data axis instead of the model axis (MoE)
    if variant == "experts_over_data":
        return cfg, _rules(experts=[("data",)])

    # sequence parallelism and gradient accumulation together
    if variant.startswith("sp_mb"):
        n = int(variant.removeprefix("sp_mb"))
        return (dataclasses.replace(cfg, train_microbatches=n),
                _rules(seq=[("model",)]))

    raise ValueError(f"unknown variant {variant!r}")


VARIANTS = ["baseline", "ssm_chunk64", "ssm_chunk128", "seq_parallel",
            "microbatch4", "microbatch16", "no_remat",
            "mla_replicate_latent", "kv_seq_unsharded", "experts_over_data"]
