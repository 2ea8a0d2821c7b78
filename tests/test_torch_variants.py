"""`repro_torch.launch.variants` against the JAX package's
``repro/launch/variants.py``: every name in `VARIANTS` and the reference's
other names (``pad_heads48``, ``pad_experts48``, ``mla_opt``,
``granite_opt``, ``ssm_bf16``, ``ssm_bf16_sp``, ``sp_mb4``, ``ssm_chunk32``,
``microbatch8``), on every arch: the config fields and the rules are
equal, or both raise the same error type."""
import dataclasses

import pytest

from repro.configs import get_config as jax_config
from repro.launch import variants as jax_variants
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import variants

EXTRA = ["pad_heads48", "pad_experts48", "mla_opt", "granite_opt",
         "ssm_bf16", "ssm_bf16_sp", "sp_mb4", "ssm_chunk32", "microbatch8"]


def _outcome(apply, cfg, name):
    try:
        out_cfg, rules = apply(name, cfg)
    except Exception as e:           # the error type is the outcome
        return type(e).__name__, None
    rules = None if rules is None else \
        {k: [tuple(c) for c in v] for k, v in rules.items()}
    return dataclasses.asdict(out_cfg), rules


def test_variant_names_are_the_reference():
    assert variants.VARIANTS == jax_variants.VARIANTS


@pytest.mark.parametrize("name", variants.VARIANTS + EXTRA + ["bogus"])
def test_apply_matches_reference(name):
    for arch in list_archs():
        got = _outcome(variants.apply, get_config(arch), name)
        want = _outcome(jax_variants.apply, jax_config(arch), name)
        assert got == want, (arch, name)
