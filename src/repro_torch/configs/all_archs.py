"""Import all architecture configs to populate the registry."""
# flake8: noqa: F401
from repro_torch.configs import (
    codeqwen15_7b,
    granite_moe_3b_a800m,
    llama3_405b,
    llama32_vision_11b,
    mamba2_780m,
    minicpm3_4b,
    musicgen_medium,
    qwen3_moe_30b_a3b,
    recurrentgemma_2b,
    starcoder2_7b,
)
