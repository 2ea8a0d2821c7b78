"""granite-moe-3b-a800m [moe] — 40 experts top-8 [hf:ibm-granite family]."""
from repro_torch.configs.base import ATTN, MLP_MOE, ModelConfig, register


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,                 # per-expert ffn width
        vocab_size=49155,
        num_experts=40,
        top_k=8,
        pattern=((ATTN, MLP_MOE),),
    )
