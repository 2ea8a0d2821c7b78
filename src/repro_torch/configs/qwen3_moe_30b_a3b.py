"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ATTN, MLP_MOE, ModelConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,                 # per-expert ffn width
        vocab_size=151936,
        rope_theta=1_000_000.0,
        qk_norm=True,
        num_experts=128,
        top_k=8,
        pattern=((ATTN, MLP_MOE),),
    )
