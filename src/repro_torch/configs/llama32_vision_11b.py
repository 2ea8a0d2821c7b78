"""llama-3.2-vision-11b [vlm] — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

Backbone only: the vision tower is a stub; the caller supplies precomputed
patch embeddings (batch, n_img_tokens, d_model) as ``image_embeds``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-11b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        cross_attn_every=5,       # layers 4, 9, ... carry cross-attention
        n_img_tokens=1601,
    )
