"""musicgen-medium [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only: the EnCodec frontend is a stub; the caller supplies
precomputed frame embeddings (batch, seq, d_model) as ``embeds``.
"""
from repro_torch.configs.base import ATTN, MLP_DENSE, ModelConfig, register


@register("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,          # EnCodec codebook size
        external_embed=True,
        mlp_gelu=True,            # classic transformer FFN
        pattern=((ATTN, MLP_DENSE),),
    )
