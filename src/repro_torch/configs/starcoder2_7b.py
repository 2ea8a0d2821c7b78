"""starcoder2-7b [dense] — GQA kv=4, RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ATTN, MLP_DENSE, ModelConfig, register


@register("starcoder2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        rope_theta=1_000_000.0,
        qkv_bias=True,
        mlp_gelu=True,            # starcoder2 uses a classic c_fc/c_proj GELU FFN
        pattern=((ATTN, MLP_DENSE),),
    )
