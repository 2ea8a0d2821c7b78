"""codeqwen1.5-7b [dense] — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.base import ATTN, MLP_DENSE, ModelConfig, register


@register("codeqwen1.5-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,          # GQA kv=32 (full MHA kv)
        head_dim=128,
        d_ff=13440,
        vocab_size=92416,
        rope_theta=1_000_000.0,
        qkv_bias=True,
        pattern=((ATTN, MLP_DENSE),),
    )
