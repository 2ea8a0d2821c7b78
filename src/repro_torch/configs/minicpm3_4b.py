"""minicpm3-4b [dense] — MLA (multi-head latent attention) [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import MLA, MLP_DENSE, ModelConfig, register


@register("minicpm3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,          # MLA: every head gets latent-expanded kv
        head_dim=96,              # qk_nope + qk_rope
        d_ff=6400,
        vocab_size=73448,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_rope_dim=32,
        qk_nope_dim=64,
        v_head_dim=64,
        pattern=((MLA, MLP_DENSE),),
    )
