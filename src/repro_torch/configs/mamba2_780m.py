"""mamba2-780m [ssm] — SSD, attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import MLP_NONE, SSD, ModelConfig, register


@register("mamba2-780m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,             # d_inner = 3072
        ssm_head_dim=64,          # 48 ssm heads
        ssm_ngroups=1,
        ssm_conv_width=4,
        ssm_chunk=256,
        pattern=((SSD, MLP_NONE),),
    )
