"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2 [arXiv:2402.19427]."""
from repro_torch.configs.base import LOCAL_ATTN, MLP_DENSE, RGLRU, ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,            # pattern (rec, rec, attn) repeated
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,           # MQA
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        lru_width=2560,
        window=2048,
        pattern=(
            (RGLRU, MLP_DENSE),
            (RGLRU, MLP_DENSE),
            (LOCAL_ATTN, MLP_DENSE),
        ),
    )
