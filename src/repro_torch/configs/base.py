"""Config system: one frozen `ModelConfig` per architecture, a name
registry, and the reduced smoke configs the tests run.

A copy of the JAX package's ``repro/configs/base.py`` (the port imports
nothing of that package) with the same ten architectures."""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

# ---------------------------------------------------------------------------
# Block types composing a decoder layer. A layer = (mixer, mlp).
# ---------------------------------------------------------------------------
ATTN = "attn"            # global self attention (GQA/MQA/MHA by num_kv_heads)
MLA = "mla"              # multi-head latent attention (compressed kv)
LOCAL_ATTN = "local_attn"  # sliding-window attention
CROSS_ATTN = "cross_attn"  # self-attn layer augmented with cross-attention
SSD = "ssd"              # mamba2 state-space-duality mixer
RGLRU = "rglru"          # RG-LRU recurrent block (with short conv)

MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_NONE = "none"        # mamba2 blocks have no separate MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    rope_theta: float = 10_000.0
    window: int = 0                  # sliding window size for LOCAL_ATTN
    qkv_bias: bool = False
    qk_norm: bool = False            # RMS-norm q/k per head (qwen3 style)
    # layer pattern: repeated until num_layers is covered.
    # each entry: (mixer_kind, mlp_kind)
    pattern: Sequence[tuple] = ((ATTN, MLP_DENSE),)
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25   # set to num_experts/top_k for dropless
    # MLA (minicpm3-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_bf16_intra: bool = False   # bf16 intra-chunk decay/score tensors
    # RG-LRU
    lru_width: int = 0
    # modality frontend stubs
    external_embed: bool = False     # audio: inputs are precomputed frame embeddings
    n_img_tokens: int = 0            # vlm: number of patch-embedding tokens
    cross_attn_every: int = 0        # vlm: a cross-attn layer every N layers
    mlp_gelu: bool = False           # classic 2-matmul GELU FFN instead of SwiGLU
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training defaults
    remat: str = "full"              # none | full | dots (activation checkpointing)
    train_microbatches: int = 1      # gradient-accumulation microbatches
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to 256 (Megatron-style) so TP sharding divides."""
        return -(-self.vocab_size // 256) * 256

    def layer_kinds(self) -> list[tuple]:
        """Expanded per-layer (mixer, mlp) list of length num_layers."""
        out = []
        if self.cross_attn_every:
            for i in range(self.num_layers):
                if (i % self.cross_attn_every) == self.cross_attn_every - 1:
                    out.append((CROSS_ATTN, MLP_DENSE))
                else:
                    out.append((ATTN, MLP_DENSE))
            return out
        i = 0
        while len(out) < self.num_layers:
            out.append(self.pattern[i % len(self.pattern)])
            i += 1
        return out

    def group_size(self) -> int:
        """Layers per scan step (period of the layer pattern)."""
        if self.cross_attn_every:
            return self.cross_attn_every
        return len(self.pattern)

    @property
    def attention_based(self) -> bool:
        kinds = {m for m, _ in self.layer_kinds()}
        return bool(kinds & {ATTN, MLA, LOCAL_ATTN, CROSS_ATTN})

    @property
    def subquadratic(self) -> bool:
        """True if decode state size is independent of context length."""
        kinds = {m for m, _ in self.layer_kinds()}
        return not (kinds & {ATTN, MLA, CROSS_ATTN})  # LOCAL_ATTN window is O(1)

    # -- parameter counting (analytic; used for 6ND and memory napkin math) --
    def param_count(self) -> int:
        n = 0
        d = self.d_model
        if not self.external_embed:
            n += self.vocab_size * d          # token embedding
        n += self.vocab_size * d if not self.tie_embeddings else 0  # lm head
        for mixer, mlp in self.layer_kinds():
            n += 2 * d                        # two RMSNorm scales
            if mixer in (ATTN, LOCAL_ATTN, CROSS_ATTN):
                hd = self.head_dim
                n += d * self.num_heads * hd               # q
                n += 2 * d * self.num_kv_heads * hd        # k, v
                n += self.num_heads * hd * d               # o
                if mixer == CROSS_ATTN:                    # extra x-attn params
                    n += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                    n += self.num_heads * hd * d + d
            elif mixer == MLA:
                n += d * self.q_lora_rank
                n += self.q_lora_rank * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                n += d * (self.kv_lora_rank + self.qk_rope_dim)
                n += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                n += self.num_heads * self.v_head_dim * d
            elif mixer == SSD:
                din = self.ssm_expand * d
                nh = din // self.ssm_head_dim
                conv_dim = din + 2 * self.ssm_ngroups * self.ssm_state
                n += d * (2 * din + 2 * self.ssm_ngroups * self.ssm_state + nh)
                n += conv_dim * self.ssm_conv_width
                n += 2 * nh                    # A_log, D
                n += din                       # gate norm scale
                n += din * d                   # out proj
            elif mixer == RGLRU:
                w = self.lru_width
                n += 2 * d * w                 # conv branch in, gate branch in
                n += 2 * w                     # short conv (width-4 depthwise ~ lumped)
                n += 2 * w * w // 1            # lru input/recurrent gates (block-diag approx -> dense here)
                n += w                         # Lambda param
                n += w * d                     # out proj
            mats = 2 if self.mlp_gelu else 3   # gelu: up,down; swiglu: gate,up,down
            if mlp == MLP_DENSE:
                n += mats * d * self.d_ff
            elif mlp == MLP_MOE:
                n += d * self.num_experts      # router
                n += self.num_experts * mats * d * self.d_ff
        n += d                                 # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k instead of all experts)."""
        if self.family != "moe":
            return self.param_count()
        n = self.param_count()
        mats = 2 if self.mlp_gelu else 3
        per_layer_moe = self.num_experts * mats * self.d_model * self.d_ff
        active = self.top_k * mats * self.d_model * self.d_ff
        n_moe_layers = sum(1 for _, m in self.layer_kinds() if m == MLP_MOE)
        return n - n_moe_layers * (per_layer_moe - active)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str    # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg: ModelConfig) -> list[InputShape]:
    """The assigned shape cells for an architecture (long_500k only for
    sub-quadratic archs, per assignment)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def _load_builtin():
    import repro_torch.configs.all_archs  # noqa: F401  (populate registry)


def get_config(name: str, **overrides) -> ModelConfig:
    _load_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_archs() -> list[str]:
    _load_builtin()
    return sorted(_REGISTRY)


def smoke_config(name: str) -> ModelConfig:
    """A reduced same-family config that runs a real step on one CPU device."""
    cfg = get_config(name)
    small: dict = dict(
        num_layers=max(2, cfg.group_size()),
        d_model=64,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.num_heads:
        small.update(num_heads=4, num_kv_heads=max(1, min(4, cfg.num_kv_heads)),
                     head_dim=16, d_ff=128)
    if cfg.family == "moe":
        # dropless capacity so train/prefill/decode agree exactly in tests
        small.update(num_experts=4, top_k=2, d_ff=32, moe_capacity_factor=2.0)
    if cfg.name == "minicpm3-4b":
        small.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
                     qk_nope_dim=8, v_head_dim=16)
    if cfg.family == "ssm":
        small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.family == "hybrid":
        small.update(lru_width=64, window=32)
    if cfg.window and cfg.family != "hybrid":
        small.update(window=32)
    if cfg.n_img_tokens:
        small.update(n_img_tokens=16, cross_attn_every=cfg.cross_attn_every)
    return dataclasses.replace(cfg, **small)
