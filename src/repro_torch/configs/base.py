"""Config system: architecture configs + registry.

Every assigned architecture is a ``ModelConfig`` instance registered under its
public id (``--arch <id>``). ``ModelConfig.reduced()`` yields the smoke-test
variant (<=2 layers, d_model<=512, <=4 experts) mandated by the spec; the full
config is only ever lowered via ShapeDtypeStructs in the dry-run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

_REGISTRY: dict[str, "ModelConfig"] = {}


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # citation (arXiv / model card)

    # trunk dims
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: Optional[int] = None   # default: d_model // num_heads

    # attention variant
    attention: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    mrope: bool = False              # multimodal rotary (qwen2-vl)
    sliding_window: Optional[int] = None
    local_global_ratio: int = 0      # gemma3: N local layers per 1 global

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    v_head_dim: int = 0              # default: head_dim

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # routed-expert hidden width
    first_dense_layers: int = 0      # leading dense layers (deepseek-v2)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001

    # SSM (mamba2 / rwkv6)
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    hybrid_attn_every: int = 0       # zamba2: attn block period (0 = never)

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    max_source_len: int = 0          # whisper: 1500 mel frames

    # modality frontend stub (vlm/audio) — embeddings arrive precomputed
    frontend: Optional[str] = None   # "vision" | "audio"
    num_frontend_tokens: int = 0

    # misc
    norm_eps: float = 1.0e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # which input shapes this arch supports for long-context decode
    subquadratic: bool = False       # True => long_500k eligible

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.num_heads, 1)

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim if self.v_head_dim else self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none"

    def param_count(self) -> int:
        """Analytic total parameter count (embedding + trunk), for roofline."""
        d, v = self.d_model, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2)
        n += self.num_layers * self._layer_params()
        if self.encoder_layers:
            n += self.encoder_layers * self._encoder_layer_params()
            n += self.max_source_len * d  # learned positions
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k routed + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d, v = self.d_model, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2)
        moe_layers = self.num_layers - self.first_dense_layers
        dense_layers = self.first_dense_layers
        n += dense_layers * (self._attn_params() + 3 * d * self.d_ff + 2 * d)
        active_ff = (self.num_experts_per_tok + self.num_shared_experts) * self.moe_d_ff
        n += moe_layers * (self._attn_params() + 3 * d * active_ff
                           + d * self.num_experts + 2 * d)
        return n

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.attention == "mla":
            r, qr = self.kv_lora_rank, self.q_lora_rank or self.d_model
            rope = self.qk_rope_head_dim
            nh = self.num_heads
            n = d * (r + rope)                       # kv down + k_rope
            n += d * qr + qr * nh * (hd + rope)      # q down/up
            n += r * nh * (hd + self.resolved_v_head_dim)  # kv up
            n += nh * self.resolved_v_head_dim * d   # out proj
            return n
        if self.attention == "none":
            if self.ssm_state_dim and not self.hybrid_attn_every:
                # rwkv6 token-mix: r/k/v/g/o + decay params ~ 5 d^2
                return 5 * d * d + 2 * d
            return 0
        nh, nkv = self.num_heads, self.num_kv_heads
        return d * nh * hd + 2 * d * nkv * hd + nh * hd * d

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.is_moe:
            n = self.num_experts * 3 * d * self.moe_d_ff
            n += self.num_shared_experts * 3 * d * self.moe_d_ff
            n += d * self.num_experts  # router
            return n
        return 3 * d * self.d_ff  # swiglu

    def _ssm_params(self) -> int:
        d = self.d_model
        inner = self.ssm_expand * d
        nh = inner // self.ssm_head_dim
        # mamba2: in_proj (z,x,B,C,dt) + conv + out_proj + A,D
        n = d * (2 * inner + 2 * self.ssm_state_dim + nh)
        n += self.ssm_conv_width * (inner + 2 * self.ssm_state_dim)
        n += inner * d + 2 * nh
        return n

    def _layer_params(self) -> int:
        d = self.d_model
        if self.family in ("ssm",) and self.ssm_state_dim:
            # pure mamba-like; rwkv6 handled via attention == none + d_ff
            if self.attention == "none" and self.d_ff:
                return self._attn_params() + 3 * d * self.d_ff + 2 * d
            return self._ssm_params() + 2 * d
        if self.family == "hybrid":
            n = self._ssm_params() + 2 * d
            if self.hybrid_attn_every:
                # amortized shared attention + its ffn
                n += (self._gqa_params() + 3 * d * self.d_ff) // self.hybrid_attn_every
            return n
        if self.is_moe and self.first_dense_layers:
            # average of dense + moe layers
            moe = self.num_layers - self.first_dense_layers
            tot = (self.first_dense_layers * (self._attn_params() + 3 * d * self.d_ff)
                   + moe * (self._attn_params() + self._ffn_params()))
            return tot // self.num_layers + 2 * d
        return self._attn_params() + self._ffn_params() + 2 * d

    def _gqa_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d

    def _encoder_layer_params(self) -> int:
        d = self.d_model
        return self._gqa_params() + 3 * d * self.d_ff + 2 * d

    # ---- smoke-test reduction ----------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        nh = min(self.num_heads, 4)
        ratio = max(self.num_heads // max(self.num_kv_heads, 1), 1)
        nkv = max(nh // min(ratio, nh), 1)
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=d // nh,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            kv_lora_rank=min(self.kv_lora_rank, 64),
            q_lora_rank=min(self.q_lora_rank, 64),
            qk_rope_head_dim=min(self.qk_rope_head_dim, 32),
            v_head_dim=0,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            # drop-free capacity so reduced-model tests are batch-invariant
            capacity_factor=1.0e9 if self.num_experts else self.capacity_factor,
            ssm_state_dim=min(self.ssm_state_dim, 16),
            ssm_head_dim=min(self.ssm_head_dim, 32),
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            max_source_len=min(self.max_source_len, 64),
            num_frontend_tokens=min(self.num_frontend_tokens, 16),
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else None,
            local_global_ratio=min(self.local_global_ratio, 1) if self.local_global_ratio else 0,
        )


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import arch modules lazily to avoid cycles; the port registers the
    # architectures it serves (the others come with their own slices)
    from repro_torch.configs import internlm2_1_8b  # noqa: F401
