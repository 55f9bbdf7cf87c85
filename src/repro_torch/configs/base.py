"""Architecture configuration (one dataclass drives every model family)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | encoder | ssm | hybrid | moe | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    head_dim: Optional[int] = None   # default d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    mlp_type: str = "swiglu"         # swiglu | gelu | none

    # ssm (mamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1
    ssm_head_dim: int = 64           # mamba2 P
    ssm_chunk: int = 128             # chunked-scan length

    # hybrid (zamba2-style): one SHARED attention+MLP block applied after
    # every `attn_every` ssm layers
    attn_every: int = 0

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # Dispatch-payload dtype for the EP collectives ("bfloat16" | "int8").
    # int8 is the beyond-paper optimization: per-token symmetric
    # quantization of the dispatched activations halves the all-to-all
    # bytes (the dominant roofline term of the MoE train cells).
    moe_dispatch_dtype: str = "bfloat16"

    # vlm (cross-attention image layers every `cross_attn_every` layers)
    cross_attn_every: int = 0
    vision_tokens: int = 0

    # blocked (flash-style) attention tile sizes; q_block is the KV
    # re-read divisor (total KV traffic = (S/q_block) * KV bytes)
    attn_q_block: int = 1024
    attn_k_block: int = 1024

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_encoder(self) -> bool:
        return self.family == "encoder"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """May run the long_500k cell (SSM / hybrid archs)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny sizes."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4 if self.family != "vlm" else 10),
            d_model=64,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=128,
            head_dim=None,
        )
        if self.num_heads:
            kw["num_heads"] = 4
            kw["num_kv_heads"] = max(1, 4 * self.num_kv_heads // max(self.num_heads, 1))
        if self.num_experts:
            kw["num_experts"] = 8
            kw["experts_per_token"] = 2
            kw["d_ff"] = 32
            # no-drop capacity so decode == full-forward exactly in tests
            # (capacity-drop behaviour is unit-tested separately)
            kw["moe_capacity_factor"] = 16.0
        if self.ssm_state:
            kw["ssm_state"] = min(self.ssm_state, 16)
            kw["ssm_head_dim"] = 16
            kw["ssm_chunk"] = 8
        if self.attn_every:
            kw["attn_every"] = 2
        if self.cross_attn_every:
            kw["cross_attn_every"] = 5
            kw["vision_tokens"] = 16
        return self.replace(**kw)
