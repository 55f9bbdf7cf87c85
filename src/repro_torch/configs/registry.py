"""Registry of the 10 assigned architectures (one module per arch)."""
from __future__ import annotations

from .base import ArchConfig
from .falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from .hubert_xlarge import CONFIG as HUBERT_XLARGE
from .qwen3_1_7b import CONFIG as QWEN3_1_7B
from .minitron_4b import CONFIG as MINITRON_4B
from .internlm2_1_8b import CONFIG as INTERNLM2_1_8B
from .codeqwen15_7b import CONFIG as CODEQWEN15_7B
from .zamba2_1_2b import CONFIG as ZAMBA2_1_2B
from .olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from .qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE_30B_A3B
from .llama32_vision_90b import CONFIG as LLAMA32_VISION_90B

ARCHS = {
    c.name: c for c in (
        FALCON_MAMBA_7B, HUBERT_XLARGE, QWEN3_1_7B, MINITRON_4B,
        INTERNLM2_1_8B, CODEQWEN15_7B, ZAMBA2_1_2B, OLMOE_1B_7B,
        QWEN3_MOE_30B_A3B, LLAMA32_VISION_90B,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
