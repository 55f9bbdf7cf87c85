"""llama-3.2-vision-90b — VLM backbone [hf:meta-llama/Llama-3.2-11B-Vision].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; gated
cross-attention image layers every 5th layer.  The vision tower is a
STUB: input_specs() provides precomputed patch embeddings, per the brief.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8, d_ff=28672,
    vocab_size=128256, head_dim=128, cross_attn_every=5, vision_tokens=6400,
)
