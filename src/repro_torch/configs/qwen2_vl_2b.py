"""Qwen2-VL-2B [arXiv:2409.12191] — VLM backbone with M-RoPE.
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

The ViT vision encoder + projector is the allowed STUB: ``input_specs()``
provides precomputed patch embeddings (B, num_patches, d_model) that the
backbone scatters into the token stream at image-placeholder positions.
M-RoPE splits each head_dim/2 rotary block into (t, h, w) sections [16,24,24].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    citation="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    num_patches=256,
    frontend_stub=True,
)
