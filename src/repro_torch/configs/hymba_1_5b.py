"""Hymba-1.5B [arXiv:2411.13676] — hybrid-head: parallel attention + Mamba
heads inside every block.  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16.  Vocab padded 32001->32256 for model-axis sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    citation="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
)
