"""Granite-MoE-3B-A800M [hf:ibm-granite/granite-3.0-1b-a400m-base family].
32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40e top-8.

40 experts % 16-way model axis != 0, so experts are replicated and sharded
tensor-parallel *inside* each expert (moe_d_ff 512 / 16 = 32 lanes/shard) —
see DESIGN.md §4.  Vocab padded 49155->49408.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
)
