"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1.

Simplification recorded in DESIGN.md: Llama-4 interleaves dense and MoE FFNs;
we keep every layer MoE (top-1, 128 experts) so the layer scan stays uniform —
the assigned config specifies "MoE 128e top-1" for the stack.  Early fusion is
handled as an interleaved token stream (no vision tower; text path exercised).
Experts are expert-parallel over the 16-way model axis (8 experts/shard).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    moe_d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
)
