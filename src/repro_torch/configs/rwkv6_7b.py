"""RWKV6-7B "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay.
32L d_model=4096 d_ff=14336 vocab=65536.  head_dim=64 -> 64 WKV heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    citation="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # wkv heads = d_model / head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attn_free=True,
)
