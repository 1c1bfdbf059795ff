"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio transformer.
48L d_model=1280 16H (kv=16 = full MHA) d_ff=5120 vocab=504 (cluster units).

The mel-spectrogram + conv feature extractor frontend is the allowed STUB:
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).
Encoder-only => bidirectional attention, no decode shapes (DESIGN.md §5).
Training objective: masked-unit prediction over 504 classes (padded to 512).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    citation="arXiv:2106.07447",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    frontend_stub=True,
)
