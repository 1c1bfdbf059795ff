"""The paper's own model: 5-layer CNN for MNIST (2 conv + 3 fc), Section IV.

Not part of the assigned-architecture pool — this is the faithful-repro model
used by the HSFL/OPT simulation (benchmarks fig3a-fig3d).  The ModelConfig
fields are reused loosely; models/cnn.py reads only name/vocab_size (classes).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-cnn",
    family="cnn",
    citation="Li, Liu, Mahmoodi 2023 (this paper), Sec. IV",
    num_layers=5,
    d_model=28,            # image side
    vocab_size=10,         # classes
    dtype="float32",
    param_dtype="float32",
)
