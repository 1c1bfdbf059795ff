from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import constant, cosine
from repro_torch.optim.sgd import Optimizer, apply_updates, clip_by_global_norm, sgd

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "constant", "cosine", "sgd"]
