"""Device resolution for every entry point of the port.

``None`` means the CUDA card.  A missing card is an error, not a reason to
run somewhere else: the CPU is used only when the caller asks for it with
``device="cpu"`` (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "the plain PyTorch twins on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def rank_device(kind: str, rank: int) -> torch.device:
    """The device of global rank ``rank`` in a world of ``kind`` ranks:
    ``cuda:(rank % torch.cuda.device_count())`` on the card (ranks share
    cards round robin), the CPU for ``"cpu"``."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {kind!r}")
    resolve_device("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())
