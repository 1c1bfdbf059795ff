"""Alg. 2's snapshot decision (``snapshot_decision`` of
``repro/core/opportunistic_sync.py``).  The multi-pod OppSync feature
around it waits for the multi-device slice.
"""
from __future__ import annotations

from typing import Tuple

import torch


def snapshot_decision(scheduled: torch.Tensor, outage: torch.Tensor,
                      tau: torch.Tensor, tau_extra: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 lines 17–21, branch-free over (K,) vectors: a scheduled probe
    succeeds iff the channel is up and the delay τ (eq. 15) fits the
    remaining allowance; success burns τ from the budget (eq. 16).
    Returns (ok, new_tau_extra)."""
    ok = scheduled & (~outage) & (tau <= tau_extra)
    return ok, torch.where(ok, tau_extra - tau, tau_extra)
