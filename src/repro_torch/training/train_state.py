"""TrainState: params + optimizer state + step counter
(``repro/training/train_state.py``).

The same six fields in the same order as the reference's, so that a
checkpoint (``checkpoint.save_checkpoint``: the leaves in order, None
fields holding none) moves between the packages.  The last three are the
OpportunisticSync snapshot slots, None when the feature is off.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.optim.sgd import step_counter
from repro_torch.utils.tree import tree_clone


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor
    # OpportunisticSync slots (None when the feature is off)
    snapshot: Optional[Any] = None
    snapshot_step: Optional[torch.Tensor] = None
    tau_extra: Optional[torch.Tensor] = None


def create_train_state(params: Any, optimizer, with_opt_sync: bool = False,
                       tau_extra0: float = 0.0) -> TrainState:
    """A fresh state on the params' device (step 0)."""
    opt_state = optimizer.init(params)
    step = step_counter(params)
    if with_opt_sync:
        return TrainState(
            params=params, opt_state=opt_state, step=step,
            snapshot=tree_clone(params),
            snapshot_step=torch.full((), -1, dtype=torch.int32,
                                     device=step.device),
            tau_extra=torch.full((), tau_extra0, dtype=torch.float32,
                                 device=step.device))
    return TrainState(params=params, opt_state=opt_state, step=step)
