"""Split-learning partition of model parameters, HSFL's SL mode
(``repro/core/split.py``).

A stacked transformer's (L, ...) layer leaves are sliced at a cut index:
the UE side gets the embedding + layers [0, cut), the BS side layers
[cut, L) + final norm + head.  The cut-layer activation (B, S, d_model) is
the SL payload; for recurrent families the carried state at the cut layer
travels with it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def split_stacked(params: Dict[str, Any], cut: int) -> Tuple[Dict, Dict]:
    """Split a transformer param tree at stacked-layer index ``cut``."""
    layers = params["layers"]
    ue = {"layers": tree_map(lambda a: a[:cut], layers)}
    if "embed" in params:
        ue["embed"] = params["embed"]
    bs = {"layers": tree_map(lambda a: a[cut:], layers),
          "final_norm": params["final_norm"],
          "head": params["head"]}
    return ue, bs


def merge_stacked(ue: Dict[str, Any], bs: Dict[str, Any]) -> Dict[str, Any]:
    layers = tree_map(lambda a, b: torch.cat([a, b], dim=0),
                      ue["layers"], bs["layers"])
    out = {"layers": layers, "final_norm": bs["final_norm"], "head": bs["head"]}
    if "embed" in ue:
        out["embed"] = ue["embed"]
    return out


def ue_param_bytes(params: Dict[str, Any], cut: int) -> int:
    """m_i^l: size of the UE-side model for eq. (12)/(13)."""
    ue, _ = split_stacked(params, cut) if "layers" in params else (params, None)
    return sum(a.numel() * a.element_size() for a in tree_leaves(ue))
