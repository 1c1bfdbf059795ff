"""Alg. 2's probe schedule (a copy of the schedule functions of
``repro/core/transmission.py``).  ``OppTransmitter`` belongs to the host
engine, which waits for a later slice.
"""
from __future__ import annotations

from typing import List


def schedule_period(e: int, b: int) -> int:
    """Probe period e/b of Alg. 2 line 12."""
    return max(1, round(e / b))


def scheduled_epochs(e: int, b: int) -> List[int]:
    """Local iterations at which Alg. 2 probes the channel: e_t % (e/b) == 0.

    With b transmissions total, (b-1) are intermediate: e_t in
    {e/b, 2e/b, ..., (b-1)e/b}; the final upload at e_t == e is the regular
    end-of-round transmission.
    """
    if b <= 1:
        return []
    period = schedule_period(e, b)
    return [k * period for k in range(1, b) if k * period < e]
