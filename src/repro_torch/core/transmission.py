"""Opportunistic-proactive transmission: Algorithm 2's per-client
scheduler (a copy of ``repro/core/transmission.py``, plain Python).

One ``OppTransmitter`` per selected client per round owns the relaxed
budget τ_extra (eq. 14) and decides, at the scheduled local iterations
(e_t % (e/b) == 0), whether the instantaneous channel affords the snapshot
(eqs. 15-16).  An outage voids a transmission, and the server keeps only
the most recent snapshot (Alg. 2 lines 14/20).  The host engine and the
serving path use it; the fused round makes the same decisions on stacked
tensors (``opportunistic_sync.snapshot_decision``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from repro_torch.core import latency as lat


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


@dataclass
class TransmissionEvent:
    epoch: int
    delay_s: float
    payload_bytes: float
    kind: str                       # "opportunistic" | "final"


@dataclass
class OppTransmitter:
    """Per-client, per-round OPT state (Alg. 2, Opportunistic_Transmission)."""
    model_bytes: float
    e: int                          # total local epochs
    b: int                          # transmission budget
    rate0_bps: float                # r_i^0, rate at round start
    compress_ratio: float = 1.0     # <1 when the delta codec shrinks payloads
    schedule_override: tuple = ()   # manual schedule (Sec. III-B)
    tau_extra: float = field(init=False)
    tau_extra0: float = field(init=False)   # initial eq. 14 allowance
    snapshot: Optional[Any] = field(init=False, default=None)
    snapshot_epoch: int = field(init=False, default=-1)
    events: List[TransmissionEvent] = field(init=False, default_factory=list)
    _schedule: tuple = field(init=False)

    def __post_init__(self):
        self.tau_extra = lat.extra_allowance(self.b, self.payload_bytes,
                                             self.rate0_bps)
        # the budgeted allowance, kept: deadline-aware schemes charge it
        # against τ_max at the final upload (schemes.final_slack)
        self.tau_extra0 = self.tau_extra
        self._schedule = (tuple(self.schedule_override)
                          if self.schedule_override
                          else tuple(scheduled_epochs(self.e, self.b)))

    @property
    def payload_bytes(self) -> float:
        return self.model_bytes * self.compress_ratio

    @property
    def schedule(self) -> List[int]:
        return list(self._schedule)

    def maybe_transmit(self, epoch: int, rate_bps: float, outage: bool,
                       params: Any) -> bool:
        """Alg. 2 lines 17-21 at a scheduled epoch.  Returns True if sent.

        ``params`` may be a zero-arg callable, evaluated only once the
        outage and budget checks pass (the codec round trip is not free)."""
        if epoch not in self._schedule:
            return False
        if outage:
            return False
        tau = lat.snapshot_delay(self.payload_bytes, rate_bps)   # eq. (15)
        if tau > self.tau_extra:                                 # cancelled
            return False
        self.tau_extra -= tau                                    # eq. (16)
        self.snapshot = params() if callable(params) else params  # overwrite
        self.snapshot_epoch = epoch
        self.events.append(TransmissionEvent(
            epoch, tau, self.payload_bytes, "opportunistic"))
        return True

    def final_upload(self, rate_bps: float, outage: bool,
                     tau_spent_training: float, tau_max: float) -> bool:
        """End-of-round upload (Alg. 2 line 14).  Fails on outage or if the
        one-round latency including this upload would exceed τ_max."""
        if outage:
            return False
        tau = lat.snapshot_delay(self.payload_bytes, rate_bps)
        if tau_spent_training + tau > tau_max:
            return False
        self.events.append(TransmissionEvent(
            self.e, tau, self.payload_bytes, "final"))
        return True

    @property
    def bytes_sent(self) -> float:
        return sum(ev.payload_bytes for ev in self.events)
