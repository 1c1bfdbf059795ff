"""Round-level bookkeeping: comms overhead (MB), staleness, participation."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class RoundLog:
    round: int
    selected: int = 0
    arrived_final: int = 0
    used_snapshot: int = 0
    dropped: int = 0
    delayed: int = 0
    bytes_sent: float = 0.0
    test_loss: float = float("nan")
    test_acc: float = float("nan")
    # serving-path counters (serving/fl_server): zero on the batch engines
    duplicates_rejected: int = 0
    stale_rejected: int = 0
    corrupt_rejected: int = 0
    retries: int = 0
    late_accepted: int = 0
    unregistered_skipped: int = 0
    quorum_met: bool = True
    # lossy-wire transport counters (serving path with core.transport):
    # zero when the transport model is disabled
    backoff_s: float = 0.0             # simulated seconds burnt in backoff
    chunks_sent: int = 0               # chunks handed to the wire (1st try)
    chunks_retransmitted: int = 0      # NACKed chunks re-sent
    chunks_corrupt: int = 0            # wire corruptions detected (CRC)
    chunks_recovered: int = 0          # data chunks rebuilt via XOR parity
    transfers_incomplete: int = 0      # uploads lost beyond parity rescue
    parity_bytes: float = 0.0          # FEC overhead on the wire


@dataclass
class SimLog:
    rounds: List[RoundLog] = field(default_factory=list)

    def add(self, r: RoundLog) -> None:
        self.rounds.append(r)

    @property
    def avg_comm_mb(self) -> float:
        """Mean data transmitted to the server per communication round (MB)."""
        if not self.rounds:
            return 0.0
        return sum(r.bytes_sent for r in self.rounds) / len(self.rounds) / 1e6

    @property
    def final_acc(self) -> float:
        tail = [r.test_acc for r in self.rounds[-5:] if r.test_acc == r.test_acc]
        return sum(tail) / len(tail) if tail else float("nan")

    @property
    def acc_curve(self) -> List[float]:
        return [r.test_acc for r in self.rounds]

    @property
    def loss_curve(self) -> List[float]:
        return [r.test_loss for r in self.rounds]

    def summary(self) -> Dict[str, float]:
        n = max(1, len(self.rounds))
        return {
            "rounds": len(self.rounds),
            "final_acc": self.final_acc,
            "avg_comm_mb": self.avg_comm_mb,
            "mean_participation": sum(r.arrived_final + r.used_snapshot
                                      for r in self.rounds) / n,
            "snapshot_rescues": sum(r.used_snapshot for r in self.rounds),
            "drops": sum(r.dropped for r in self.rounds),
            "duplicates_rejected": sum(r.duplicates_rejected
                                       for r in self.rounds),
            "stale_rejected": sum(r.stale_rejected for r in self.rounds),
            "corrupt_rejected": sum(r.corrupt_rejected for r in self.rounds),
            "retries": sum(r.retries for r in self.rounds),
            "chunks_sent": sum(r.chunks_sent for r in self.rounds),
            "chunks_retransmitted": sum(r.chunks_retransmitted
                                        for r in self.rounds),
            "chunks_recovered": sum(r.chunks_recovered for r in self.rounds),
            "transfers_incomplete": sum(r.transfers_incomplete
                                        for r in self.rounds),
        }
