"""Deterministic fault injection + retry/backoff for the FL serving path
(a copy of ``repro/core/faults.py``; numpy only).

The paper's premise is that clients are unreliable: uploads arrive late,
stale, corrupted or not at all.  ``serving/fl_server.FLServer`` runs a
long-lived aggregation loop whose transport is perturbed by a seeded,
fully deterministic :class:`FaultPlan`.

Fault kinds (the grammar below):

  ``drop``     — the client's final upload is black-holed: every attempt
                 times out, retries exhaust, and the round closes without
                 it (the scheme's rescue/delayed path takes over).
  ``dup``      — the final upload is delivered ``1 + count`` times; the
                 server inbox must be idempotent (duplicates rejected,
                 aggregation bit-identical to the single-delivery run).
  ``corrupt``  — the next ``count`` uploads from the client arrive with
                 flipped payload bytes; the CRC check refuses them and the
                 client re-sends under exponential backoff (recoverable).
  ``delay``    — the final upload misses the round deadline and arrives
                 after close with a stale round id; the inbox rejects it
                 unless the quorum policy is still holding the round open.
  ``crash``    — the *server* dies at a named phase of the round
                 (``train`` | ``close`` | ``checkpoint``); a supervisor
                 restarts it from the latest committed msgpack checkpoint.
  ``flip``     — ``count`` *pre-encode* bit flips in the client's upload:
                 the payload CRC is computed after the flip, so the
                 corruption is CRC-clean and sails through the inbox —
                 only Byzantine-robust aggregation (the ``opt_trimmed`` /
                 ``opt_median`` / ``opt_clip`` schemes) can absorb it.
  ``partial``  — the upload is truncated: the last ``count`` chunks never
                 leave the client.  Under the chunked+parity transport
                 (``core.transport``) one missing chunk per parity group
                 rebuilds bitwise at round close; without it the blob
                 fails CRC on every attempt and the upload is lost.

Plan grammar (``FaultPlan.parse`` / ``str(plan)`` round-trip)::

    plan   := event (';' event)*
    event  := kind '@' 'r' ROUND [':' target] ['x' COUNT]
    target := 'c' CLIENT | 'c*'            (client faults; default c*)
            | 'train' | 'close' | 'checkpoint'   (crash phase; default close)

    e.g.  "dup@r2:c1; corrupt@r1:c*x2; crash@r3:checkpoint"

Everything is deterministic: ``FaultPlan.random`` draws from a seeded
``np.random.Generator``, and the retry jitter stream is seeded per
``(seed, round, client)`` so a killed-and-resumed server replays the exact
same fault/retry interleaving (the bit-compatibility contract the chaos
tests pin).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("drop", "dup", "corrupt", "delay", "crash", "flip", "partial")
CRASH_PHASES = ("train", "close", "checkpoint")


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

class TransientUploadError(Exception):
    """A retriable transport failure (timeout, refused payload)."""


class UploadTimeout(TransientUploadError):
    """The attempt exceeded the transport timeout (or was black-holed)."""


class CorruptPayload(TransientUploadError):
    """CRC mismatch: the server refused the payload; the client re-sends."""


class RetriesExhausted(Exception):
    """Every backoff attempt failed; the upload is missed for this round."""

    def __init__(self, attempts: int, last: Exception):
        super().__init__(f"upload failed after {attempts} attempts: {last!r}")
        self.attempts = attempts
        self.last = last


class ServerCrash(Exception):
    """An injected server death; carries where it happened so a supervisor
    can mark the crash consumed and restart from the latest checkpoint."""

    def __init__(self, round_id: int, phase: str):
        super().__init__(f"injected server crash at round {round_id} "
                         f"phase {phase!r}")
        self.round_id = round_id
        self.phase = phase


# ---------------------------------------------------------------------------
# retry / timeout / exponential backoff with jitter
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with multiplicative jitter, in *simulated*
    seconds (nothing here sleeps — delays are charged to the round clock).

    Attempt ``k`` (0-based) waits ``min(max_delay, base * factor**k)``
    scaled by ``1 - jitter * u`` with ``u ~ U[0, 1)`` from the caller's
    seeded generator — deterministic under a fixed seed, decorrelated
    across clients.
    """
    max_attempts: int = 4
    base_s: float = 0.05
    factor: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.5
    timeout_s: float = 30.0        # per-attempt transport timeout

    def delay_s(self, attempt: int, rng: np.random.Generator) -> float:
        raw = min(self.max_delay_s, self.base_s * self.factor ** attempt)
        return raw * (1.0 - self.jitter * float(rng.random()))

    def validate(self) -> "BackoffPolicy":
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must lie in [0, 1], got {self.jitter}")
        return self


@dataclass
class RetryResult:
    """Outcome of ``retry_call``: the value plus the accounting the server
    metrics log records (retries, simulated seconds burnt in backoff)."""
    value: object
    attempts: int = 1
    backoff_s: float = 0.0

    @property
    def retries(self) -> int:
        return self.attempts - 1


def retry_call(fn: Callable[[], object], policy: BackoffPolicy,
               rng: np.random.Generator) -> RetryResult:
    """Run ``fn`` under ``policy``: transient failures back off and retry,
    anything else propagates.  Raises :class:`RetriesExhausted` when the
    budget runs out (the caller routes the miss to the scheme's
    rescue/delayed path)."""
    policy.validate()
    backoff = 0.0
    last: Exception = RuntimeError("unreachable")
    for attempt in range(policy.max_attempts):
        try:
            return RetryResult(fn(), attempts=attempt + 1, backoff_s=backoff)
        except TransientUploadError as e:
            last = e
            if attempt + 1 < policy.max_attempts:
                backoff += policy.delay_s(attempt, rng)
    raise RetriesExhausted(policy.max_attempts, last)


def client_rng(seed: int, round_id: int, client_id: int) -> np.random.Generator:
    """The per-(round, client) jitter stream: independent of the simulation
    RNG so fault handling never perturbs the training trajectory, and
    reconstructible after a server restart."""
    return np.random.default_rng(
        np.random.SeedSequence((int(seed), int(round_id), int(client_id))))


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultEvent:
    kind: str                      # one of FAULT_KINDS
    round: int                     # 1-based round id
    client: Optional[int] = None   # None = every scheduled client
    count: int = 1                 # e.g. number of duplicate deliveries
    phase: str = "close"           # crash only

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {FAULT_KINDS}")
        if self.kind == "crash" and self.phase not in CRASH_PHASES:
            raise ValueError(f"unknown crash phase {self.phase!r}; "
                             f"choose from {CRASH_PHASES}")
        if self.round < 1:
            raise ValueError(f"rounds are 1-based, got r{self.round}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got x{self.count}")

    def __str__(self) -> str:
        if self.kind == "crash":
            return f"crash@r{self.round}:{self.phase}"
        tgt = "c*" if self.client is None else f"c{self.client}"
        x = f"x{self.count}" if self.count != 1 else ""
        return f"{self.kind}@r{self.round}:{tgt}{x}"


_EVENT_RE = re.compile(
    r"^(?P<kind>[a-z]+)@r(?P<round>\d+)"
    r"(?::(?P<target>c\*|c\d+|[a-z]+))?"
    r"(?:x(?P<count>\d+))?$")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, seedable schedule of injected faults."""
    events: Tuple[FaultEvent, ...] = ()

    # -- construction --------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the grammar above; '' or 'none' is the empty plan."""
        text = (text or "").strip()
        if not text or text == "none":
            return cls()
        events: List[FaultEvent] = []
        for raw in re.split(r"[;\n]+", text):
            raw = raw.strip()
            if not raw:
                continue
            m = _EVENT_RE.match(raw)
            if not m:
                raise ValueError(
                    f"bad fault event {raw!r}; expected "
                    f"kind@rROUND[:cCLIENT|c*|PHASE][xCOUNT] with kind in "
                    f"{FAULT_KINDS} (e.g. 'dup@r2:c1', 'crash@r3:checkpoint')")
            kind = m.group("kind")
            rnd = int(m.group("round"))
            tgt = m.group("target")
            count = int(m.group("count") or 1)
            if kind == "crash":
                events.append(FaultEvent(kind, rnd,
                                         phase=(tgt or "close")))
            else:
                client = None
                if tgt not in (None, "c*"):
                    if not tgt.startswith("c"):
                        raise ValueError(
                            f"{raw!r}: client faults target 'c<idx>' or "
                            f"'c*', got {tgt!r}")
                    client = int(tgt[1:])
                events.append(FaultEvent(kind, rnd, client=client,
                                         count=count))
        return cls(tuple(events))

    @classmethod
    def random(cls, seed: int, rounds: int, clients: Sequence[int], *,
               p_dup: float = 0.0, p_corrupt: float = 0.0,
               p_drop: float = 0.0, p_delay: float = 0.0,
               p_flip: float = 0.0, p_partial: float = 0.0,
               crash_rounds: Iterable[int] = ()) -> "FaultPlan":
        """A seeded chaos schedule: each (round, client) cell draws each
        fault kind independently; ``crash_rounds`` add one close-phase
        crash each.  Same seed -> same plan, always."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        probs = (("dup", p_dup), ("corrupt", p_corrupt),
                 ("drop", p_drop), ("delay", p_delay),
                 ("flip", p_flip), ("partial", p_partial))
        for t in range(1, rounds + 1):
            for c in clients:
                for kind, p in probs:
                    if p > 0.0 and rng.random() < p:
                        events.append(FaultEvent(kind, t, client=int(c)))
        for t in crash_rounds:
            phase = CRASH_PHASES[int(rng.integers(len(CRASH_PHASES)))]
            events.append(FaultEvent("crash", int(t), phase=phase))
        return cls(tuple(events))

    # -- queries -------------------------------------------------------------
    def count(self, kind: str, round_id: int, client_id: int) -> int:
        """Total injected count of ``kind`` hitting this (round, client)."""
        return sum(e.count for e in self.events
                   if e.kind == kind and e.round == round_id
                   and e.client in (None, client_id))

    def crash_phase(self, round_id: int) -> Optional[str]:
        for e in self.events:
            if e.kind == "crash" and e.round == round_id:
                return e.phase
        return None

    @property
    def recoverable(self) -> bool:
        """True when every fault is *recoverable* — dup/corrupt/crash leave
        the training trajectory bit-identical to the fault-free run (the
        chaos property test's precondition); drop/delay change which
        updates aggregate and so legitimately move the trajectory."""
        return all(e.kind in ("dup", "corrupt", "crash") for e in self.events)

    @property
    def parity_recoverable(self) -> bool:
        """True when every fault is absorbed *bitwise* by the chunked
        transport with XOR parity: the legacy recoverable kinds plus
        ``partial`` events truncating at most one chunk (one parity chunk
        per group rebuilds exactly one missing data chunk).  ``flip`` is
        never bitwise-recoverable — it is CRC-clean by construction and
        only *tolerance*-bounded under robust aggregation."""
        return all(e.kind in ("dup", "corrupt", "crash")
                   or (e.kind == "partial" and e.count == 1)
                   for e in self.events)

    def __str__(self) -> str:
        return ";".join(str(e) for e in self.events)

    def __bool__(self) -> bool:
        return bool(self.events)


def as_fault_plan(plan) -> FaultPlan:
    """Coerce None | str | FaultPlan to a FaultPlan."""
    if plan is None:
        return FaultPlan()
    if isinstance(plan, FaultPlan):
        return plan
    if isinstance(plan, str):
        return FaultPlan.parse(plan)
    raise TypeError(f"fault plan must be a FaultPlan or grammar string, "
                    f"got {type(plan).__name__}")
