"""Lossy-wire transport: chunked resumable uploads, burst errors, XOR parity
(a copy of ``repro/core/transport.py``; numpy and zlib only).

Without it every upload is an atomic msgpack blob that lands whole or is
CRC-rejected.  This module models the channel the paper assumes:

  - **chunking** — a codec snapshot splits into fixed-size chunks, each
    with its own CRC32 trailer (``make_chunks``).  The transfer is
    content-addressed: ``transfer_id`` is the CRC32 of the whole payload,
    so re-offering identical content resumes instead of re-sending.
  - **budget-driven scheduling** — the eq. 14 probe allowance
    τ_extra = (b−1)·m/r⁰ splits evenly over the scheduled probe epochs;
    each epoch carries ``floor(τ_share·r / (8·chunk_bytes))`` chunks at
    the instantaneous rate (``ChunkedUploader``).  A snapshot one epoch
    cannot afford *accumulates across probe epochs* (resumable partial
    upload) instead of being cancelled by the all-or-nothing eq. 15 gate.
  - **burst errors** — ``LossyWire`` runs its own per-chunk
    Gilbert–Elliott chain (the same ``channel_lib.outage_transitions``
    solver as the fleet outage chain): bits flip at ``ber_bad`` in the
    bad state and ``ber_good`` in the good state.  Chunk CRCs survive
    untouched, so the receiver detects the corruption and NACKs — the
    sender retransmits under the existing ``faults.BackoffPolicy``.
  - **erasure rescue** — systematic XOR parity: every ``parity_k`` data
    chunks are closed by one parity chunk (interleaved, so a truncated
    tail costs at most the newest group's protection).  The receiver
    (``ChunkAssembler``) rebuilds any single missing data chunk per
    group — k-of-(k+1) erasure coding — rescuing incomplete uploads at
    round close.
  - **cross-round resume** — ``TransferLedger`` keeps incomplete
    assemblies keyed by ``(client, transfer_id)`` across rounds; a
    sender can query ``have`` and push only the missing chunks.

Everything here is host-side transport plumbing (numpy/zlib): the device
engines never see chunks — ``serving/fl_server`` drives this
module and hands fully reassembled payloads to the normal inbox path.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.channel_lib import outage_transitions

__all__ = ["TransportConfig", "Chunk", "ChunkAssembler", "ChunkedUploader",
           "LossyWire", "TransferLedger", "epoch_chunk_budget",
           "make_chunks", "reassemble", "split_payload", "xor_bytes"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TransportConfig:
    """Knobs of the lossy wire (``FLServer(transport=...)``)."""
    chunk_bytes: int = 4096        # data chunk size on the wire
    parity_k: int = 4              # data chunks per XOR parity group; 0 = off
    ber_good: float = 0.0          # per-bit flip probability, GE good state
    ber_bad: float = 0.0           # per-bit flip probability, GE bad state
    wire_outage_prob: float = 0.30   # GE stationary bad-state marginal
    wire_persistence: float = 0.70   # GE stay-bad probability

    def validate(self) -> "TransportConfig":
        if self.chunk_bytes < 1:
            raise ValueError(f"chunk_bytes must be >= 1, got "
                             f"{self.chunk_bytes}")
        if self.parity_k < 0:
            raise ValueError(f"parity_k must be >= 0, got {self.parity_k}")
        for name in ("ber_good", "ber_bad", "wire_outage_prob",
                     "wire_persistence"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must lie in [0, 1], got {v}")
        return self


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Chunk:
    """One wire unit of a transfer.  ``crc`` is computed *before* the wire,
    so in-flight corruption is detectable (and NACKable); ``transfer_id``
    is the CRC32 of the whole payload — the content address the receiver
    verifies after reassembly."""
    transfer_id: int
    index: int                     # data: 0-based position; parity: group id
    kind: str                      # "data" | "parity"
    n_data: int                    # data chunks in the transfer
    payload_len: int               # total payload bytes (trims the tail)
    data: bytes
    crc: int

    @property
    def key(self) -> Tuple[str, int]:
        return (self.kind, self.index)

    def ok(self) -> bool:
        return zlib.crc32(self.data) == self.crc


def split_payload(payload: bytes, chunk_bytes: int) -> List[bytes]:
    """Fixed-size split (last part may be short; empty payload -> [b''])."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    parts = [payload[i:i + chunk_bytes]
             for i in range(0, len(payload), chunk_bytes)]
    return parts or [b""]


def xor_bytes(*parts: bytes) -> bytes:
    """Bytewise XOR, zero-padded to the longest part."""
    n = max(len(p) for p in parts)
    out = np.zeros(n, np.uint8)
    for p in parts:
        a = np.frombuffer(p, np.uint8)
        out[:len(a)] ^= a
    return out.tobytes()


def make_chunks(payload: bytes, cfg: TransportConfig) -> List[Chunk]:
    """Systematic chunking: data chunks in index order, one XOR parity
    chunk closing each group of ``parity_k`` (groups interleaved so a
    truncated upload loses at most the newest group's protection)."""
    tid = zlib.crc32(payload)
    parts = split_payload(payload, cfg.chunk_bytes)
    n = len(parts)
    out: List[Chunk] = []
    group: List[bytes] = []
    for i, part in enumerate(parts):
        out.append(Chunk(tid, i, "data", n, len(payload), part,
                         zlib.crc32(part)))
        group.append(part)
        if cfg.parity_k and (len(group) == cfg.parity_k or i == n - 1):
            p = xor_bytes(*group)
            out.append(Chunk(tid, i // cfg.parity_k, "parity", n,
                             len(payload), p, zlib.crc32(p)))
            group = []
    return out


def reassemble(data: Dict[int, bytes], n_data: int, payload_len: int,
               transfer_id: int) -> bytes:
    """Concatenate the data chunks and verify the content address."""
    missing = [i for i in range(n_data) if i not in data]
    if missing:
        raise ValueError(f"transfer {transfer_id:#010x}: missing data "
                         f"chunks {missing}")
    payload = b"".join(data[i] for i in range(n_data))[:payload_len]
    if zlib.crc32(payload) != transfer_id:
        raise ValueError(f"transfer {transfer_id:#010x}: reassembled "
                         f"payload fails the content CRC")
    return payload


# ---------------------------------------------------------------------------
# receiver side
# ---------------------------------------------------------------------------

class ChunkAssembler:
    """Reassembly state of one transfer: banked chunks, XOR recovery."""

    def __init__(self, transfer_id: int, n_data: int, payload_len: int,
                 parity_k: int, chunk_bytes: int):
        self.transfer_id = int(transfer_id)
        self.n_data = int(n_data)
        self.payload_len = int(payload_len)
        self.parity_k = int(parity_k)
        self.chunk_bytes = int(chunk_bytes)
        self.data: Dict[int, bytes] = {}
        self.parity: Dict[int, bytes] = {}
        self.duplicates = 0
        self.recovered = 0             # data chunks rebuilt via parity

    @classmethod
    def for_chunk(cls, chunk: Chunk, cfg: TransportConfig
                  ) -> "ChunkAssembler":
        return cls(chunk.transfer_id, chunk.n_data, chunk.payload_len,
                   cfg.parity_k, cfg.chunk_bytes)

    def add(self, chunk: Chunk) -> str:
        """Bank a received chunk: 'accepted' | 'duplicate' | 'corrupt'."""
        if chunk.transfer_id != self.transfer_id:
            return "stale"
        if not chunk.ok():
            return "corrupt"
        store = self.data if chunk.kind == "data" else self.parity
        if chunk.index in store:
            self.duplicates += 1
            return "duplicate"
        store[chunk.index] = chunk.data
        return "accepted"

    def have(self) -> Set[Tuple[str, int]]:
        """Chunk keys already banked (the cross-round resume have-set)."""
        return ({("data", i) for i in self.data}
                | {("parity", g) for g in self.parity})

    def _group(self, g: int) -> range:
        return range(g * self.parity_k,
                     min((g + 1) * self.parity_k, self.n_data))

    def _len_of(self, i: int) -> int:
        if i < self.n_data - 1:
            return self.chunk_bytes
        return self.payload_len - (self.n_data - 1) * self.chunk_bytes

    def try_reconstruct(self) -> int:
        """XOR-rebuild every group missing exactly one data chunk whose
        parity arrived (k-of-(k+1) erasure rescue).  Returns the number
        of chunks recovered by this call."""
        if not self.parity_k:
            return 0
        rec = 0
        for g, p in self.parity.items():
            absent = [i for i in self._group(g) if i not in self.data]
            if len(absent) == 1:
                i = absent[0]
                others = [self.data[j] for j in self._group(g) if j != i]
                self.data[i] = xor_bytes(p, *others)[:self._len_of(i)]
                rec += 1
        self.recovered += rec
        return rec

    def complete(self) -> bool:
        return len(self.data) == self.n_data

    def payload(self) -> bytes:
        return reassemble(self.data, self.n_data, self.payload_len,
                          self.transfer_id)


class TransferLedger:
    """Content-addressed store of in-flight reassemblies, persisting
    *across rounds*: a payload re-offered later (same CRC) resumes from
    the chunks already banked instead of starting over.  FIFO-bounded —
    abandoned transfers (e.g. stale snapshots) age out."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = int(max_entries)
        self._asm: "OrderedDict[Tuple[int, int], ChunkAssembler]" = \
            OrderedDict()

    def assembler(self, client_id: int, chunk: Chunk,
                  cfg: TransportConfig) -> ChunkAssembler:
        key = (int(client_id), chunk.transfer_id)
        asm = self._asm.get(key)
        if asm is None:
            asm = ChunkAssembler.for_chunk(chunk, cfg)
            self._asm[key] = asm
            while len(self._asm) > self.max_entries:
                self._asm.popitem(last=False)
        return asm

    def get(self, client_id: int, transfer_id: int
            ) -> Optional[ChunkAssembler]:
        return self._asm.get((int(client_id), int(transfer_id)))

    def pop(self, client_id: int, transfer_id: int) -> None:
        self._asm.pop((int(client_id), int(transfer_id)), None)

    def __len__(self) -> int:
        return len(self._asm)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

class LossyWire:
    """Per-(round, client) Gilbert–Elliott burst-error channel.  Each
    chunk transmission advances the chain one step; the state picks the
    bit-error rate.  CRC trailers ride unharmed, so corruption is always
    *detectable* — the receiver NACKs and the sender retransmits."""

    def __init__(self, cfg: TransportConfig, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        self.go_bad, self.stay_bad = outage_transitions(
            cfg.wire_outage_prob, cfg.wire_persistence)
        # stationary start, like the fleet chain
        self.bad = bool(rng.random() < cfg.wire_outage_prob)
        self.chunks = 0
        self.corrupted = 0

    def transmit(self, chunk: Chunk) -> Chunk:
        """One chunk over the wire; returns it possibly bit-flipped."""
        self.bad = bool(self.rng.random()
                        < (self.stay_bad if self.bad else self.go_bad))
        self.chunks += 1
        ber = self.cfg.ber_bad if self.bad else self.cfg.ber_good
        if ber <= 0.0 or not chunk.data:
            return chunk
        nbits = len(chunk.data) * 8
        flips = int(self.rng.binomial(nbits, min(ber, 1.0)))
        if flips == 0:
            return chunk
        buf = np.frombuffer(chunk.data, np.uint8).copy()
        pos = self.rng.integers(0, nbits, size=flips)
        np.bitwise_xor.at(buf, pos // 8,
                          (1 << (pos % 8)).astype(np.uint8))
        self.corrupted += 1
        return replace(chunk, data=buf.tobytes())


# ---------------------------------------------------------------------------
# sender side
# ---------------------------------------------------------------------------

def epoch_chunk_budget(tau_s: float, rate_bps: float,
                       chunk_bytes: int) -> int:
    """Chunks one probe epoch affords: ⌊τ·r / (8·chunk_bytes)⌋ — the
    eq. 14/15 airtime budget expressed in wire units."""
    if tau_s <= 0.0 or rate_bps <= 0.0:
        return 0
    return int((tau_s * rate_bps) / (8.0 * chunk_bytes))


class ChunkedUploader:
    """Client-side resumable snapshot uploader (Alg. 2 under chunking).

    The eq. 14 allowance τ_extra splits evenly over the scheduled probe
    epochs (``tau_share``); each epoch carries
    ``min(pending, ⌊τ_share·r / (8·chunk_bytes)⌋)`` chunks, charged
    against the remaining allowance at their true airtime.  A transfer
    the current epoch cannot finish *stays in flight* and resumes at the
    next probe — the resumable alternative to ``OppTransmitter``'s
    all-or-nothing eq. 15 cancel."""

    def __init__(self, cfg: TransportConfig, tau_extra: float,
                 n_probes: int):
        self.cfg = cfg
        self.tau_left = float(tau_extra)
        self.tau_share = float(tau_extra) / max(int(n_probes), 1)
        self.chunks: List[Chunk] = []
        self.cursor = 0
        self.seq = 0                  # transfers started (snapshot nonce)

    @property
    def idle(self) -> bool:
        """No transfer in flight (never started, or fully handed off)."""
        return self.cursor >= len(self.chunks)

    @property
    def transfer_id(self) -> Optional[int]:
        return self.chunks[0].transfer_id if self.chunks else None

    def begin(self, payload: bytes) -> None:
        """Start a fresh transfer (only when idle — an in-flight snapshot
        is never abandoned mid-upload)."""
        if not self.idle:
            raise RuntimeError("a transfer is still in flight")
        self.seq += 1
        self.chunks = make_chunks(payload, self.cfg)
        self.cursor = 0

    def finish(self) -> None:
        """Close out the current transfer (handed off or abandoned); the
        next scheduled probe may ``begin`` a fresh snapshot."""
        self.chunks = []
        self.cursor = 0

    def take_epoch(self, rate_bps: float) -> List[Chunk]:
        """The chunks this probe epoch's budget affords, charged to the
        remaining eq. 14 allowance at their true airtime."""
        tau = min(self.tau_share, self.tau_left)
        n = min(len(self.chunks) - self.cursor,
                epoch_chunk_budget(tau, rate_bps, self.cfg.chunk_bytes))
        out = self.chunks[self.cursor:self.cursor + n]
        self.cursor += n
        sent = sum(len(c.data) for c in out)
        self.tau_left -= sent * 8.0 / max(rate_bps, 1e-9)
        return out
