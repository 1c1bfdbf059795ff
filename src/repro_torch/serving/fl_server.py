"""Fault-tolerant FL aggregation service: the long-lived serving path
(``repro/serving/fl_server.py``).

The server wraps the host reference engine (``HSFLSimulation`` with
``use_fused_round=False``) behind

  - a **client registry**: clients join and drop mid-training (from the
    next round on), round ids are monotonic, staleness is tracked;
  - an **idempotent inbox**: every upload is a CRC-checked message keyed by
    ``(round, client, kind)``; duplicates are rejected without touching
    aggregation, stale round ids refused, corrupt payloads NACKed so the
    client re-sends under ``core.faults.retry_call`` backoff;
  - a **quorum-or-deadline close**: too few timely finals hold the round
    open for late uploads before the scheme's rescue/delayed path;
  - **checkpoint/resume**: after each round the whole resume state
    (params, straggler carry, fleet state, every RNG state, registry,
    metrics) commits through ``checkpoint/msgpack_ckpt``; a killed server
    restarts from ``latest_step`` and replays the interrupted round
    bit for bit on the same device;
  - **fault injection**: a seeded ``core.faults.FaultPlan`` perturbs the
    transport and the server itself; ``run_with_restarts`` is the
    supervisor that eats crashes and resumes.

Trees cross the wire as numpy (msgpack payloads, the reference's bytes)
and come back onto the server's device.  With an empty (or recoverable)
fault plan the server reproduces the host engine bit for bit.
``FLServer(cfg, device=None)`` runs on the CUDA card and raises without
one; ``device="cpu"`` runs the delta codec's plain twins.
"""
from __future__ import annotations

import json
import math
import os
import zlib
from dataclasses import asdict, dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.msgpack_ckpt import (_decode_leaf, _encode_leaf,
                                                 as_like, latest_step, packb,
                                                 restore_aux,
                                                 restore_checkpoint,
                                                 save_checkpoint, unpackb)
from repro_torch.core.faults import (BackoffPolicy, CorruptPayload,
                                     RetriesExhausted, ServerCrash,
                                     UploadTimeout, as_fault_plan,
                                     client_rng, retry_call)
from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation, _k_bucket
from repro_torch.core.metrics import RoundLog, SimLog
from repro_torch.core.transmission import OppTransmitter
from repro_torch.core.transport import (ChunkedUploader, LossyWire,
                                        TransferLedger, TransportConfig,
                                        make_chunks)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["ClientRegistry", "FLServer", "METRICS_SCHEMA", "UploadMsg",
           "run_with_restarts"]

# metrics.jsonl record schema: bump when the per-round row shape changes
# (2 = lossy-wire transport counters + this version field)
METRICS_SCHEMA = 2


# ---------------------------------------------------------------------------
# wire format: msgpack-encoded pytrees with a CRC32 trailer
# ---------------------------------------------------------------------------

def encode_tree(tree: Any) -> bytes:
    """Serialize a parameter tree to wire bytes (checkpoint leaf codec)."""
    return packb([_encode_leaf(x) for x in tree_leaves(tree)])


def decode_tree(payload: bytes, like: Any) -> Any:
    """Inverse of ``encode_tree`` into the structure of ``like`` (tensor
    leaves come back on the device of ``like``'s)."""
    enc = unpackb(payload)
    refs = tree_leaves(like)
    if len(enc) != len(refs):
        raise ValueError(f"upload has {len(enc)} leaves, expected "
                         f"{len(refs)}")
    return tree_unflatten(like, iter(
        as_like(_decode_leaf(d), r) for d, r in zip(enc, refs)))


@dataclass
class UploadMsg:
    """One client→server delivery attempt."""
    client_id: int
    round_id: int
    kind: str                      # "final" | "snapshot"
    seq: int                       # client-side attempt nonce
    payload: bytes
    crc: int
    wire_bytes: float              # the *accounted* channel payload (eq. 13)

    @classmethod
    def build(cls, client_id: int, round_id: int, kind: str, seq: int,
              tree: Any, wire_bytes: float) -> "UploadMsg":
        """``tree`` may be a pytree or pre-encoded wire bytes (the chunked
        transport reassembles payloads without re-decoding them)."""
        payload = tree if isinstance(tree, bytes) else encode_tree(tree)
        return cls(client_id, round_id, kind, seq, payload,
                   zlib.crc32(payload), wire_bytes)

    def corrupted(self) -> "UploadMsg":
        """A copy with one payload byte flipped (CRC now mismatches)."""
        i = len(self.payload) // 2
        bad = self.payload[:i] + bytes([self.payload[i] ^ 0xFF]) \
            + self.payload[i + 1:]
        return replace(self, payload=bad)


# ---------------------------------------------------------------------------
# client registry
# ---------------------------------------------------------------------------

@dataclass
class ClientRecord:
    client_id: int
    joined_round: int = 1          # first round the client is schedulable
    dropped_round: Optional[int] = None   # drop takes effect *during* this
    last_upload: Optional[int] = None     # last round an upload was accepted
    uploads: int = 0


class ClientRegistry:
    """Who is in the fleet, since when, and how stale they are.

    Round ids are monotonic; joins take effect next round (a client
    registering *during* round t first becomes schedulable at t+1) and so
    do drops (the client leaves the candidate set from ``dropped_round``
    on).  A client vanishing *inside* a round — trained but never
    delivered — is the transport-level ``drop`` fault of
    ``core.faults.FaultPlan``.
    """

    def __init__(self, client_ids=()):
        self._rec: Dict[int, ClientRecord] = {
            int(c): ClientRecord(int(c)) for c in client_ids}

    def register(self, client_id: int, current_round: int = 0) -> ClientRecord:
        """Join (or re-join) the fleet, schedulable from the next round."""
        cid = int(client_id)
        rec = self._rec.get(cid)
        if rec is None or rec.dropped_round is not None:
            rec = ClientRecord(cid, joined_round=current_round + 1)
            self._rec[cid] = rec
        return rec

    def drop(self, client_id: int, at_round: int) -> None:
        """Leave the fleet: not schedulable from ``at_round`` onwards."""
        rec = self._rec.get(int(client_id))
        if rec is not None and rec.dropped_round is None:
            rec.dropped_round = int(at_round)

    def schedulable(self, client_id: int, round_id: int) -> bool:
        rec = self._rec.get(int(client_id))
        return (rec is not None and rec.joined_round <= round_id
                and (rec.dropped_round is None
                     or rec.dropped_round > round_id))

    def is_dropped(self, client_id: int, round_id: int) -> bool:
        rec = self._rec.get(int(client_id))
        return rec is not None and rec.dropped_round is not None \
            and rec.dropped_round <= round_id

    def record_upload(self, client_id: int, round_id: int) -> None:
        rec = self._rec.get(int(client_id))
        if rec is not None:
            rec.last_upload = round_id
            rec.uploads += 1

    def staleness(self, client_id: int, round_id: int) -> Optional[int]:
        """Rounds since the last accepted upload (None = never uploaded)."""
        rec = self._rec.get(int(client_id))
        if rec is None or rec.last_upload is None:
            return None
        return round_id - rec.last_upload

    def records(self) -> List[ClientRecord]:
        return [self._rec[c] for c in sorted(self._rec)]

    # -- checkpoint round trip ----------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {str(c): asdict(r) for c, r in sorted(self._rec.items())}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ClientRegistry":
        reg = cls()
        for c, r in d.items():
            reg._rec[int(c)] = ClientRecord(**r)
        return reg


# ---------------------------------------------------------------------------
# the round inbox
# ---------------------------------------------------------------------------

class RoundInbox:
    """Per-round upload store: first valid delivery per (client, kind)
    wins; everything else is classified and counted, never aggregated."""

    def __init__(self, round_id: int):
        self.round_id = round_id
        self.accepted: Dict[Tuple[int, str], UploadMsg] = {}
        self.duplicates = 0
        self.stale = 0
        self.corrupt = 0

    def offer(self, msg: UploadMsg) -> str:
        """Classify a delivery: 'accepted' | 'duplicate' | 'stale' |
        'corrupt'.  Raises ``CorruptPayload`` on CRC mismatch (the NACK
        the client's retry loop consumes)."""
        if msg.round_id != self.round_id:
            self.stale += 1
            return "stale"
        if zlib.crc32(msg.payload) != msg.crc:
            self.corrupt += 1
            raise CorruptPayload(
                f"round {self.round_id} client {msg.client_id} "
                f"{msg.kind} seq {msg.seq}: CRC mismatch")
        key = (msg.client_id, msg.kind)
        prev = self.accepted.get(key)
        if prev is not None:
            if msg.kind == "final" or msg.seq == prev.seq:
                # re-delivery of an already-accepted upload: idempotent
                self.duplicates += 1
                return "duplicate"
            # a *newer* snapshot overwrites the previous one (Alg. 2
            # line 14/20: "Previous ω_i will be overwritten")
        self.accepted[key] = msg
        return "accepted"

    def get(self, client_id: int, kind: str) -> Optional[UploadMsg]:
        return self.accepted.get((client_id, kind))


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class FLServer:
    """Long-lived HSFL aggregation service over the host reference engine.

    Construct from an ``HSFLConfig``, then drive with ``step()`` /
    ``serve()``.  With ``ckpt_dir`` set, every completed round commits a
    resume checkpoint; constructing with ``resume=True`` (the default)
    picks up ``latest_step`` and continues bit-compatibly.
    """

    def __init__(self, cfg: HSFLConfig, *, device=None,
                 ckpt_dir: Optional[str] = None,
                 fault_plan=None, quorum: float = 0.0,
                 backoff: Optional[BackoffPolicy] = None,
                 eval_every: int = 1, resume: bool = True,
                 metrics_path: Optional[str] = None,
                 initial_clients=None, skip_crashes=frozenset(),
                 transport: Optional[TransportConfig] = None):
        if not (0.0 <= quorum <= 1.0):
            raise ValueError(f"quorum must lie in [0, 1], got {quorum}")
        # opt-in lossy wire (core.transport): chunked resumable uploads,
        # Gilbert–Elliott burst errors, XOR-parity erasure rescue.  None
        # keeps the legacy atomic-blob wire (and the bit-identical
        # host-loop trajectory contract).
        self.transport = transport.validate() if transport else None
        self._ledger = TransferLedger()
        # the service wraps the host reference path: per-client transmitters
        # and list-form aggregation are what an inbox can mediate
        self.cfg = replace(cfg, use_fused_round=False)
        self.sim = HSFLSimulation(self.cfg, device=device)
        self.faults = as_fault_plan(fault_plan)
        self.quorum = float(quorum)
        self.backoff = (backoff or BackoffPolicy()).validate()
        self.eval_every = int(eval_every)
        self.ckpt_dir = ckpt_dir
        self.metrics_path = metrics_path or (
            os.path.join(ckpt_dir, "metrics.jsonl") if ckpt_dir else None)
        self.skip_crashes = frozenset(skip_crashes)
        ids = (range(cfg.n_uavs) if initial_clients is None
               else initial_clients)
        self.registry = ClientRegistry(ids)
        self.round = 0                       # last *completed* round id
        self.log = SimLog()
        self._delayed: List[Tuple[Any, int]] = []   # async straggler carry
        if resume and ckpt_dir is not None:
            step = latest_step(ckpt_dir)
            if step is not None:
                self._restore(step)

    # -- public API ---------------------------------------------------------
    def register_client(self, client_id: int) -> ClientRecord:
        """Join mid-training: schedulable from the next round."""
        return self.registry.register(client_id, self.round)

    def drop_client(self, client_id: int, at_round: Optional[int] = None):
        """Leave mid-training: the client stops being scheduled from the
        next round (transport-level mid-round loss is the ``drop`` fault)."""
        self.registry.drop(client_id, self.round + 1 if at_round is None
                           else at_round)

    @property
    def params(self):
        return self.sim.params

    def step(self) -> RoundLog:
        """Run exactly one round (may raise ``ServerCrash`` under an
        injected crash; state is only committed on completion)."""
        t = self.round + 1
        rlog = self._run_round(t)
        self.round = t
        self.log.add(rlog)
        self._checkpoint(t)
        self._emit_metrics(rlog)
        return rlog

    def serve(self, rounds: Optional[int] = None, verbose: bool = False
              ) -> SimLog:
        """Run until round ``rounds`` (default ``cfg.rounds``)."""
        end = self.cfg.rounds if rounds is None else int(rounds)
        while self.round < end:
            rlog = self.step()
            if verbose and (rlog.round % 10 == 0 or rlog.round == 1):
                print(f"[serve/{self.cfg.scheme}] round {rlog.round}: "
                      f"acc={rlog.test_acc:.4f} "
                      f"arrived={rlog.arrived_final} "
                      f"rescued={rlog.used_snapshot} "
                      f"dup={rlog.duplicates_rejected} "
                      f"retries={rlog.retries}")
        return self.log

    # -- fault hooks --------------------------------------------------------
    def _crash_maybe(self, t: int, phase: str):
        if self.faults.crash_phase(t) == phase \
                and (t, phase) not in self.skip_crashes:
            if phase == "checkpoint":
                # die mid-save: step dir + payload written, COMMIT absent —
                # exactly the half-written save latest_step must skip
                self._write_half_checkpoint(t)
            raise ServerCrash(t, phase)

    # -- transport ----------------------------------------------------------
    def _fault_state(self, t: int, client_id: int,
                     fault_state: Dict[int, Dict[str, int]]
                     ) -> Dict[str, int]:
        return fault_state.setdefault(client_id, {
            "corrupt_left": self.faults.count("corrupt", t, client_id),
            "dropped": self.faults.count("drop", t, client_id),
            "partial": self.faults.count("partial", t, client_id),
            "seq": 0,
        })

    def _maybe_flip(self, t: int, client_id: int, tree: Any) -> Any:
        """The ``flip`` fault: seeded *pre-encode* bit flips in the upload
        copy.  The wire CRC is computed afterwards, so the corruption is
        CRC-clean — only a robust aggregate can absorb it.  Flipping the
        top exponent bit (30) turns any sub-unit weight into a huge
        (~1e37) outlier; if the result lands on exponent 255 (inf/NaN)
        the exponent LSB is flipped too, keeping the outlier *finite* —
        a NaN would poison even robust sorts at small cohort sizes."""
        n = self.faults.count("flip", t, client_id)
        if not n:
            return tree
        rng = np.random.default_rng(np.random.SeedSequence(
            (int(self.cfg.seed), int(t), int(client_id), 0xF11D)))
        leaves = tree_leaves(tree)
        out = [x.detach().cpu().numpy().copy() for x in leaves]
        elig = [i for i, x in enumerate(out) if x.dtype == np.float32]
        total = sum(out[i].size for i in elig)
        for pos in rng.integers(0, total, size=n):
            for i in elig:
                if pos < out[i].size:
                    flat = out[i].reshape(-1)
                    bits = flat.view(np.int32)
                    bits[pos] ^= np.int32(1 << 30)
                    if not np.isfinite(flat[pos]):
                        bits[pos] ^= np.int32(1 << 23)
                    break
                pos -= out[i].size
        return tree_unflatten(tree, iter(
            torch.from_numpy(x).to(x_dev.device)
            for x, x_dev in zip(out, leaves)))

    def _send(self, t: int, client_id: int, kind: str, tree: Any,
              wire_bytes: float, inbox: RoundInbox, rlog: RoundLog,
              fault_state: Dict[int, Dict[str, int]]) -> str:
        """One upload through the faulty transport with client-side
        retry/backoff.  ``tree`` may be pre-encoded wire bytes (the
        chunked transport's reassembled payload — flip/partial already
        applied at the chunk layer).  Returns 'accepted' | 'lost' |
        'deferred'."""
        fs = self._fault_state(t, client_id, fault_state)
        if not isinstance(tree, bytes):
            tree = self._maybe_flip(t, client_id, tree)
        if kind == "final" and self.faults.count("delay", t, client_id):
            # misses the deadline: parked for the quorum policy at close
            fs["seq"] += 1
            msg = UploadMsg.build(client_id, t, kind, fs["seq"], tree,
                                  wire_bytes)
            self._late.append(msg)
            return "deferred"

    # NB: bytes accounting — the *first* attempt's payload is already
    # counted by the OppTransmitter event log (host-loop parity); only
    # retries and duplicate deliveries add wire bytes on top.
        rng = client_rng(self.cfg.seed, t, client_id)
        attempt_no = {"n": 0}

        def attempt():
            attempt_no["n"] += 1
            if attempt_no["n"] > 1:
                rlog.bytes_sent += wire_bytes
            if kind == "final" and fs["dropped"]:
                raise UploadTimeout(f"client {client_id} round {t}: "
                                    f"black-holed")
            fs["seq"] += 1
            msg = UploadMsg.build(client_id, t, kind, fs["seq"], tree,
                                  wire_bytes)
            if fs["partial"] and kind == "final" \
                    and self.transport is None:
                # truncated blob on the legacy atomic wire: fails CRC on
                # *every* attempt — unrecoverable without chunking+parity
                try:
                    inbox.offer(replace(
                        msg, payload=msg.payload[:len(msg.payload) // 2]))
                finally:
                    rlog.corrupt_rejected += 1
                return None           # unreachable: offer raised
            if fs["corrupt_left"] > 0:
                fs["corrupt_left"] -= 1
                try:
                    inbox.offer(msg.corrupted())
                finally:
                    rlog.corrupt_rejected += 1
                return None           # unreachable: offer raised
            return inbox.offer(msg), msg

        try:
            res = retry_call(attempt, self.backoff, rng)
        except RetriesExhausted:
            rlog.retries += self.backoff.max_attempts - 1
            return "lost"
        rlog.retries += res.retries
        rlog.backoff_s += res.backoff_s
        status, msg = res.value
        if status != "accepted":
            return "lost"
        for _ in range(self.faults.count("dup", t, client_id)
                       if kind == "final" else 0):
            # duplicate deliveries: the inbox must reject them all
            if inbox.offer(msg) == "duplicate":
                rlog.duplicates_rejected += 1
                rlog.bytes_sent += wire_bytes
        return "accepted"

    # -- chunked lossy-wire transport (core.transport) ----------------------
    def _wire_for(self, t: int, client_id: int,
                  wires: Dict[int, LossyWire]) -> LossyWire:
        """The per-(round, client) Gilbert–Elliott burst-error wire; its
        RNG stream is independent of both the simulation RNG and the
        backoff jitter stream (fault handling never perturbs training)."""
        if client_id not in wires:
            wires[client_id] = LossyWire(
                self.transport, np.random.default_rng(np.random.SeedSequence(
                    (int(self.cfg.seed), int(t), int(client_id), 0x317E))))
        return wires[client_id]

    def _deliver_chunks(self, t: int, client_id: int, chunks,
                        wire: LossyWire, asm, rlog: RoundLog) -> None:
        """Push chunks over the lossy wire into the server-side assembler.
        A wire-corrupted chunk fails its CRC, is NACKed, and retransmits
        under the backoff policy; a chunk that exhausts its retries stays
        missing — the XOR parity group may still rebuild it."""
        rng = client_rng(self.cfg.seed, t, client_id)
        for ch in chunks:
            attempt_no = {"n": 0}

            def attempt(ch=ch):
                attempt_no["n"] += 1
                if attempt_no["n"] > 1:
                    rlog.chunks_retransmitted += 1
                    rlog.bytes_sent += len(ch.data)
                st = asm.add(wire.transmit(ch))
                if st == "corrupt":
                    rlog.chunks_corrupt += 1
                    raise CorruptPayload(
                        f"round {t} client {client_id}: chunk "
                        f"{ch.kind}[{ch.index}] of transfer "
                        f"{ch.transfer_id:#010x} corrupted on the wire")
                return st

            try:
                res = retry_call(attempt, self.backoff, rng)
            except RetriesExhausted:
                rlog.retries += self.backoff.max_attempts - 1
                continue                  # lost chunk; parity may rescue
            rlog.retries += res.retries
            rlog.backoff_s += res.backoff_s

    def _pump_snapshot(self, t: int, client_id: int, up: ChunkedUploader,
                       rate: float, inbox: RoundInbox, rlog: RoundLog,
                       fault_state, wires: Dict[int, LossyWire]) -> None:
        """One probe epoch of a chunked snapshot upload: send what the
        eq. 14 budget share affords, and hand the transfer off to the
        inbox once every chunk has been on the wire."""
        chunks = up.take_epoch(rate)
        if chunks:
            asm = self._ledger.assembler(client_id, chunks[0],
                                         self.transport)
            send = [c for c in chunks if c.key not in asm.have()]
            par = sum(len(c.data) for c in send if c.kind == "parity")
            rlog.chunks_sent += len(send)
            rlog.bytes_sent += sum(len(c.data) for c in send)
            rlog.parity_bytes += par
            self._deliver_chunks(t, client_id, send,
                                 self._wire_for(t, client_id, wires),
                                 asm, rlog)
        if up.idle and up.chunks:
            # every chunk had its chance on the wire: close the transfer
            self._finish_transfer(t, client_id, up, inbox, rlog,
                                  fault_state)

    def _finish_transfer(self, t: int, client_id: int, up: ChunkedUploader,
                         inbox: RoundInbox, rlog: RoundLog,
                         fault_state) -> str:
        """Close out an in-flight snapshot transfer: XOR-reconstruct what
        parity can, offer the reassembled payload to the inbox, or count
        the upload as lost.  Also the round-close rescue path for
        transfers whose budget ran out mid-upload."""
        asm = self._ledger.get(client_id, up.transfer_id) \
            if up.transfer_id is not None else None
        up.finish()
        if asm is None:
            rlog.transfers_incomplete += 1
            return "lost"
        rlog.chunks_recovered += asm.try_reconstruct()
        if not asm.complete():
            rlog.transfers_incomplete += 1
            return "lost"                 # assembler stays in the ledger:
        payload = asm.payload()           # a re-offer resumes from it
        self._ledger.pop(client_id, asm.transfer_id)
        return self._send(t, client_id, "snapshot", payload,
                          float(len(payload)), inbox, rlog, fault_state)

    def _send_final_transport(self, t: int, client_id: int, tree: Any,
                              wire_bytes: float, inbox: RoundInbox,
                              rlog: RoundLog, fault_state,
                              wires: Dict[int, LossyWire]) -> str:
        """The final upload over the chunked lossy wire.  ``partial``
        truncates the tail of the chunk sequence before it leaves the
        client; parity can rebuild at most one missing data chunk per
        group.  Data airtime is already accounted by the transmitter's
        final-upload event — only parity overhead adds wire bytes here."""
        fs = self._fault_state(t, client_id, fault_state)
        tree = self._maybe_flip(t, client_id, tree)
        payload = encode_tree(tree)
        if fs["dropped"]:
            # black-holed before the first chunk: legacy retry accounting
            rlog.retries += self.backoff.max_attempts - 1
            return "lost"
        if self.faults.count("delay", t, client_id):
            fs["seq"] += 1
            self._late.append(UploadMsg.build(
                client_id, t, "final", fs["seq"], payload, wire_bytes))
            return "deferred"
        chunks = make_chunks(payload, self.transport)
        if fs["partial"]:
            chunks = chunks[:max(0, len(chunks) - fs["partial"])]
        if not chunks:
            return "lost"
        asm = self._ledger.assembler(client_id, chunks[0], self.transport)
        send = [c for c in chunks if c.key not in asm.have()]
        par = sum(len(c.data) for c in send if c.kind == "parity")
        rlog.chunks_sent += len(send)
        rlog.bytes_sent += par
        rlog.parity_bytes += par
        self._deliver_chunks(t, client_id, send,
                             self._wire_for(t, client_id, wires), asm, rlog)
        rlog.chunks_recovered += asm.try_reconstruct()
        if not asm.complete():
            rlog.transfers_incomplete += 1
            return "lost"
        reassembled = asm.payload()
        self._ledger.pop(client_id, asm.transfer_id)
        return self._send(t, client_id, "final", reassembled, wire_bytes,
                          inbox, rlog, fault_state)

    # -- one round ----------------------------------------------------------
    def _run_round(self, t: int) -> RoundLog:
        cfg, sim = self.cfg, self.sim
        scheme = sim.scheme
        carry = list(self._delayed)
        self._late: List[UploadMsg] = []
        inbox = RoundInbox(t)

        sched, ue_bytes = sim._schedule_round()
        rlog = RoundLog(round=t, selected=len(sched))
        live = [u for u in sched if self.registry.schedulable(u.index, t)]
        rlog.unregistered_skipped = len(sched) - len(live)
        sched = live
        rlog.selected = len(sched)
        if not sched:
            # injected server crashes do not care whether anyone was
            # scheduled — fire the phase hooks even on an empty round
            self._crash_maybe(t, "train")
            self._crash_maybe(t, "close")
            self.sim.params = scheme.aggregate_host(
                [], carry, sim.params, cfg.async_alpha, cfg.async_a)
            self._delayed = []
            self._eval_round(rlog)
            return rlog

        txs: Dict[int, OppTransmitter] = {}
        for u in sched:
            payload = cfg.model_bytes if u.mode == "FL" else ue_bytes
            txs[u.index] = OppTransmitter(
                payload, cfg.local_epochs, cfg.b, u.rate0_bps,
                compress_ratio=sim.compress_ratio,
                schedule_override=cfg.schedule_override)

        K = _k_bucket(len(sched), cfg.k_select)
        stacked = sim.broadcast(K)

        def user_tree(i: int):
            return tree_map(lambda a: a[i], stacked)

        fault_state: Dict[int, Dict[str, int]] = {}
        wires: Dict[int, LossyWire] = {}
        uploaders: Dict[int, ChunkedUploader] = {}
        if self.transport is not None:
            for u in sched:
                tx = txs[u.index]
                uploaders[u.index] = ChunkedUploader(
                    self.transport, tx.tau_extra0, len(tx.schedule))
        # local training in lockstep; probe uploads ride the faulty
        # transport into the inbox (the server, not the transmitter, is
        # the durable holder of the latest snapshot)
        for e_t in range(1, cfg.local_epochs + 1):
            sim.fleet.move()
            rates = sim.fleet.rates()
            outages = sim.fleet.outages()
            stacked = sim._epoch_all(stacked, *sim.epoch_batches(sched, K))
            if sim._probe_epochs:
                for i, u in enumerate(sched):
                    tx = txs[u.index]
                    if e_t not in tx.schedule:
                        continue
                    if self.transport is not None:
                        # chunked resumable upload: an outage skips the
                        # epoch (the in-flight transfer survives it); an
                        # idle uploader starts shipping a fresh snapshot
                        if bool(outages[u.index]):
                            continue
                        up = uploaders[u.index]
                        if up.idle:
                            up.begin(encode_tree(self._maybe_flip(
                                t, u.index, sim.snapshot_of(user_tree(i)))))
                        self._pump_snapshot(t, u.index, up,
                                            float(rates[u.index]), inbox,
                                            rlog, fault_state, wires)
                    else:
                        sent = tx.maybe_transmit(
                            e_t, float(rates[u.index]),
                            bool(outages[u.index]),
                            lambda i=i: sim.snapshot_of(user_tree(i)))
                        if sent:
                            self._send(t, u.index, "snapshot", tx.snapshot,
                                       tx.payload_bytes, inbox, rlog,
                                       fault_state)
            if e_t == 1:
                self._crash_maybe(t, "train")

        # round-close rescue: transfers whose budget ran out mid-upload
        # get one XOR-parity reconstruction attempt before aggregation
        for u in sched:
            up = uploaders.get(u.index)
            if up is not None and up.chunks:
                self._finish_transfer(t, u.index, up, inbox, rlog,
                                      fault_state)

        # final uploads through the transport
        rates = sim.fleet.rates()
        outages = sim.fleet.outages()
        outcome: Dict[int, str] = {}
        for i, u in enumerate(sched):
            tx = txs[u.index]
            slack = float(scheme.final_slack(tx.tau_extra0))
            ok = tx.final_upload(float(rates[u.index]),
                                 bool(outages[u.index]),
                                 sim.train_time(u) + slack, cfg.tau_max)
            if ok and self.registry.is_dropped(u.index, t):
                outcome[u.index] = "lost"       # left mid-round
            elif ok and self.transport is not None:
                outcome[u.index] = self._send_final_transport(
                    t, u.index, user_tree(i), tx.payload_bytes,
                    inbox, rlog, fault_state, wires)
            elif ok:
                outcome[u.index] = self._send(
                    t, u.index, "final", user_tree(i), tx.payload_bytes,
                    inbox, rlog, fault_state)
            else:
                outcome[u.index] = "missed"     # channel/deadline, no send
            rlog.bytes_sent += tx.bytes_sent
            if u.mode == "SL" and tx.events:
                wl = sim.workloads[u.index]
                rlog.bytes_sent += wl.act_bytes_per_sample * wl.samples

        self._crash_maybe(t, "close")

        # quorum-or-deadline close: too few timely finals -> hold the round
        # open and admit late uploads before degrading to the scheme path
        arrived_n = sum(1 for s in outcome.values() if s == "accepted")
        need = math.ceil(self.quorum * len(sched))
        rlog.quorum_met = arrived_n >= need
        for msg in self._late:
            if arrived_n < need and inbox.offer(msg) == "accepted":
                outcome[msg.client_id] = "accepted"
                rlog.late_accepted += 1
                arrived_n += 1
            else:
                inbox.stale += 1
                rlog.stale_rejected += 1
        self._late = []

        # close the round in schedule order (aggregation must not depend on
        # arrival order — that is what makes duplicates/permutations moot)
        arrived: List[Any] = []
        new_delayed: List[Tuple[Any, int]] = []
        for i, u in enumerate(sched):
            if outcome[u.index] == "accepted":
                msg = inbox.get(u.index, "final")
                arrived.append(decode_tree(msg.payload, sim.params))
                self.registry.record_upload(u.index, t)
                rlog.arrived_final += 1
            elif scheme.uses_probes \
                    and inbox.get(u.index, "snapshot") is not None:
                snap = inbox.get(u.index, "snapshot")
                arrived.append(decode_tree(snap.payload, sim.params))
                self.registry.record_upload(u.index, t)
                rlog.used_snapshot += 1
            elif scheme.carries_delayed \
                    and not self.registry.is_dropped(u.index, t):
                new_delayed.append((user_tree(i), 1))
                rlog.delayed += 1
            else:
                rlog.dropped += 1

        self.sim.params = scheme.aggregate_host(
            arrived, carry, sim.params, cfg.async_alpha, cfg.async_a)
        self._delayed = new_delayed
        self._eval_round(rlog)
        return rlog

    def _eval_round(self, rlog: RoundLog):
        if rlog.round % self.eval_every == 0 \
                or rlog.round == self.cfg.rounds:
            rlog.test_loss, rlog.test_acc = self.sim.evaluate()

    # -- checkpoint / resume -------------------------------------------------
    def _ckpt_tree(self) -> Any:
        fleet = self.sim.fleet
        return {
            "params": self.sim.params,
            "delayed": [tr for tr, _ in self._delayed],
            "fleet_pos": np.asarray(fleet.pos),
            "fleet_kdb": np.asarray(fleet.k_db),
            "fleet_bad": np.asarray(fleet._bad),
        }

    def _ckpt_aux(self, t: int) -> Dict[str, Any]:
        return {
            "round": t,
            "scheme": self.cfg.scheme,
            "seed": self.cfg.seed,
            "delayed_staleness": [int(s) for _, s in self._delayed],
            "sim_rng": self.sim.rng.bit_generator.state,
            "fleet_rng": self.sim.fleet.rng.bit_generator.state,
            "registry": self.registry.to_json(),
            "rounds_log": [asdict(r) for r in self.log.rounds],
        }

    def _checkpoint(self, t: int):
        if self.ckpt_dir is None:
            return
        self._crash_maybe(t, "checkpoint")
        save_checkpoint(self.ckpt_dir, t, self._ckpt_tree(),
                        aux=self._ckpt_aux(t))

    def _write_half_checkpoint(self, t: int):
        """A crashed writer: payload on disk, COMMIT never lands."""
        path = save_checkpoint(self.ckpt_dir, t, self._ckpt_tree(),
                               aux=self._ckpt_aux(t))
        os.remove(os.path.join(path, "COMMIT"))

    def _restore(self, step: int):
        aux = restore_aux(self.ckpt_dir, step)
        if aux is None:
            raise ValueError(
                f"checkpoint step {step} in {self.ckpt_dir} has no aux.json "
                f"resume state (not an FLServer checkpoint?)")
        n_delayed = len(aux["delayed_staleness"])
        like = {
            "params": self.sim.params,
            "delayed": [self.sim.params] * n_delayed,
            "fleet_pos": np.asarray(self.sim.fleet.pos),
            "fleet_kdb": np.asarray(self.sim.fleet.k_db),
            "fleet_bad": np.asarray(self.sim.fleet._bad),
        }
        tree = restore_checkpoint(self.ckpt_dir, step, like)
        self.sim.params = tree["params"]
        self._delayed = list(zip(tree["delayed"],
                                 aux["delayed_staleness"]))
        fleet = self.sim.fleet
        fleet.pos = np.asarray(tree["fleet_pos"])
        fleet.k_db = np.asarray(tree["fleet_kdb"])
        fleet._bad = np.asarray(tree["fleet_bad"])
        self.sim.rng.bit_generator.state = aux["sim_rng"]
        fleet.rng.bit_generator.state = aux["fleet_rng"]
        self.registry = ClientRegistry.from_json(aux["registry"])
        self.round = int(aux["round"])
        self.log = SimLog()
        for r in aux["rounds_log"]:
            self.log.add(RoundLog(**r))

    # -- metrics log ---------------------------------------------------------
    def _emit_metrics(self, rlog: RoundLog):
        if self.metrics_path is None:
            return
        stal = [self.registry.staleness(r.client_id, rlog.round)
                for r in self.registry.records()]
        stal = [s for s in stal if s is not None]
        row = dict(asdict(rlog), schema=METRICS_SCHEMA,
                   scheme=self.cfg.scheme,
                   seed=self.cfg.seed,
                   registered=len(self.registry.records()),
                   mean_staleness=(float(np.mean(stal)) if stal else None))
        os.makedirs(os.path.dirname(os.path.abspath(self.metrics_path)),
                    exist_ok=True)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def run_with_restarts(cfg: HSFLConfig, *, ckpt_dir: str, fault_plan=None,
                      rounds: Optional[int] = None, max_restarts: int = 10,
                      verbose: bool = False, **server_kw
                      ) -> Tuple[FLServer, int]:
    """Run a server to completion, eating injected crashes: each
    ``ServerCrash`` is marked consumed and a *fresh* server resumes from
    the latest committed checkpoint.  Returns (server, n_restarts).
    ``server_kw`` goes to ``FLServer`` (``device`` among them)."""
    plan = as_fault_plan(fault_plan)
    consumed: set = set()
    restarts = 0
    while True:
        server = FLServer(cfg, ckpt_dir=ckpt_dir, fault_plan=plan,
                          skip_crashes=frozenset(consumed), **server_kw)
        try:
            server.serve(rounds=rounds, verbose=verbose)
            return server, restarts
        except ServerCrash as e:
            consumed.add((e.round_id, e.phase))
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"server crashed {restarts} times; giving up") from e
            if verbose:
                print(f"[supervisor] crash at round {e.round_id} "
                      f"({e.phase}); restarting from "
                      f"step {latest_step(ckpt_dir)}")
