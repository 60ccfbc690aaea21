"""Swarm membership and load store, gossip-replicated, owner-writes-only
(port of inferd_tpu/control/dht.py).

Every node publishes exactly ONE record, its own membership and load
entry, and only its owner ever writes it; a per-stage view is derived by
merging single-owner records (last writer wins on (version, ts)), so no
node can clobber another's entry. Records carry a liveness TTL: a dead
node's record expires and routing stops picking it. A withdrawn node
gossips a tombstone. Reads (`get_stage`, `get_all`) are local merges: a
routing hop costs no network round trip.

The transport is msgpack over UDP (utils/msgpack_lite, byte-identical to
the reference's frames): every gossip period a node pushes its full state
to `fanout` random peers and asks one peer for its state with a reply
(anti-entropy pull), and answers a `hello` with its full state (bootstrap).
A node whose hello went unanswered knocks again every period. One thread
per store receives datagrams and runs the period's tick; the node's HTTP
threads announce and read beside it, so every entry point takes the
store's one lock.

Determinism seams, as in the reference: `clock` replaces every time.time()
read, `rng` every random draw, and `transport` (an object with
`sendto(store, data, addr)`) replaces the socket. With all three injected,
`start_local()` starts the store without a socket or a thread: the caller
delivers datagrams into `_on_message` and calls `gossip_tick()` itself,
and the store is a state machine that replays byte for byte under a seed.
"""

from __future__ import annotations

import hashlib
import logging
import random
import select
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from inferd_tpu_torch.utils import msgpack_lite

log = logging.getLogger(__name__)

DEFAULT_TTL_S = 15.0
GOSSIP_PERIOD_S = 1.0
GOSSIP_FANOUT = 3
MAX_DATAGRAM = 65535


def sess_hash(session_id: str) -> str:
    """The short stable hash a node's record advertises for each session
    whose KV it holds (the `sess` list): 64 bits of blake2b, hex, as the
    reference's. A collision's worst case routes a chunk to a replica
    without the session, which answers 409 and the client restarts."""
    return hashlib.blake2b(session_id.encode(), digest_size=8).hexdigest()


class Record:
    """One owner's entry: value + (version, ts) for the LWW merge."""

    __slots__ = ("owner", "value", "version", "ts", "addr", "_wire", "_wire_key")

    def __init__(self, owner: str, value: Any, version: int, ts: float, addr: Tuple[str, int]):
        self.owner = owner
        self.value = value
        self.version = version
        self.ts = ts
        self.addr = tuple(addr)
        self._wire: Optional[Dict[str, Any]] = None
        self._wire_key: Tuple[int, float] = (-1, 0.0)

    def refresh_ts(self, ts: float) -> None:
        """A liveness heartbeat: a new ts, patched into the cached wire dict."""
        self.ts = ts
        if self._wire is not None:
            self._wire["ts"] = ts
            self._wire_key = (self.version, ts)

    def to_wire(self) -> Dict[str, Any]:
        """The record's frame dict, cached per (version, ts); read only."""
        key = (self.version, self.ts)
        if self._wire is None or self._wire_key != key:
            self._wire = {
                "owner": self.owner,
                "value": self.value,
                "version": self.version,
                "ts": self.ts,
                "addr": list(self.addr),
            }
            self._wire_key = key
        return self._wire

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "Record":
        value = d["value"]
        if isinstance(value, dict):
            value = {sys.intern(k): v for k, v in value.items()}
        return Record(
            sys.intern(str(d["owner"])), value, int(d["version"]),
            float(d["ts"]), tuple(d["addr"]),
        )


class SwarmDHT:
    """Gossip store. One instance per node process."""

    def __init__(
        self,
        node_id: str,
        port: int,
        bootstrap: Optional[List[Tuple[str, int]]] = None,
        ttl_s: float = DEFAULT_TTL_S,
        gossip_period_s: float = GOSSIP_PERIOD_S,
        host: str = "0.0.0.0",
        clock: Callable[[], float] = time.time,
        rng: Optional[random.Random] = None,
        transport: Optional[Any] = None,
        fanout: int = GOSSIP_FANOUT,
        anti_entropy_every: int = 1,
    ):
        self.node_id = node_id
        self.host = host
        self.port = port
        self.bootstrap = [tuple(b) for b in (bootstrap or [])]
        self.ttl_s = ttl_s
        self.gossip_period_s = gossip_period_s
        self._clock = clock
        self._rng: Any = rng if rng is not None else random
        self._ext_transport = transport
        self.fanout = int(fanout)
        self.anti_entropy_every = max(1, int(anti_entropy_every))
        self._tick_n = 0

        self._records: Dict[str, Record] = {}  # owner -> record
        self._own_value: Dict[str, Any] = {}
        self._own_version = 0
        self._peers: Dict[str, Tuple[str, int]] = {}  # owner -> gossip addr
        self._peer_seen: Dict[str, float] = {}  # owner -> last datagram ts
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started = False

    # ------------------------------------------------------------------ api

    def start_local(self) -> None:
        """Start over the injected in-process transport: no socket, no
        thread; the caller delivers datagrams and calls gossip_tick()."""
        if self._ext_transport is None:
            raise RuntimeError("start_local() requires an injected transport")
        with self._lock:
            self._started = True
            for addr in self.bootstrap:
                self._send({"t": "hello", "from": self.node_id, "port": self.port}, addr)

    def start(self) -> None:
        """Bind the UDP socket (port 0: an ephemeral port, adopted so hellos
        and our own record advertise a reachable address) and start the
        gossip thread. A failed bind raises."""
        if self._ext_transport is not None:
            self.start_local()
            return
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.bind((self.host, self.port))
        except OSError:
            sock.close()
            raise
        with self._lock:
            self._sock = sock
            self.port = sock.getsockname()[1]
            own = self._records.get(self.node_id)
            if own is not None:
                own.addr = (self.host, self.port)
                own._wire = None  # addr is not part of the wire-cache key
            self._started = True
            for addr in self.bootstrap:
                self._send({"t": "hello", "from": self.node_id, "port": self.port}, addr)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=f"gossip-{self.port}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the gossip thread and close the socket (no tombstone: call
        withdraw() first for a clean departure)."""
        with self._lock:
            self._started = False
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=10)
            if thread.is_alive():
                log.warning("gossip thread of %s did not stop", self.node_id)
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None

    def announce(self, value: Dict[str, Any], urgent: bool = True) -> None:
        """Publish or refresh this node's own record, the only write path.

        urgent=True gossips at once (join, withdraw); urgent=False only
        updates the local record for the periodic gossip to carry
        (per-request load ticks). The version bumps only when the value
        changes, floored at the epoch millisecond so a restarted node
        outranks its old records; an identical value is a heartbeat (a ts
        refresh)."""
        with self._lock:
            now = self._clock()
            cur = self._records.get(self.node_id)
            if (
                cur is not None
                and not self._own_value.get("_tombstone")
                and value == self._own_value
            ):
                cur.refresh_ts(now)
            else:
                self._own_version = max(self._own_version + 1, int(now * 1000.0))
                self._own_value = dict(value)
                self._records[self.node_id] = Record(
                    self.node_id, self._own_value, self._own_version, now,
                    (self.host, self.port),
                )
            if self._started and urgent:
                self._gossip_now()

    def withdraw(self) -> None:
        """Announce departure (a tombstone gossiped at once)."""
        self.announce({"_tombstone": True})

    def kill(self) -> None:
        """A hard crash: the socket closes with no tombstone, and peers learn
        of the death only when the record's TTL runs out."""
        self.stop()

    # -- reads (local, already merged) ------------------------------------

    def alive_records(self) -> List[Record]:
        with self._lock:
            now = self._clock()
            return [
                r for r in self._records.values()
                if not r.value.get("_tombstone") and now - r.ts <= self.ttl_s
            ]

    def get_stage(self, stage: int) -> Dict[str, Dict[str, Any]]:
        """{node_id: value} of the live records serving `stage`."""
        return {
            r.owner: r.value
            for r in self.alive_records()
            if r.value.get("stage") == stage
        }

    def get_all(self, num_stages: Optional[int] = None) -> Dict[int, Dict[str, Dict[str, Any]]]:
        """{stage: {node_id: value}} of every live record; with num_stages,
        every stage below it present, empty or not."""
        out: Dict[int, Dict[str, Dict[str, Any]]] = {}
        for r in self.alive_records():
            s = r.value.get("stage")
            if s is None:
                continue
            out.setdefault(int(s), {})[r.owner] = r.value
        if num_stages is not None:
            for s in range(num_stages):
                out.setdefault(s, {})
        return out

    def peers(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._peers.values())

    # ------------------------------------------------------------ internals

    def _run(self) -> None:
        """The gossip thread: receive datagrams, and tick once a period."""
        next_tick = time.monotonic() + self.gossip_period_s
        while not self._stop.is_set():
            sock = self._sock
            if sock is None:
                return
            wait = max(0.0, next_tick - time.monotonic())
            try:
                ready, _, _ = select.select([sock], [], [], min(wait, 0.25))
                if ready:
                    data, addr = sock.recvfrom(MAX_DATAGRAM)
                    self._on_datagram(data, addr)
            except (OSError, ValueError):  # the socket closed under us: stopping
                if self._stop.is_set():
                    return
                log.exception("gossip receive failed")
            if time.monotonic() >= next_tick:
                next_tick = time.monotonic() + self.gossip_period_s
                try:
                    self.gossip_tick()
                except Exception:  # a tick must never end the thread
                    log.exception("gossip tick failed")

    def _on_datagram(self, data: bytes, addr: Tuple[str, int]) -> None:
        try:
            msg = msgpack_lite.unpackb(data)
        except ValueError:
            return
        if not isinstance(msg, dict):
            return
        try:
            self._on_message(msg, addr)
        except Exception:  # a malformed frame must not end the thread
            log.debug("gossip frame from %s dropped", addr, exc_info=True)

    def _send(self, msg: Dict[str, Any], addr: Tuple[str, int]) -> None:
        self._send_raw(msgpack_lite.packb(msg), addr)

    def _send_raw(self, data: bytes, addr: Tuple[str, int]) -> None:
        if self._ext_transport is not None:
            if self._started:
                self._ext_transport.sendto(self, data, tuple(addr))
            return
        if self._sock is None:
            return
        try:
            self._sock.sendto(data, tuple(addr))
        except OSError as e:  # e.g. EMSGSIZE: must not die silently
            log.warning("gossip send to %s failed: %s", addr, e)

    def _wire_records(self) -> List[Dict[str, Any]]:
        return [r.to_wire() for r in self._records.values()]

    def _prune(self) -> None:
        """Drop long-dead records (expired ones after 2x ttl, tombstones
        after 3x, so the deletion propagates first) and record-less peers
        whose datagrams stopped."""
        now = self._clock()
        drop = [
            owner
            for owner, r in self._records.items()
            if owner != self.node_id
            and now - r.ts > self.ttl_s * (3.0 if r.value.get("_tombstone") else 2.0)
        ]
        for owner in drop:
            del self._records[owner]
            self._peers.pop(owner, None)
            self._peer_seen.pop(owner, None)
        stale_peers = [
            p
            for p in self._peers
            if p not in self._records
            and now - self._peer_seen.get(p, 0.0) > self.ttl_s * 2.0
        ]
        for p in stale_peers:
            self._peers.pop(p, None)
            self._peer_seen.pop(p, None)

    def _merge(
        self,
        wire_records: List[Dict[str, Any]],
        sender: Tuple[str, int],
        sender_id: Optional[str] = None,
    ) -> None:
        """The reference's merge, rule for rule: our own record is never
        taken from a peer; a frame of the version we hold refreshes its ts
        in place; a higher (version, ts) replaces it; an exact tie keeps
        the first seen. Gossip addresses are learned from every record,
        an unroutable bind address (0.0.0.0) corrected from the datagram's
        source for the sender's own record only."""
        for w in wire_records:
            try:
                owner = w["owner"]
                if owner == self.node_id:
                    continue
                cur = self._records.get(owner)
                if cur is not None and int(w["version"]) == cur.version:
                    ts = float(w["ts"])
                    if ts > cur.ts:
                        cur.refresh_ts(ts)
                    addr = cur.addr
                elif cur is None or (
                    (int(w["version"]), float(w["ts"])) > (cur.version, cur.ts)
                ):
                    rec = Record.from_wire(w)
                    self._records[rec.owner] = rec
                    owner, addr = rec.owner, rec.addr
                else:
                    addr = tuple(w["addr"])
            except Exception:
                continue
            if addr[0] in ("0.0.0.0", "::"):
                if owner == sender_id:
                    addr = (sender[0], addr[1])
                else:
                    continue
            self._peers[owner] = addr

    def _on_message(self, msg: Dict[str, Any], addr: Tuple[str, int]) -> None:
        with self._lock:
            t = msg.get("t")
            if t == "hello":
                # an advertised port of 0 means the sender bound ephemerally
                # and did not know its port: the datagram's source is the truth
                peer_port = int(msg.get("port", addr[1])) or addr[1]
                peer_id = msg.get("from", f"{addr[0]}:{peer_port}")
                self._peers[peer_id] = (addr[0], peer_port)
                self._peer_seen[peer_id] = self._clock()
                self._send(
                    {"t": "state", "from": self.node_id, "recs": self._wire_records()},
                    (addr[0], peer_port),
                )
            elif t in ("state", "gossip"):
                # every send leaves the sender's bound gossip socket: the
                # datagram's source IS its listening address
                sender_id = msg.get("from")
                if sender_id and sender_id != self.node_id:
                    self._peers[sender_id] = addr
                    self._peer_seen[sender_id] = self._clock()
                self._merge(msg.get("recs", []), addr, sender_id=sender_id)
                if t == "state" and msg.get("reply", False):
                    self._send(
                        {"t": "state", "from": self.node_id,
                         "recs": self._wire_records(), "reply": False},
                        addr,
                    )

    def _gossip_now(self) -> None:
        self._prune()
        targets = list(self._peers.values()) or list(self.bootstrap)
        self._rng.shuffle(targets)
        # one serialization per fanout round: the same frame to every target
        data = msgpack_lite.packb(
            {"t": "gossip", "from": self.node_id, "recs": self._wire_records()})
        for addr in targets[: self.fanout]:
            self._send_raw(data, addr)

    def gossip_tick(self) -> None:
        """One gossip period's work: liveness heartbeat, bootstrap retry,
        fanout push, anti-entropy pull (every anti_entropy_every-th tick)."""
        with self._lock:
            own = self._records.get(self.node_id)
            if own is not None and not own.value.get("_tombstone"):
                own.refresh_ts(self._clock())
            if not self._peers and self.bootstrap:
                for addr in self.bootstrap:
                    self._send({"t": "hello", "from": self.node_id, "port": self.port}, addr)
            self._gossip_now()
            self._tick_n += 1
            peers = list(self._peers.values())
            if peers and self._tick_n % self.anti_entropy_every == 0:
                self._send(
                    {"t": "state", "from": self.node_id,
                     "recs": self._wire_records(), "reply": True},
                    self._rng.choice(peers),
                )
