"""Multi-tenant LoRA serving: the adapter registry and the session-to-slot
binding of the lane executors (port of inferd_tpu/runtime/adapters.py).

The registry holds a CATALOG of peft adapter directories (`run_node
--adapters DIR[,DIR...]`) and a bounded set of device-resident SLOTS:
stacked pools [slots, L, in, r] (A) and [slots, L, r, out] (B) per
targeted projection, slot 0 permanently the all-zero base adapter. A
session admitted with an `adapter` envelope key binds a slot; the lane
executor hands every dispatch the pools plus per-lane slot ids, and each
projection adds its lanes' deltas (ops.lora.apply_lane_delta), so a window
mixing tenants is one dispatch.

Slots are REFCOUNTED (a live session's adapter is never evicted), idle
unpinned slots are evicted least recently used first when a cache-miss
admission needs one, and pins keep operator-chosen tenants resident.
Loads run on the admission path: the disk read and padding with no lock
held, the splice into the pools under the registry's lock, never inside a
decode window. Lock order: the executor's `_mu` before the registry's.

What differs from the reference, by PyTorch idiom: the pools are written
IN PLACE (`pool[slot].copy_(...)`, a blocking host-to-device copy) where
the reference replaces them functionally. That is safe because the slot
being written has no live reference, and the copy and every dispatch run
on the same CUDA stream, so dispatches enqueued before the copy read the
old rows and later ones the new.

Routing across nodes: a replica gossips its resident names as a bounded
`ada` field (`resident_names`, runtime/node.announce), and
`AdapterAffinity` plugs into the duck-typed `affinity=` seam both routers
score prefix digests through (control/path_finder._rank_key and
control/dstar.node_cost): a holder earns the bounded CACHE_AFFINITY_BONUS,
suppressed on a shedding or draining replica and dominated by the outlier
penalty, so a cold healthy replica still beats a sick holder, and a miss is
a hot-load on the landing replica, never a reject. `combine_affinity`
composes it with the prefix probe; `registry_can_serve` is the standby
receiver's check. The fleet simulator imports the scorers too.

Not ported: the event journal (`on_event` stays a plain callable hook) and
lockwatch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.core.cache import host_staged, host_to_device
from inferd_tpu_torch.ops import lora as loralib
from inferd_tpu_torch.utils import safetensors_io


#: Resident-adapter names a replica gossips (the `ada` record field). Names
#: are short operator-chosen ids, so 32 of them stay well under the `pfx`
#: digest's wire budget; a replica with more residents advertises its most
#: recently used ones (stale affinity only ever misses a bonus: the landing
#: replica hot-loads).
ADA_GOSSIP_MAX = 32


class AdapterCapacityError(RuntimeError):
    """Every slot is held by a live session or a pin: transient
    backpressure (the node maps it to a retryable 503 `busy`)."""


class UnknownAdapterError(ValueError):
    """The payload names an adapter outside this node's catalog: a
    permanent configuration or routing error. The node maps it to a
    non-retryable 409 `unknown_adapter`, never the `session_state` code
    that would send the client into a restart loop failing identically."""


class AdapterAffinity:
    """One session's adapter-affinity matcher against gossiped `ada` fields,
    duck-typed like core.prefix.AffinityProbe (`depth_frac(record)` in
    0..1), so both routers apply the same bounded bonus."""

    def __init__(self, name: str):
        self.name = str(name)

    def depth_frac(self, record: Dict[str, Any]) -> float:
        ada = record.get("ada")
        if not isinstance(ada, (list, tuple)):
            return 0.0
        return 1.0 if self.name in ada else 0.0


class _MaxAffinity:
    """The max over several affinity scorers (prefix digest and adapter
    residency): the combined bonus never exceeds one CACHE_AFFINITY_BONUS."""

    def __init__(self, parts):
        self.parts = parts

    def depth_frac(self, record: Dict[str, Any]) -> float:
        best = 0.0
        for p in self.parts:
            try:
                best = max(best, float(p.depth_frac(record)))
            except Exception:
                continue  # a malformed record must never break routing
        return best


def combine_affinity(*parts):
    """One affinity object over the scorers that are not None (None when
    none is): what a router passes as `affinity=` for a session with both a
    prompt prefix probe and a tenant adapter."""
    live = [p for p in parts if p is not None]
    if not live:
        return None
    if len(live) == 1:
        return live[0]
    return _MaxAffinity(live)


def registry_can_serve(executor, name: Optional[str]) -> bool:
    """Could `executor` ever bind adapter `name` (None, a base session:
    always)? What a standby receiver checks before it keeps a tenant
    session's shadow: a peer without a registry, or whose catalog lacks the
    name, would decline at promotion anyway."""
    if name is None:
        return True
    reg = getattr(executor, "adapters", None)
    return reg is not None and str(name) in reg.catalog


def parse_adapter_dirs(spec: str) -> Dict[str, str]:
    """`DIR[,DIR...]` -> {name: path}, the name being the directory's
    basename (the `adapter` envelope key tenants address). Duplicate names
    are a configuration error."""
    out: Dict[str, str] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name = os.path.basename(os.path.normpath(part))
        if not name:
            raise ValueError(f"--adapters entry {part!r} has no basename")
        if name in out:
            raise ValueError(
                f"--adapters names collide on {name!r} "
                f"({out[name]} vs {part}) — adapter names must be unique"
            )
        out[name] = part
    return out


def _emit(hook, event: str, **attrs) -> None:
    """Call the registry's event hook; a failing hook never fails a load."""
    if hook is None:
        return
    try:
        hook(event, **attrs)
    except Exception:
        pass


class AdapterBindingMixin:
    """Session-to-slot plumbing of the lane executor, which provides
    `self.adapters`, `self._session_adapter`, `self._lane_slot` and
    `self._mu` (held before the registry's lock, everywhere)."""

    def _ads(self, ids, staged: bool = False) -> Optional[Dict[str, Any]]:
        """The adapter operand of ONE dispatch: the registry's pools plus
        these per-lane int32 slot ids, uploaded, or with `staged` left on
        the host for a lane decode graph's static input (core.cache.
        host_staged: one copy, straight into it); or None (no registry,
        nothing loaded, or every lane on slot 0: an all-base dispatch
        computes no delta, launches nothing, and replays a graph of its
        own)."""
        if self.adapters is None:
            return None
        if not any(int(i) for i in ids):
            return None
        pools = self.adapters.device_adapters()
        if pools is None:
            return None
        dev = pools["scale"].device
        put = host_staged if staged else host_to_device
        return {**pools, "ids": put(np.asarray(ids, np.int32), dev)}

    def _resolve_adapter(self, session_id: str, payload: Dict[str, Any], start_pos: int):
        """Resolve the payload's `adapter` key BEFORE any executor lock: a
        cache-miss admission hot-loads here (disk read and upload, under the
        registry's own lock only). Returns [name, ref_taken] or None (the
        base adapter)."""
        name = payload.get("adapter")
        if name is None:
            return None
        name = str(name)
        if self.adapters is None:
            raise ValueError(
                f"session {session_id}: payload names adapter {name!r} "
                "but this replica serves no adapter registry (--adapters)"
                " — serving the base model instead would be silent "
                "tenant corruption"
            )
        if start_pos > 0:
            # later chunks may restate the adapter; a mismatch is a routing
            # bug, raised, never served with other weights
            with self._mu:
                have = self._session_adapter.get(session_id)
            if have != name:
                raise ValueError(
                    f"session {session_id}: mid-session adapter "
                    f"{name!r} != admitted {have!r}"
                )
            return [name, False]
        self.adapters.acquire(name)  # may hot-load
        return [name, True]

    def _bind_adapter_locked(self, session_id: str, lane: int, start_pos: int, acquired) -> None:
        """Admission-time binding (under self._mu): a new admission
        (start_pos 0) consumes the reference taken by _resolve_adapter, a
        restart under the same id swaps references, and the lane's slot
        mirror is what the dispatches gather ids from."""
        if start_pos != 0:
            return
        self._release_adapter_locked(session_id)
        if acquired is not None:
            self._session_adapter[session_id] = acquired[0]
            self._lane_slot[lane] = self.adapters.slot_of(acquired[0])
            acquired[1] = False  # the session holds the reference now
        else:
            self._lane_slot[lane] = 0

    def _release_adapter_locked(self, session_id: str) -> None:
        """Drop a session's binding and its registry reference (teardown and
        restart; caller holds self._mu)."""
        name = self._session_adapter.pop(session_id, None)
        if name is not None and self.adapters is not None:
            self.adapters.release(name)

    def session_adapters(self) -> Dict[str, str]:
        """{session_id: adapter name} of the tenant sessions."""
        with self._mu:
            return dict(self._session_adapter)


class AdapterRegistry:
    """Device-resident stacked adapter pools with refcounted hot-load.

    `slots` counts ALL pool slots, the permanent zero base adapter at slot 0
    included, so slots=5 holds at most 4 tenants at once; the catalog may be
    far larger (cache-miss admissions hot-load over idle slots). The pools
    live on `device` in cfg's dtype, the scales in f32.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        dirs: Any,
        slots: int = 0,
        start_layer: int = 0,
        end_layer: Optional[int] = None,
        on_event=None,
        owner: str = "",
        device=None,
    ):
        if cfg.is_moe:
            raise ValueError(
                "the adapter registry targets dense decoder projections — "
                "MoE configs are unsupported (as in merge_adapter)"
            )
        if cfg.sliding_window > 0:
            raise ValueError(
                "the adapter registry does not support sliding-window "
                "models yet (ring-split KV stages bypass the batched "
                "apply) — serve --adapters on a uniform-layout model"
            )
        self.cfg = cfg
        self.owner = owner or "adapters"
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.catalog: Dict[str, str] = (
            dict(dirs) if isinstance(dirs, dict) else parse_adapter_dirs(
                ",".join(dirs) if isinstance(dirs, (list, tuple)) else dirs
            )
        )
        if not self.catalog:
            raise ValueError("--adapters: no adapter directories given")
        self.start_layer = int(start_layer)
        self.end_layer = int(cfg.num_layers if end_layer is None else end_layer)
        self.num_layers = self.end_layer - self.start_layer
        if self.num_layers <= 0:
            raise ValueError(
                f"{self.owner}: adapter registry layer slice "
                f"[{self.start_layer}, {self.end_layer}) is empty"
            )
        # pool rank = the catalog's largest: narrower adapters zero-pad (zero
        # rank rows add exactly nothing). The pools cover only the catalog's
        # target union: an attention-only catalog allocates no MLP pools and
        # pays no delta for them (apply_lane_delta passes those through)
        ranks, targets = zip(*(self._peek_meta(path) for path in self.catalog.values()))
        self.rank = max(ranks)
        dims_all = {
            "q_proj": (cfg.hidden_size, cfg.q_dim),
            "k_proj": (cfg.hidden_size, cfg.kv_dim),
            "v_proj": (cfg.hidden_size, cfg.kv_dim),
            "o_proj": (cfg.q_dim, cfg.hidden_size),
            "gate_proj": (cfg.hidden_size, cfg.intermediate_size),
            "up_proj": (cfg.hidden_size, cfg.intermediate_size),
            "down_proj": (cfg.intermediate_size, cfg.hidden_size),
        }
        union = sorted(set().union(*targets) & set(dims_all))
        if not union:
            raise ValueError(
                f"{self.owner}: no adapter in the catalog targets a "
                f"supported decoder projection ({sorted(dims_all)})"
            )
        self.targets = tuple(union)
        self._dims = {name: dims_all[name] for name in self.targets}
        slots = int(slots or 0)
        if slots == 0:
            self.slots = len(self.catalog) + 1
        elif slots > 1:
            self.slots = slots
        else:
            # slot 0 is the base adapter, so 1 slot can never admit a tenant:
            # substituting the default would not be what was asked for
            raise ValueError(
                f"{self.owner}: --adapter-slots {slots} is unservable — "
                "need >= 2 (slot 0 is the permanent base adapter) or 0 "
                "for catalog size + 1"
            )
        # capacity decisions (adapter.load / adapter.evict) go to this hook
        self.on_event = on_event

        self._mu = threading.Lock()
        self._slot_of: Dict[str, int] = {}  # resident name -> slot
        self._refs: Dict[str, int] = {}  # live-session references
        self._pins: set = set()
        # idle-since per resident, oldest first (the LRU eviction order);
        # refreshed on every release back to zero references
        self._idle_since: "OrderedDict[str, float]" = OrderedDict()
        self._free: List[int] = list(range(1, self.slots))
        self.loads = 0
        self.evictions = 0
        self._pools: Optional[Dict[str, Any]] = None  # built on first load

    # ------------------------------------------------------------- internals

    @staticmethod
    def _peek_meta(path: str):
        """(rank, targeted projections) of an adapter directory without
        reading its tensors: the rank from adapter_config.json, the targets
        from the safetensors header's key names."""
        with open(os.path.join(path, "adapter_config.json")) as f:
            rank = int(json.load(f)["r"])
        targets = set()
        with safetensors_io.SafeOpen(os.path.join(path, "adapter_model.safetensors")) as f:
            for key in f.keys():
                m = loralib._KEY_RE.search(key)
                if m is not None:
                    targets.add(m.group(2))
        return rank, targets

    def _ensure_pools_locked(self) -> Dict[str, Any]:
        """Zero pools (and scales) on first touch: slot 0 stays zero for good."""
        if self._pools is not None:
            return self._pools
        s, n_layers, r = self.slots, self.num_layers, self.rank
        dt, dev = self.cfg.torch_dtype, self.device
        self._pools = {
            "a": {name: torch.zeros((s, n_layers, din, r), dtype=dt, device=dev)
                  for name, (din, _dout) in self._dims.items()},
            "b": {name: torch.zeros((s, n_layers, r, dout), dtype=dt, device=dev)
                  for name, (_din, dout) in self._dims.items()},
            "scale": torch.zeros((s,), dtype=torch.float32, device=dev),
        }
        return self._pools

    def _read_padded(self, name: str):
        """Read `name` from disk and build its zero-padded per-target f32
        host rows (the costly half of a hot-load), with no lock held. Raises
        before any slot decision: an unreadable catalog entry must never
        evict a resident."""
        path = self.catalog.get(name)
        if path is None:
            raise UnknownAdapterError(
                f"{self.owner}: unknown adapter {name!r} — this node's "
                f"catalog serves {sorted(self.catalog)}"
            )
        adapter = loralib.slice_adapter(
            loralib.load_adapter(self.cfg, path),
            self.start_layer, self.end_layer, owner=self.owner,
        )
        n_layers, r = self.num_layers, self.rank
        rows = {}
        for target, (din, dout) in self._dims.items():
            a_new = torch.zeros((n_layers, din, r), dtype=torch.float32)
            b_new = torch.zeros((n_layers, r, dout), dtype=torch.float32)
            ab = adapter["layers"].get(target)
            if ab is not None:
                a_new[:, :, : ab[0].shape[-1]] = ab[0]
                b_new[:, : ab[1].shape[1], :] = ab[1]
            rows[target] = (a_new, b_new)
        return rows, float(adapter["scale"])

    def _install_locked(self, name: str, rows, scale: float, t0: float) -> int:
        """Claim a slot (evicting an idle one if need be, only after the disk
        read succeeded) and write the prepared rows into it. MUST hold
        self._mu."""
        if not self._free:
            victims = [n for n in self._idle_since
                       if not self._refs.get(n) and n not in self._pins]
            if not victims:
                raise AdapterCapacityError(
                    f"{self.owner}: all {self.slots - 1} adapter slots "
                    "hold live-session or pinned adapters"
                )
            victim = victims[0]  # oldest idle
            vslot = self._slot_of.pop(victim)
            idle_s = time.monotonic() - self._idle_since.pop(victim)
            self._free.append(vslot)
            self.evictions += 1
            _emit(self.on_event, "adapter.evict", name=victim, slot=vslot,
                  idle_s=round(idle_s, 3), claimant=name)
            # the victim's rows stay until the claimant's overwrite every
            # layer and rank row of the slot below
        pools = self._ensure_pools_locked()
        slot = self._free.pop(0)
        for target, (a_new, b_new) in rows.items():
            pools["a"][target][slot].copy_(a_new)
            pools["b"][target][slot].copy_(b_new)
        pools["scale"][slot] = scale
        self._slot_of[name] = slot
        self._idle_since[name] = time.monotonic()
        self.loads += 1
        _emit(self.on_event, "adapter.load", name=name, slot=slot,
              ms=round((time.perf_counter() - t0) * 1e3, 1))
        return slot

    # --------------------------------------------------------------- surface

    def acquire(self, name: str) -> int:
        """Session admission: `name`'s resident slot, hot-loaded on a miss,
        with a reference that shields it from eviction until release().
        Concurrent misses for one name race benignly: the loser drops its
        read and references the winner's slot."""
        with self._mu:
            slot = self._slot_of.get(name)
            if slot is not None:
                self._idle_since[name] = time.monotonic()
                self._idle_since.move_to_end(name)
                self._refs[name] = self._refs.get(name, 0) + 1
                return slot
        t0 = time.perf_counter()
        rows, scale = self._read_padded(name)
        with self._mu:
            slot = self._slot_of.get(name)
            if slot is None:
                slot = self._install_locked(name, rows, scale, t0)
            else:
                self._idle_since[name] = time.monotonic()
                self._idle_since.move_to_end(name)
            self._refs[name] = self._refs.get(name, 0) + 1
            return slot

    def release(self, name: str) -> None:
        with self._mu:
            n = self._refs.get(name, 0) - 1
            if n > 0:
                self._refs[name] = n
                return
            self._refs.pop(name, None)
            if name in self._slot_of:
                # idle from now: newest in the LRU order
                self._idle_since[name] = time.monotonic()
                self._idle_since.move_to_end(name)

    def slot_of(self, name: str) -> int:
        """The resident slot of a name a live session holds a reference on.
        KeyError when not resident: a held reference pins the slot, so that
        means the executor's bookkeeping broke."""
        with self._mu:
            return self._slot_of[name]

    def pin(self, name: str) -> int:
        """Load `name` if need be and keep it resident until unpin,
        whatever the session references."""
        with self._mu:
            slot = self._slot_of.get(name)
            if slot is not None:
                self._pins.add(name)
                return slot
        t0 = time.perf_counter()
        rows, scale = self._read_padded(name)
        with self._mu:
            slot = self._slot_of.get(name)
            if slot is None:
                slot = self._install_locked(name, rows, scale, t0)
            self._pins.add(name)
            return slot

    def unpin(self, name: str) -> None:
        with self._mu:
            self._pins.discard(name)

    def device_adapters(self) -> Optional[Dict[str, Any]]:
        """The pool operand ({"a", "b", "scale"}; the executor adds "ids"),
        or None before the first load (an all-base window computes no delta).
        The pools are allocated once, at the first load, and written in
        place ever after: a captured lane graph reads them by address
        (runtime/stage_batch checks that it never changes)."""
        with self._mu:
            if self._pools is None:
                return None
            return {"a": dict(self._pools["a"]), "b": dict(self._pools["b"]),
                    "scale": self._pools["scale"]}

    def resident_names(self) -> List[str]:
        """The resident tenant adapters, least recently used first, at most
        the last ADA_GOSSIP_MAX (the most recently touched survive the cap):
        the gossiped `ada` field."""
        with self._mu:
            names = [n for n in self._idle_since if n in self._slot_of]
        return names[-ADA_GOSSIP_MAX:]

    def resident_count(self) -> int:
        with self._mu:
            return len(self._slot_of)

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "slots": self.slots,
                "resident": len(self._slot_of),
                "pinned": len(self._pins),
                "catalog": len(self.catalog),
                "rank": self.rank,
                "loads": self.loads,
                "evictions": self.evictions,
            }
