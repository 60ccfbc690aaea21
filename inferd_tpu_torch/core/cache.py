"""KV caches (port of inferd_tpu/core/cache.py): the uniform dense layout,
lane views of it, and the paged block pool.

Dense layout: k/v are [num_layers, batch, max_len, num_kv_heads, head_dim];
`length` is the number of populated positions, a host-side int.

The JAX cache is functional and its jitted steps donate the buffers so the
update happens in place on the device. Here the buffers are simply written
IN PLACE (models/qwen3.decoder_layer writes into them), and `grow` copies
into a larger bucket. Overflow is checked on the host before dispatch
(`ensure_room`). `BufferPool` keeps a one-session executor's buffers for
reuse by later sessions, so the graphs captured over them are reused too.

Paged layout (`PagedKVCache` + `BlockPool`): K/V live in a pool of
fixed-size blocks [num_layers, num_blocks, block_size, Nkv, D] and each lane
maps to a chain of blocks through an int32 [lanes, max_blocks] table; chain
slot j covers positions [j*bs, (j+1)*bs). Blocks are refcounted, so a
cached or pinned prefix maps read-only into many lanes, and copy-on-write
splits a block at the first divergent write. Block 0 is a reserved scratch
block: unallocated table entries point at it, and it is never attended.
`BlockPool` is the host-side allocator; the table is a host numpy mirror,
staged per dispatch (`sync_paged`) and copied once to the device: straight
into a lane executor's decode graph's static table.

A session's KV leaves a device for a handoff through `kv_to_host` (one
transfer of its K and V), and a paged lane forks another's prefix with
`BlockPool.fork_lane` (full blocks shared read-only, the partial tail block
copied). Ring buffers for sliding-window layers wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.core import prefix as prefixlib


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, T, Nkv, D]
    v: torch.Tensor  # [L, B, T, Nkv, D]
    length: int = 0  # populated positions

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    @property
    def nbytes(self) -> int:
        return self.k.numel() * self.k.element_size() * 2

    @staticmethod
    def create(
        cfg: ModelConfig,
        num_layers: int,
        batch: int,
        max_len: int,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> "KVCache":
        """Zeroed buffers; the dtype defaults to the config's KV dtype."""
        if cfg.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: ring KV storage for sliding windows is not ported yet"
            )
        dt = dtype or cfg.kv_torch_dtype
        shape = (num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            length=0,
        )

    def ensure_room(self, new_tokens: int, owner: Optional[str] = None) -> None:
        """Host-side overflow guard: call before writing `new_tokens`."""
        if self.length + new_tokens > self.max_len:
            who = f" ({owner})" if owner else ""
            raise BufferError(
                f"KV cache overflow{who}: {self.length} used + {new_tokens} new > "
                f"{self.max_len}"
            )


def grow(cache: KVCache, into: KVCache) -> KVCache:
    """Move to the larger bucket `into` (a buffer of the same batch, from a
    BufferPool), copying the populated slots (the whole old buffer, as the
    JAX pad does)."""
    l, b, t, n, d = cache.k.shape
    if into.batch != b or into.max_len <= t:
        raise ValueError(f"grow: buffer [{into.batch}, {into.max_len}] for a cache [{b}, {t}]")
    into.k[:, :, :t] = cache.k
    into.v[:, :, :t] = cache.v
    into.length = cache.length
    return into


def kv_slot_bytes(cfg: ModelConfig, num_layers: int) -> int:
    """Bytes of one dense KV slot of one row: K and V, every layer."""
    return 2 * num_layers * cfg.num_kv_heads * cfg.head_dim * cfg.kv_torch_dtype.itemsize


class BufferPool:
    """Dense KV buffers kept for reuse: a free list per (batch, max_len),
    their bytes bounded in total.

    The one-session executor takes a session's buffer here and gives it back
    when the session ends, is swept or evicted, or grows into the next
    bucket; the next session of that bucket reuses it, and with it the CUDA
    graphs captured over its address (the JAX executor's donated cache has
    the same effect). A returned buffer keeps its old values: slots past a
    session's fill are never attended. The idle buffers of every shape
    together hold at most `max_free_bytes` (the executor passes max_sessions
    buffers of its smallest bucket: what a wave of sessions that end
    together needs to start again). A give past that releases idle buffers,
    the largest first (every session starts in the smallest bucket, so
    those are reused most and keep the most buffers within the bound), of
    one shape the one given last first; `on_free(cache)` is called for each
    so that whatever reads it by address (its graphs) goes with it."""

    def __init__(self, cfg: ModelConfig, num_layers: int, device, max_free_bytes: int,
                 on_free=None):
        if max_free_bytes < 0:
            raise ValueError(f"max_free_bytes must be >= 0, got {max_free_bytes}")
        self.cfg, self.num_layers, self.device = cfg, num_layers, device
        self.max_free_bytes = max_free_bytes
        self.on_free = on_free
        self._free: Dict[Tuple[int, int], List[KVCache]] = {}
        self._lock = threading.Lock()
        self.allocated = 0  # buffers made
        self.reused = 0  # takes served from a free list
        self.released = 0  # buffers given back past the bound, and freed
        self.free_bytes = 0  # bytes of the idle buffers

    def take(self, batch: int, max_len: int) -> KVCache:
        """A buffer of this shape with length 0: a free one, else a new one."""
        with self._lock:
            free = self._free.get((batch, max_len))
            if free:
                self.reused += 1
                cache = free.pop()
                self.free_bytes -= cache.nbytes
                cache.length = 0
                return cache
            self.allocated += 1
        return KVCache.create(self.cfg, self.num_layers, batch, max_len, device=self.device)

    def give(self, cache: KVCache) -> None:
        """Return a buffer no session holds any more."""
        with self._lock:
            free = self._free.setdefault((cache.batch, cache.max_len), [])
            if any(c is cache for c in free):
                raise ValueError("BufferPool.give: the buffer is already free")
            free.append(cache)
            self.free_bytes += cache.nbytes
            gone = []
            for shape in sorted(self._free, key=lambda s: s[0] * s[1], reverse=True):
                free = self._free[shape]
                while free and self.free_bytes > self.max_free_bytes:
                    gone.append(free.pop())
                    self.free_bytes -= gone[-1].nbytes
            self.released += len(gone)
        if self.on_free is not None:
            for c in gone:
                self.on_free(c)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"allocated": self.allocated, "reused": self.reused,
                    "released": self.released,
                    "free": sum(len(v) for v in self._free.values()),
                    "free_bytes": self.free_bytes, "max_free_bytes": self.max_free_bytes}


def host_staged(a, device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) as a CPU tensor of its own, ready
    for ONE copy to `device`: pinned when that is a card, so the copy runs
    non-blocking (a pageable copy stalls the host until the stream drains).
    A graph's static buffer takes it as it is (utils/cuda_graph)."""
    t = a.contiguous() if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if torch.device(device).type == "cuda" else t.clone()


def host_to_device(a, device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) as a tensor on `device`, never
    sharing the array's memory (host_staged, then one non-blocking copy)."""
    return host_staged(a, device).to(device, non_blocking=True)


def device_column(x, b: int, dtype: torch.dtype, device) -> torch.Tensor:
    """[B] of x on `device`: a device tensor as it is, a host value (one
    for every row, or [B]) uploaded without a sync."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return x.reshape(b).to(device, dtype)
    a = np.array(np.broadcast_to(np.asarray(x), (b,)))
    return host_to_device(a, device).to(dtype)


def device_to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Several tensors of one device as numpy arrays, in ONE transfer: they
    ride as float64 (exact for token ids, float32 values and int32 ids) in
    one buffer, split again on the host. Integer tensors come back int64,
    float ones float32."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        a = flat[at:at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
        out.append(a.astype(np.float32 if t.is_floating_point() else np.int64))
    return out


def kv_to_host(k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V (two slices of one device's buffers, any layout) as host
    tensors of their own dtype, in ONE transfer: stacked on the device (a
    1-byte dtype as its uint8 view: fp8 has no stack kernel on every
    build), copied once, split again. Host tensors come back as copies:
    the caller owns them."""
    byte = k.element_size() == 1
    pair = torch.stack([k.view(torch.uint8), v.view(torch.uint8)] if byte else [k, v])
    pair = pair.cpu() if pair.device.type != "cpu" else pair
    if byte:
        pair = pair.view(k.dtype)
    return pair[0], pair[1]


def lane_slice(cache: KVCache, lane: int) -> KVCache:
    """One lane's KVCache, [L, 1, T, Nkv, D] on the batch axis. Unlike the
    reference's dynamic_slice this is a VIEW of the slab (a basic slice),
    so a forward's in-place writes into it land in the shared cache and
    `lane_write` has nothing left to copy."""
    return KVCache(k=cache.k[:, lane:lane + 1], v=cache.v[:, lane:lane + 1],
                   length=cache.length)


def lane_write(cache: KVCache, lane: int, nc: KVCache) -> KVCache:
    """The reference's inverse of lane_slice. Here `nc` must be the view
    lane_slice returned (its writes already landed in the slab): this only
    checks that and returns `cache`."""
    if nc.k.data_ptr() != cache.k[:, lane:lane + 1].data_ptr():
        raise ValueError("lane_write: the lane cache is not a view of this slab")
    return cache


# ---------------------------------------------------------------------------
# Paged KV: block pool + block tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV state: block pools + the lanes' block table.

    k/v: [L, num_blocks, block_size, Nkv, D] (block 0 = scratch);
    table: [lanes, max_blocks] int32 on the pools' device (chain slot j of
    lane b covers positions [j*bs, (j+1)*bs); unallocated entries = 0);
    length: kept for interface parity with KVCache (lane executors track
    per-lane lengths on the host)."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    length: int = 0

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def max_blocks(self) -> int:
        return self.table.shape[1]

    @property
    def max_len(self) -> int:
        """Per-lane positional capacity (the dense-equivalent max_len)."""
        return self.max_blocks * self.block_size

    @property
    def batch(self) -> int:
        return self.table.shape[0]

    @property
    def nbytes(self) -> int:
        return self.k.numel() * self.k.element_size() * 2

    @staticmethod
    def create(
        cfg: ModelConfig,
        num_layers: int,
        lanes: int,
        max_len: int,
        block_size: int = 32,
        num_blocks: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> "PagedKVCache":
        dt = dtype or cfg.kv_torch_dtype
        bs = int(block_size)
        mb = -(-int(max_len) // bs)  # ceil: blocks per lane chain
        nb = (lanes * mb + 1) if num_blocks is None else int(num_blocks)
        shape = (num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            table=torch.zeros((lanes, mb), dtype=torch.int32, device=device),
            length=0,
        )


class _PrefixEntry:
    """One cached or pinned prefix block in the pool's prefix index. The
    index holds its OWN reference on the block (refcount + 1), so the block
    outlives the sessions that wrote it until evicted for space; pinned
    entries are never evicted."""

    __slots__ = ("block", "pinned")

    def __init__(self, block: int, pinned: bool = False):
        self.block = block
        self.pinned = pinned


class BlockPool:
    """Host-side allocator for a PagedKVCache: free list, per-lane block
    chains, refcounts, copy-on-write, and the shared-prefix index.

    NOT thread-safe by itself: the lane executor mutates it under the same
    bookkeeping lock that guards its lane state. Device copies implied by
    CoW splits are returned as (src, dst) block pairs for the caller to
    apply under its device lock (`drain_copies`, `sync_paged`). The
    reference's eviction-age telemetry hook waits for the observability
    slice."""

    def __init__(
        self,
        cfg: ModelConfig,
        num_layers: int,
        lanes: int,
        max_len: int,
        block_size: int = 32,
        num_blocks: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        if cfg.sliding_window > 0:
            raise ValueError(
                "paged KV supports uniform-layout models only "
                "(sliding-window models keep the dense ring layout)"
            )
        self.cfg = cfg
        self.block_size = int(block_size)
        self.lanes = int(lanes)
        self.max_blocks = -(-int(max_len) // self.block_size)
        self.cache = PagedKVCache.create(
            cfg, num_layers, lanes, max_len, block_size=self.block_size,
            num_blocks=num_blocks, dtype=dtype, device=device,
        )
        self.num_blocks = self.cache.num_blocks
        if self.num_blocks < 2:
            raise ValueError("paged KV needs >= 2 blocks (block 0 is scratch)")
        # host mirrors (never read back from the device)
        self.table = np.zeros((self.lanes, self.max_blocks), np.int32)
        self.refcount = np.zeros((self.num_blocks,), np.int32)
        self.refcount[0] = 1  # scratch block: never allocated, never freed
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self.lane_blocks = [0] * self.lanes  # chain length per lane
        self.lane_shared = [0] * self.lanes  # leading read-only blocks
        # prefix index: chained block-content key -> entry (LRU order)
        self._index: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        self._pending_copies: List[Tuple[int, int]] = []
        self.cow_splits = 0
        self.prefix_hit_tokens = 0
        self.prefix_evictions = 0

    # ------------------------------------------------------------ allocation

    def blocks_for(self, upto: int) -> int:
        return -(-int(upto) // self.block_size)

    def _alloc(self, owner: str) -> int:
        if not self._free:
            self._evict_cached(1)
        if not self._free:
            raise BufferError(
                f"KV block pool exhausted ({owner}): 0 free of "
                f"{self.num_blocks - 1} blocks (block_size={self.block_size})"
            )
        b = self._free.pop()
        self.refcount[b] = 1
        return b

    def ensure(self, lane: int, upto: int, owner: str = "") -> None:
        """Grow `lane`'s chain with private blocks until it covers
        positions [0, upto). Raises BufferError carrying `owner` (the
        session/lane identity) when the pool cannot satisfy it."""
        need = self.blocks_for(upto)
        if need > self.max_blocks:
            raise BufferError(
                f"KV overflow ({owner}): {upto} > {self.max_blocks * self.block_size}"
            )
        for j in range(self.lane_blocks[lane], need):
            self.table[lane, j] = self._alloc(owner)
            # advance one block at a time: an exhaustion midway must leave
            # the blocks already claimed releasable, not leaked
            self.lane_blocks[lane] = j + 1

    def _decref(self, block: int) -> None:
        if block <= 0:
            return
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            self._free.append(block)

    def release_lane(self, lane: int) -> None:
        """Return a lane's chain to the pool (shared/cached blocks survive
        through their index references)."""
        for j in range(self.lane_blocks[lane]):
            self._decref(int(self.table[lane, j]))
        self.table[lane, :] = 0
        self.lane_blocks[lane] = 0
        self.lane_shared[lane] = 0

    # ------------------------------------------------------------ sharing

    def map_prefix(self, lane: int, keys: Sequence[bytes]) -> int:
        """Map the longest indexed run of `keys` into a FRESH lane's chain
        as read-only shared blocks; returns the number of tokens covered."""
        if self.lane_blocks[lane] != 0:
            raise ValueError(f"map_prefix: lane {lane} is not empty")
        m = 0
        for key in keys:
            ent = self._index.get(key)
            if ent is None:
                break
            self._index.move_to_end(key)
            self.table[lane, m] = ent.block
            self.refcount[ent.block] += 1
            m += 1
        self.lane_blocks[lane] = m
        self.lane_shared[lane] = m
        covered = m * self.block_size
        self.prefix_hit_tokens += covered
        return covered

    def register_prefix(self, lane: int, keys: Sequence[bytes]) -> int:
        """Publish a lane's leading blocks into the prefix index under their
        content keys (after the lane's prefill wrote them). Blocks already
        indexed are touched, not duplicated. Returns the count added."""
        added = 0
        for j, key in enumerate(keys):
            if j >= self.lane_blocks[lane]:
                break
            ent = self._index.get(key)
            if ent is not None:
                self._index.move_to_end(key)
                continue
            block = int(self.table[lane, j])
            if block <= 0 or j < self.lane_shared[lane]:
                continue
            self._index[key] = _PrefixEntry(block)
            self.refcount[block] += 1  # the index's own reference
            added += 1
        return added

    def pin(self, keys: Sequence[bytes]) -> int:
        """Mark indexed entries pinned (never evicted for space); returns
        how many of `keys` were found."""
        n = 0
        for key in keys:
            ent = self._index.get(key)
            if ent is not None:
                ent.pinned = True
                n += 1
        return n

    def unpin(self, keys: Sequence[bytes]) -> None:
        for key in keys:
            ent = self._index.get(key)
            if ent is not None:
                ent.pinned = False

    def _evict_cached(self, need: int) -> None:
        """Drop LRU unpinned index entries whose block nothing else holds
        (refcount 1) until `need` blocks are free."""
        if need <= len(self._free):
            return
        for key in list(self._index):
            ent = self._index[key]
            if ent.pinned or self.refcount[ent.block] != 1:
                continue
            del self._index[key]
            self._decref(ent.block)
            self.prefix_evictions += 1
            if len(self._free) >= need:
                return

    # ------------------------------------------------------------ CoW

    def make_writable(self, lane: int, from_pos: int, owner: str = "") -> None:
        """Copy-on-write split every MULTIPLY-REFERENCED block of `lane`
        covering positions >= from_pos: each gets a private copy, the table
        repoints, and the (src, dst) device copy is queued for
        `drain_copies`. The test is the refcount, not `lane_shared`: a lane
        that published its own blocks (register_prefix) holds blocks the
        index still reads."""
        first = int(from_pos) // self.block_size
        for j in range(first, self.lane_blocks[lane]):
            old = int(self.table[lane, j])
            if old <= 0 or self.refcount[old] <= 1:
                continue
            new = self._alloc(owner)
            self._queue_copy(old, new)
            self.table[lane, j] = new
            self._decref(old)
            self.cow_splits += 1
        self.lane_shared[lane] = min(self.lane_shared[lane], first)

    def _queue_copy(self, src: int, dst: int) -> None:
        """Queue a device block copy. The queue holds its OWN reference on
        `src` (released at drain), so a teardown between queue and apply
        cannot recycle the block under the pending copy."""
        self.refcount[src] += 1
        self._pending_copies.append((src, dst))

    def fork_lane(self, src: int, dst: int, prefix_len: int, owner: str = "") -> None:
        """Seed the FRESH lane `dst` with lane `src`'s first `prefix_len`
        positions: full blocks map read-only (refcount raised; copy-on-write
        at a later divergent write), and a partial tail block gets a private
        copy, queued for `drain_copies`, which every dispatch applies before
        it reads the lane. Raises BufferError (nothing claimed) when the
        pool has no block for the tail."""
        if self.lane_blocks[dst] != 0:
            raise ValueError(f"fork_lane: lane {dst} is not empty")
        full = int(prefix_len) // self.block_size
        tail = None
        if prefix_len % self.block_size:
            tail = self._alloc(owner)  # first: an exhaustion leaves dst empty
        for j in range(full):
            b = int(self.table[src, j])
            self.table[dst, j] = b
            self.refcount[b] += 1
        self.lane_shared[dst] = full
        self.lane_blocks[dst] = full
        if tail is not None:
            self._queue_copy(int(self.table[src, full]), tail)
            self.table[dst, full] = tail
            self.lane_blocks[dst] = full + 1

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Take the queued CoW (src, dst) copies; the caller applies them on
        the device (under its device lock) before the next dispatch that
        reads the split lane. Releases the queue's source references."""
        out, self._pending_copies = self._pending_copies, []
        for src, _dst in out:
            self._decref(src)
        return out

    # ------------------------------------------------------------ dispatch

    def device_table(self, max_blocks: Optional[int] = None) -> torch.Tensor:
        """A fresh device copy of the host table, optionally narrowed to
        `max_blocks` columns (chain_clamp)."""
        t = self.table if max_blocks is None else self.table[:, :max_blocks]
        return host_to_device(t, self.cache.k.device)

    def chain_clamp(self) -> int:
        """Power-of-two bucket of the longest allocated chain (>= 1, capped
        at the table width). A table stamped at this width keeps the decode
        kernel's walk, and the gather of the composite path, to slots some
        lane can reach. Blocks are allocated before the dispatch that writes
        them, so the clamp never cuts off a real read or write."""
        used = max(self.lane_blocks) if self.lane_blocks else 0
        bucket = 1
        while bucket < used:
            bucket <<= 1
        return min(bucket, self.max_blocks)

    # ------------------------------------------------------------ gauges

    @property
    def blocks_used(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def cow_shared(self) -> int:
        """Blocks mapped by more than one holder (lanes and/or the index)."""
        return int(np.sum(self.refcount[1:] >= 2))

    @property
    def pins_resident(self) -> int:
        return sum(1 for e in self._index.values() if e.pinned)

    def digest_keys(self, limit: int = 0) -> List[bytes]:
        """The indexed prefix keys a gossiped digest lists (core.prefix.
        make_digest): pinned entries first (resident by contract), then the
        most recently used, up to `limit` (0: prefix.DIGEST_MAX_KEYS). Keys
        are chained, so each names its whole prefix; the MRU order makes the
        digest follow the hot working set when the index outgrows it."""
        if limit <= 0:
            limit = prefixlib.DIGEST_MAX_KEYS
        out: List[bytes] = [k for k, e in self._index.items() if e.pinned][:limit]
        if len(out) < limit:
            seen = set(out)
            for k in reversed(self._index):  # most recently used first
                if k in seen:
                    continue
                out.append(k)
                if len(out) >= limit:
                    break
        return out

    def block_stats(self) -> Dict[str, Any]:
        return {
            "block_size": self.block_size,
            "blocks_total": self.num_blocks - 1,
            "blocks_used": self.blocks_used,
            "blocks_free": self.blocks_free,
            "cow_shared": self.cow_shared,
            "cow_splits": self.cow_splits,
            "prefix_entries": len(self._index),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_evictions": self.prefix_evictions,
            "pins_resident": self.pins_resident,
        }


def paged_copy_blocks(cache: PagedKVCache, pairs: List[Tuple[int, int]]) -> PagedKVCache:
    """Apply queued CoW block copies IN PLACE, all pairs in one indexed
    copy per pool (the right side is gathered before the write)."""
    if not pairs:
        return cache
    dev = cache.k.device
    src = host_to_device(np.asarray([p[0] for p in pairs], np.int64), dev)
    dst = host_to_device(np.asarray([p[1] for p in pairs], np.int64), dev)
    cache.k[:, dst] = cache.k[:, src]
    cache.v[:, dst] = cache.v[:, src]
    return cache


def sync_paged(pool: BlockPool, cache: PagedKVCache, mu) -> Tuple[PagedKVCache, torch.Tensor]:
    """Dispatch-ready paged state: (the cache with the queued CoW copies
    applied, the CURRENT table at the chain_clamp width staged on the host
    for the cache's device: host_staged, one copy away from the device).
    Call under the caller's DEVICE lock with `mu` (its bookkeeping lock)
    NOT held."""
    with mu:
        pairs = pool.drain_copies()
        table = host_staged(pool.table[:, :pool.chain_clamp()], cache.k.device)
    return paged_copy_blocks(cache, pairs), table
