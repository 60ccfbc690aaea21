"""KV caches (port of inferd_tpu/core/cache.py): the uniform dense layout,
lane views of it, and the paged block pool.

Dense layout: k/v are [num_layers, batch, max_len, num_kv_heads, head_dim];
`length` is the number of populated positions, a host-side int.

The JAX cache is functional and its jitted steps donate the buffers so the
update happens in place on the device. Here the buffers are simply written
IN PLACE (models/qwen3.decoder_layer writes into them), and `grow` copies
into a larger allocation. Overflow is checked on the host before dispatch
(`ensure_room`).

Paged layout (`PagedKVCache` + `BlockPool`): K/V live in a pool of
fixed-size blocks [num_layers, num_blocks, block_size, Nkv, D] and each lane
maps to a chain of blocks through an int32 [lanes, max_blocks] table; chain
slot j covers positions [j*bs, (j+1)*bs). Blocks are refcounted, so a
cached or pinned prefix maps read-only into many lanes, and copy-on-write
splits a block at the first divergent write. Block 0 is a reserved scratch
block: unallocated table entries point at it, and it is never attended.
`BlockPool` is the host-side allocator; the table is a host numpy mirror,
uploaded to the device per dispatch (`sync_paged`).

Ring buffers for sliding-window layers, `fork_lane` and session
export/import wait for later slices.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig


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


def grow(cache: KVCache, new_max_len: int) -> KVCache:
    """Reallocate to a larger bucket, copying the populated slots (the
    whole old buffer, as the JAX pad does)."""
    if new_max_len <= cache.max_len:
        return cache
    l, b, t, n, d = cache.k.shape
    k = cache.k.new_zeros((l, b, new_max_len, n, d))
    v = cache.v.new_zeros((l, b, new_max_len, n, d))
    k[:, :, :t] = cache.k
    v[:, :, :t] = cache.v
    return KVCache(k=k, v=v, length=cache.length)


def host_to_device(a, device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) as a tensor on `device`, never
    sharing the array's memory. To a card it goes through pinned memory,
    non-blocking: a pageable copy (`torch.as_tensor(a, device="cuda")`)
    stalls the host until the stream drains."""
    t = a.contiguous() if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


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


def sync_paged(pool: BlockPool, cache: PagedKVCache, mu) -> PagedKVCache:
    """Dispatch-ready paged cache: apply queued CoW copies and stamp the
    CURRENT table at the chain_clamp width. Call under the caller's DEVICE
    lock with `mu` (its bookkeeping lock) NOT held."""
    with mu:
        pairs = pool.drain_copies()
        table = pool.device_table(pool.chain_clamp())
    cache = paged_copy_blocks(cache, pairs)
    return dataclasses.replace(cache, table=table)
