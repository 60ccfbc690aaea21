"""Chained block keys: the paged KV pool's shared-prefix identity (port of
inferd_tpu/core/prefix.py).

What the block pool needs (`normalize_ids`, `block_keys` and
`digest_key`; the bytes are the reference's, so a key made by either
package names the same prefix), `longest_prefix_match`, which the engine's
prefix pins use, and the gossiped digest: a paged replica's record carries
`make_digest` of its hot prefix keys as `pfx`, and an entry router scores
a prompt against it with `AffinityProbe` (control/path_finder's cache
affinity bonus).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: Bytes of the 16-byte chained block key that ride in a digest (hex): a
#: spurious per-key match stays ~2^-32, harmless for a bounded routing bonus.
DIGEST_KEY_BYTES = 4

#: Cap on the prompt blocks a probe digests (64 x 32-token blocks = 2048
#: leading tokens of affinity reach): a router hashes no 100k-token prompt.
DIGEST_MAX_KEYS = 64

#: Cap on the keys a replica gossips: the record rides every gossip frame
#: (32 keys x 8 hex chars ~ 300 bytes per paged replica).
DIGEST_GOSSIP_KEYS = 32


def normalize_ids(ids: Sequence[int]) -> Tuple[int, ...]:
    out = tuple(int(t) for t in ids)
    if not out:
        raise ValueError("prefix ids must be non-empty")
    return out


def block_keys(ids: Sequence[int], block_size: int,
               n_blocks: Optional[int] = None,
               salt: Optional[str] = None) -> List[bytes]:
    """Chained content keys for the FULL blocks of a token stream.

    Key j digests block j's token ids and every preceding block's key (a
    cumulative blake2b chain), so equal keys mean equal entire prefixes:
    two prompts sharing key j share KV for positions [0, (j+1)*block_size)
    exactly. A partial tail block gets no key, since its KV depends on
    tokens that may still diverge. `salt` scopes the chain to a serving
    identity beyond the tokens (an adapter name); empty or None leaves the
    chain unsalted."""
    full = len(ids) // block_size
    if n_blocks is not None:
        full = min(full, n_blocks)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(block_size).encode())
    if salt:
        h.update(b"\x00" + str(salt).encode())
    keys: List[bytes] = []
    for j in range(full):
        block = ids[j * block_size:(j + 1) * block_size]
        h.update(b"".join(int(t).to_bytes(8, "little", signed=True) for t in block))
        keys.append(h.digest())
    return keys


def digest_key(key: bytes) -> str:
    """Truncated wire form of one chained block key."""
    return key[:DIGEST_KEY_BYTES].hex()


def make_digest(keys: Sequence[bytes], block_size: int) -> Dict[str, Any]:
    """Gossip-ready prefix digest {"bs": block size, "k": [truncated keys]},
    the `pfx` record field. `bs` rides along because the chained keys are
    scoped to a block size: a probe derives the prompt's keys at each
    candidate's. At most DIGEST_MAX_KEYS keys (callers pick which)."""
    return {"bs": int(block_size), "k": [digest_key(k) for k in keys[:DIGEST_MAX_KEYS]]}


class AffinityProbe:
    """One prompt's cache-affinity matcher against gossiped digests.

    Built once per routing decision; `depth_frac(record)` scores a
    candidate's record: the fraction of the prompt's (capped) full blocks
    whose chained key the record's `pfx` lists, 0.0 to 1.0. Keys are
    chained (equal key, equal whole prefix), so the deepest matching key
    names the shared coverage. The prompt's keys are derived once per block
    size. `salt` is the session's serving identity beyond the tokens (a
    tenant's adapter name, the salt its KV chains register under): an
    unsalted probe for tenant traffic would miss the tenant's blocks and
    match base sessions' digests of the same prompt."""

    def __init__(self, prompt_ids: Sequence[int], max_keys: int = DIGEST_MAX_KEYS,
                 salt: Optional[str] = None):
        self.prompt_ids = [int(t) for t in prompt_ids]
        self.max_keys = int(max_keys)
        self.salt = None if salt is None else str(salt)
        self._by_bs: Dict[int, List[str]] = {}

    def keys_for(self, block_size: int) -> List[str]:
        bs = int(block_size)
        if bs <= 0:
            return []
        cached = self._by_bs.get(bs)
        if cached is None:
            cached = [digest_key(k) for k in block_keys(
                self.prompt_ids, bs, n_blocks=self.max_keys, salt=self.salt)]
            self._by_bs[bs] = cached
        return cached

    def depth_frac(self, record: Dict[str, Any]) -> float:
        """Matched-prefix depth against one record's `pfx` as a fraction of
        the prompt's digestible blocks; 0.0 without a digest, for a
        malformed one, or with no matching key."""
        pfx = record.get("pfx")
        if not isinstance(pfx, dict):
            return 0.0
        try:
            bs = int(pfx.get("bs", 0))
        except (TypeError, ValueError):
            return 0.0
        held = pfx.get("k")
        if bs <= 0 or not isinstance(held, (list, tuple)) or not held:
            return 0.0
        keys = self.keys_for(bs)
        if not keys:
            return 0.0
        held_set = {k for k in held if isinstance(k, str)}
        depth = 0
        for j, key in enumerate(keys):
            if key in held_set:
                depth = j + 1
        return depth / len(keys)


def longest_prefix_match(
    keys: Iterable[Tuple[int, ...]], prompt_ids: Sequence[int]
) -> Optional[Tuple[int, ...]]:
    """Longest key that `prompt_ids` starts with, or None."""
    best: Optional[Tuple[int, ...]] = None
    prompt = tuple(prompt_ids)
    for ids in keys:
        if len(ids) <= len(prompt) and prompt[: len(ids)] == ids:
            if best is None or len(ids) > len(best):
                best = ids
    return best
