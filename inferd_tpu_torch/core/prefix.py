"""Chained block keys: the paged KV pool's shared-prefix identity (port of
inferd_tpu/core/prefix.py).

This slice ports what the block pool needs: `normalize_ids`, `block_keys`
and `digest_key`. The bytes are the reference's, so a key made by either
package names the same prefix. The gossiped digest (`make_digest`),
`AffinityProbe` and `longest_prefix_match` wait for the swarm slice.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

#: Bytes of the 16-byte chained block key that ride in a digest (hex).
DIGEST_KEY_BYTES = 4


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
