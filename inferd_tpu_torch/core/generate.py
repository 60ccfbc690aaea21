"""Generation helpers (port of inferd_tpu/core/generate.py).

This slice ports `bucket_len` only: the stage executor pads prompt chunks
to power-of-two buckets with it, exactly as the JAX package does, so the
two packages write the same KV slots. The single-process `Engine`, prefix
pins and `generate_text` wait for a later slice.
"""

from __future__ import annotations


def bucket_len(n: int, minimum: int = 16) -> int:
    """Smallest power-of-two multiple of `minimum` that is >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b
