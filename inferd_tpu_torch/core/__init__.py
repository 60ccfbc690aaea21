"""KV cache and generation helpers."""
