"""Model compute: the Qwen3 decoder and parameter conversion."""
