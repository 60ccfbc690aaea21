"""Serving runtime: wire codec, stage executor, chain-mode node."""
