"""Generation clients."""
