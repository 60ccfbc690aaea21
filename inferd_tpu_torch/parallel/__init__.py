"""Stage partitioning and stage checkpoints."""
