"""Swarm control plane: gossip membership and next-hop routing."""
