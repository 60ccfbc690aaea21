"""Observability: for now, only the routing signals the control plane reads."""
