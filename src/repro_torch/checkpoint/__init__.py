"""Atomic npz checkpoint store with per-shard SHA-256."""
