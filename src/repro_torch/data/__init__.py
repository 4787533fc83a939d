"""Deterministic synthetic token streams."""
