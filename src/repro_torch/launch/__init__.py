"""Entry points: the serving CLI and the recompute oracle."""
