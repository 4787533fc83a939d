"""Serving: paged KV pool, cached adapter, scheduler, engine, artifacts."""
