"""Collectives over a shard axis and per-device byte accounting for the
row-sharded data plane (DESIGN.md §3.9)."""
