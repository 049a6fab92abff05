"""Metric readers, one file a metric: ``read(ctx) -> float | None``."""
