"""Distribution layer: collectives over a shard axis and per-device byte
accounting for the row-sharded data plane (DESIGN.md §3.9), the LM's
partition rules, and GPipe pipeline parallelism."""
from repro_torch.distributed import collectives, pipeline, sharding

__all__ = ["collectives", "pipeline", "sharding"]
