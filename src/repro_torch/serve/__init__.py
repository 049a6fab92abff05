from repro_torch.serve.engine import Request, ServeEngine, ServeStats
from repro_torch.serve.search_service import (
    SearchHandle,
    SearchService,
    ServiceSaturated,
    ServiceStats,
    TenantStats,
)

__all__ = [
    "ServeEngine",
    "Request",
    "ServeStats",
    "SearchService",
    "SearchHandle",
    "ServiceStats",
    "TenantStats",
    "ServiceSaturated",
]
