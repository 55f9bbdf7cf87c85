"""Serving front-ends: the LM batching loop (``engine``: continuous
batching over ``models.Model``'s prefill and decode steps) and the
fault-tolerant multi-tenant SpGEMM service (``spgemm_service``)."""
from .engine import Request, ServingEngine
from .spgemm_service import (MetricsHTTPServer, ServiceResult,
                             ServiceSession, SpgemmService)

__all__ = [
    "Request", "ServingEngine",
    "MetricsHTTPServer", "ServiceResult", "ServiceSession", "SpgemmService",
]
