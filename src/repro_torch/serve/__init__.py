"""Serving front-ends: the fault-tolerant multi-tenant SpGEMM service
(``spgemm_service``).

The reference's LM batching loop (``repro.serve.engine.ServingEngine``)
drives its models' prefill and decode steps, so it comes with the port of
the models and is not here yet.
"""
from .spgemm_service import (MetricsHTTPServer, ServiceResult,
                             ServiceSession, SpgemmService)

__all__ = [
    "MetricsHTTPServer", "ServiceResult", "ServiceSession", "SpgemmService",
]
