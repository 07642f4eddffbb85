"""Serving layer of the port: the Table-1 router and the LM engine."""

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.router import (
    GreenScaleRouter,
    Request,
    RequestBatch,
    RouteDecision,
    request_workload,
)

__all__ = [k for k in dir() if not k.startswith("_")]
