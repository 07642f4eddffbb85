"""Serving layer of the port: the routers, the routing policies, the
placement and temporal admission engines, synthetic streams and the LM
engine."""

from repro_torch.core.carbon_intensity import (
    DEFAULT_REGIONS,
    CarbonGrid,
    RegionSpec,
    site_regions,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.placement import (
    PlacementPolicy,
    PlacementState,
    device_prefix_ranks,
    windowed_segment_ranks,
)
from repro_torch.serve.policy import (
    CapacityLimiter,
    CapacityState,
    OraclePolicy,
    RoutingPolicy,
)
from repro_torch.serve.router import (
    FleetRouteResult,
    FleetRouter,
    GreenScaleRouter,
    Request,
    RequestBatch,
    RouteDecision,
    request_workload,
)
from repro_torch.serve.streams import bake_ci_events
from repro_torch.serve.temporal import TemporalPolicy, TemporalState

__all__ = [k for k in dir() if not k.startswith("_")]
