"""Serving layer of the port: the routers, the routing policies (oracle,
learned, capacity-capped), the placement and temporal admission engines,
the rolling forecast re-planner, the continuous-batching request queue
with online policy refit, synthetic streams and the LM engine."""

from repro_torch.core.carbon_intensity import (
    DEFAULT_REGIONS,
    CarbonGrid,
    RegionSpec,
    site_regions,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.forecast import (
    EmissionsLedger,
    LedgerStep,
    RollingRouteResult,
    pad_pow2,
    slice_batch,
)
from repro_torch.serve.online import OnlineRefitter, ReplayBuffer
from repro_torch.serve.placement import (
    PlacementPolicy,
    PlacementState,
    device_prefix_ranks,
    windowed_segment_ranks,
)
from repro_torch.serve.policy import (
    CapacityLimiter,
    CapacityState,
    LearnedPolicy,
    OraclePolicy,
    RoutingPolicy,
    policy_features,
)
from repro_torch.serve.queue import (
    BatchFormer,
    FormedBatch,
    QueueServeResult,
    QueueStep,
    RequestQueue,
    WorkerPool,
    admit_batches,
    serve_stream,
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
