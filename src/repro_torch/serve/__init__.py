"""Serving layer of the port: the routers, the routing policies (oracle,
learned, capacity-capped), the placement and temporal admission engines,
the rolling forecast re-planner, the continuous-batching request queue
with online policy refit, joint capacity provisioning
(``repro_torch.serve.provision``), the scenario matrix
(``repro_torch.serve.scenarios``), synthetic streams and the LM engine."""

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
from repro_torch.serve.provision import (
    ProvisioningPlan,
    demand_from_arrivals,
    oracle_plan,
    provision_greedy,
    realized_shed_rate,
    smoothed_demand_forecast,
    spike_demand_forecast,
    standing_cost_g,
    static_overprovision_plan,
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
from repro_torch.serve.scenarios import (
    ArrivalSpec,
    FleetSpec,
    GridEventSpec,
    MatrixCell,
    Scenario,
    ScenarioRun,
    caps_violation,
    default_policies,
    default_scenarios,
    matrix_csv,
    route_scenario,
    run_matrix,
)
from repro_torch.serve.streams import bake_ci_events
from repro_torch.serve.temporal import TemporalPolicy, TemporalState

__all__ = [k for k in dir() if not k.startswith("_")]
