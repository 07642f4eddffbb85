"""GreenScale core on torch: the Table-1 carbon model and its inputs."""

from repro_torch.core.constants import Component, EnergySource, Target
from repro_torch.core.carbon_intensity import (
    DEFAULT_REGIONS,
    CarbonGrid,
    ChargingBehavior,
    Grid,
    GridTrace,
    RegionSpec,
    all_grid_traces,
    charging_profile,
    grid_trace,
    mobile_carbon_intensity,
    region_power_budgets,
    site_regions,
)
from repro_torch.core.carbon_model import (
    CFBreakdown,
    EnergyFactors,
    Environment,
    RouteOutputs,
    energy_factors,
    energy_factors_batch,
    evaluate,
    evaluate_energy,
    feasible,
    forecast_risk_scale,
    inflate_ci_risk,
    optimal_targets_all_metrics,
    pick_target,
    qos_feasible_from_factors,
    route_many,
    route_many_envs,
    route_many_from_factors,
    route_one,
    total_cf_from_factors,
)
from repro_torch.core.design_space import (
    DesignSpaceResult,
    ScenarioAxes,
    ScenarioTable,
    build_scenarios,
    explore,
    scenario_mask,
)
from repro_torch.core.infrastructure import (
    ComputeSpec,
    Fleet,
    InfraParams,
    NetworkSpec,
    pack_infra,
    paper_fleet,
    tpu_fleet,
)
from repro_torch.core.runtime_variance import (
    StochasticVariance,
    VarianceScenario,
    scenario_multipliers,
)
from repro_torch.core.workloads import (
    AI_WORKLOADS,
    ALL_PAPER_WORKLOADS,
    ARVR_WORKLOADS,
    GAME_WORKLOADS,
    Category,
    Workload,
    WorkloadInfo,
    batch_workloads,
    by_name,
    stack_workloads,
)

__all__ = [k for k in dir() if not k.startswith("_")]
