"""GreenScale core on torch: the Table-1 carbon model and its inputs."""

from repro_torch.core.constants import Component, EnergySource, Target
from repro_torch.core.carbon_intensity import (
    ChargingBehavior,
    Grid,
    GridTrace,
    charging_profile,
    grid_trace,
    mobile_carbon_intensity,
)
from repro_torch.core.carbon_model import (
    CFBreakdown,
    Environment,
    RouteOutputs,
    evaluate,
    evaluate_energy,
    feasible,
    pick_target,
    route_many,
    route_one,
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
from repro_torch.core.workloads import Workload, batch_workloads

__all__ = [k for k in dir() if not k.startswith("_")]
