"""Exhaustive carbon design-space exploration (paper §5, Fig 5/6).

Port of the reference ``core/design_space.py``. The paper explores every
combination of workload x charging behaviour x grid x edge-DC location x
DC sourcing x embodied model x runtime variance x hour-of-day x execution
target. ``build_scenarios`` enumerates the scenarios on the CPU (the
reference's host loop, with the port's grid traces) and moves the stacked
tables to the device; ``explore`` evaluates the Table-1 model over
(workload, scenario, target) as one broadcast per distinct fleet variant,
which takes the place of the reference's double ``jax.vmap``.

``DesignSpaceResult`` is what the learned schedulers are fitted on.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import carbon_intensity as ci_mod
from repro_torch.core import carbon_model
from repro_torch.core.carbon_intensity import ChargingBehavior, Grid
from repro_torch.core.carbon_model import Environment
from repro_torch.core.infrastructure import Fleet, InfraParams, pack_infra
from repro_torch.core.runtime_variance import (
    VarianceScenario,
    scenario_multipliers,
)
from repro_torch.core.workloads import Workload, WorkloadInfo, stack_workloads
from repro_torch.device import resolve_device

_CPU = torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class ScenarioAxes:
    """The discrete axes of the paper's design space (defaults = paper §5)."""

    charging: Sequence[ChargingBehavior] = tuple(ChargingBehavior)
    mobile_grid: Sequence[Grid] = (Grid.CISO, Grid.NYISO)
    edge_location: Sequence[Grid] = (Grid.URBAN, Grid.RURAL)
    dc_carbon_free: Sequence[bool] = (False, True)  # grid-mix vs carbon-free
    embodied: Sequence[str] = ("act", "lca")
    variance: Sequence[VarianceScenario] = tuple(VarianceScenario)
    hours: Sequence[int] = tuple(range(24))

    def grid_size(self) -> int:
        return (len(self.charging) * len(self.mobile_grid)
                * len(self.edge_location) * len(self.dc_carbon_free)
                * len(self.embodied) * len(self.variance) * len(self.hours))


@dataclasses.dataclass(frozen=True)
class ScenarioTable:
    """Host-side enumeration of scenarios + stacked tensors on one device.

    ``infras_jetson`` mirrors ``infras`` with the Jetson in tier 0 (the
    paper's AR/VR device); None when the fleet has no AR/VR spec."""

    rows: list[dict]  # host metadata, one per scenario
    envs: Environment  # stacked, leading axis = scenario
    infras: InfraParams  # stacked, leading axis = scenario (ACT/LCA differ)
    infras_jetson: InfraParams | None = None

    @property
    def device(self) -> torch.device:
        return self.envs.ci.device


#: Carbon-free PPA carbon intensity: the residual intensity of a 100%
#: renewable-covered DC (paper footnote 1).
CARBON_FREE_CI = 20.0

#: Rural edge network: longer propagation (paper Fig 2; co-calibrated with
#: paper_fleet()).
RURAL_EXTRA_EDGE_LATENCY_S = 0.014875


def _stack(items: list, cls):
    return cls(*[torch.stack([getattr(x, f.name) for x in items])
                 for f in dataclasses.fields(cls)])


def _to(tree, dev: torch.device):
    return None if tree is None else type(tree)(
        *[getattr(tree, f.name).to(dev) for f in dataclasses.fields(tree)])


def build_scenarios(fleet: Fleet, axes: ScenarioAxes | None = None, *,
                    device: str | torch.device = "cuda") -> ScenarioTable:
    """Materialize the scenario grid as stacked tables: built on the CPU,
    then moved to ``device``."""
    dev = resolve_device(device)
    axes = axes or ScenarioAxes()
    traces = {g: ci_mod.grid_trace(g, device=_CPU) for g in Grid}
    # core routers see the average CI across grids (paper §4.3)
    ci_core = float(np.mean([t.ci_hourly.numpy().mean()
                             for t in traces.values()]))
    packed = {m: pack_infra(fleet, m, device=_CPU) for m in ("act", "lca")}
    packed_jet = ({m: pack_infra(fleet, m, "jetson", device=_CPU)
                   for m in ("act", "lca")}
                  if fleet.mobile_arvr is not None else None)
    rural = torch.tensor([RURAL_EXTRA_EDGE_LATENCY_S, 0.0],
                         dtype=torch.float32)

    def localize(infra: InfraParams, eloc) -> InfraParams:
        if eloc == Grid.RURAL:  # geographical trade-off (§3.2)
            return dataclasses.replace(infra, net_lat=infra.net_lat + rural)
        return infra

    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    rows: list[dict] = []
    env_list: list[Environment] = []
    infra_list: list[InfraParams] = []
    jet_list: list[InfraParams] = []
    for charging, mgrid, eloc, cfree, emb, var, hour in itertools.product(
            axes.charging, axes.mobile_grid, axes.edge_location,
            axes.dc_carbon_free, axes.embodied, axes.variance, axes.hours):
        mtrace, etrace = traces[mgrid], traces[eloc]
        ci_mobile = ci_mod.mobile_carbon_intensity(charging, mtrace)
        ci_edge = etrace.ci_hourly[hour]
        # the hyperscale DC sits on the user's regional grid unless the
        # operator buys hourly-matched renewables (carbon-free scenario)
        ci_hyper = (f32(CARBON_FREE_CI) if cfree
                    else mtrace.ci_hourly[hour])
        interf, net = scenario_multipliers(var, device=_CPU)
        env_list.append(Environment(
            ci=torch.stack([f32(ci_mobile), f32(ci_edge), f32(ci_edge),
                            f32(ci_core), f32(ci_hyper)]),
            interference=interf, net_slowdown=net))
        infra_list.append(localize(packed[emb], eloc))
        if packed_jet is not None:
            jet_list.append(localize(packed_jet[emb], eloc))
        rows.append(dict(charging=ChargingBehavior(charging).name,
                         mobile_grid=Grid(mgrid).name,
                         edge_location=Grid(eloc).name,
                         dc_carbon_free=bool(cfree), embodied=emb,
                         variance=VarianceScenario(var).name, hour=int(hour)))

    return ScenarioTable(
        rows=rows, envs=_to(_stack(env_list, Environment), dev),
        infras=_to(_stack(infra_list, InfraParams), dev),
        infras_jetson=_to(_stack(jet_list, InfraParams) if jet_list
                          else None, dev))


@dataclasses.dataclass(frozen=True)
class DesignSpaceResult:
    """Exploration output over (workload, scenario, target), on the host."""

    workload_names: list[str]
    rows: list[dict]
    total_cf: np.ndarray  # (n_workloads, n_scenarios, 3) grams
    op_cf: np.ndarray  # (n_workloads, n_scenarios, 3)
    emb_cf: np.ndarray  # (n_workloads, n_scenarios, 3)
    energy_j: np.ndarray  # (n_workloads, n_scenarios, 3)
    latency: np.ndarray  # (n_workloads, n_scenarios, 3)
    feasible: np.ndarray  # (n_workloads, n_scenarios, 3) bool
    carbon_opt: np.ndarray  # (n_workloads, n_scenarios) argmin target
    energy_opt: np.ndarray
    latency_opt: np.ndarray

    @property
    def n_points(self) -> int:
        return int(np.prod(self.total_cf.shape))


def _explore_block(w: Workload, avail: torch.Tensor, infra: InfraParams,
                   env: Environment) -> tuple[torch.Tensor, ...]:
    """The reference's ``_explore_one`` on a (W, S) broadcast: ``w``
    leaves (W, 1), ``avail`` (W, 1, 3), ``env`` rows (S, ...), one
    ``infra`` shared by the block."""
    b = carbon_model.evaluate(w, infra, env)
    ok = carbon_model.feasible(b, w)
    energy = carbon_model.evaluate_energy(w, infra, env)
    total = b.total_cf
    pick = lambda score: carbon_model.pick_target(score, ok, total, avail)
    return (total, b.op_total, b.emb_total, energy, b.latency, ok & avail,
            pick(total), pick(energy), pick(b.latency))


def _infra_groups(infras: InfraParams) -> list[np.ndarray]:
    """Scenario indices grouped by identical stacked infra rows (ACT/LCA x
    urban/rural edge give at most four)."""
    flat = torch.cat([getattr(infras, f.name).reshape(
        getattr(infras, f.name).shape[0], -1).cpu()
        for f in dataclasses.fields(infras)], dim=1).numpy()
    _, inverse = np.unique(flat, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    return [np.nonzero(inverse == g)[0] for g in range(inverse.max() + 1)]


def explore(infos: Sequence[WorkloadInfo],
            table: ScenarioTable) -> DesignSpaceResult:
    """Evaluate every (workload x scenario x target) cell on the table's
    device: one broadcast evaluation per (client device, fleet variant)."""
    dev = table.device
    infos = tuple(infos)
    ws = stack_workloads(infos, device=dev)
    avail = torch.stack([i.avail_mask for i in infos]).to(dev)
    n_w, n_s = len(infos), table.envs.ci.shape[0]
    is_jet = np.asarray([i.device == "jetson" for i in infos])
    use_jet = table.infras_jetson is not None
    outs = None
    for jet in ((False, True) if use_jet else (False,)):
        w_idx = np.nonzero(is_jet == jet)[0] if use_jet else np.arange(n_w)
        if len(w_idx) == 0:
            continue
        infras = table.infras_jetson if jet else table.infras
        wi = torch.as_tensor(w_idx, device=dev)
        w = Workload(*[getattr(ws, f.name)[wi][:, None]
                       for f in dataclasses.fields(Workload)])
        for s_idx in _infra_groups(infras):
            si = torch.as_tensor(s_idx, device=dev)
            infra = InfraParams(*[getattr(infras, f.name)[s_idx[0]]
                                  for f in dataclasses.fields(InfraParams)])
            env = Environment(ci=table.envs.ci[si],
                              interference=table.envs.interference[si],
                              net_slowdown=table.envs.net_slowdown[si])
            block = _explore_block(w, avail[wi][:, None], infra, env)
            if outs is None:
                outs = [torch.zeros((n_w, n_s) + tuple(b.shape[2:]),
                                    dtype=b.dtype, device=dev)
                        for b in block]
            for out, b in zip(outs, block):
                out[wi[:, None], si[None, :]] = b
    (total, op, emb, energy, lat, ok, copt, eopt, lopt) = [
        o.cpu().numpy() for o in outs]
    copt, eopt, lopt = (a.astype(np.int32) for a in (copt, eopt, lopt))
    return DesignSpaceResult(
        workload_names=[i.name for i in infos], rows=table.rows,
        total_cf=total, op_cf=op, emb_cf=emb, energy_j=energy, latency=lat,
        feasible=ok, carbon_opt=copt, energy_opt=eopt, latency_opt=lopt)


def scenario_mask(rows: list[dict], **conds) -> np.ndarray:
    """Boolean mask over scenarios matching all host-side conditions."""
    mask = np.ones(len(rows), dtype=bool)
    for k, v in conds.items():
        mask &= np.asarray([r[k] == v for r in rows])
    return mask
