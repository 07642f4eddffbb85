"""Declarative scenario matrix: (arrival pattern x grid event x fleet)
(port of ``src/repro/serve/scenarios.py``).

One scenario is one named, seeded composition of the three axes the
serving stack models separately:

  * **arrival pattern** (``ArrivalSpec``): the continuous-time Poisson
    process of ``streams.arrival_stream``: diurnal shape, flash-crowd
    spike, deferrable batch share.
  * **grid event** (``GridEventSpec``): CI perturbations baked into the
    grid's actuals AND forecast via ``streams.bake_ci_events``: a regional
    CI step change, a renewable-curtailment near-zero-CI window, plus an
    optional rolling-forecast error overlay.
  * **fleet hardware** (``FleetSpec``): which ``Fleet`` the routers cost
    against and, for watt-shaped heterogeneous fleets, a per-region
    ``TierEnvelope`` power budget turned into an (R, 3) admission-cap
    matrix by ``infrastructure.watt_caps``.

``Scenario.build(n)`` materialises the composition into a ``ScenarioRun``
(stream, grid, fleet, caps); ``run_matrix`` routes every registered policy
over every scenario and returns one ``MatrixCell`` per (scenario, policy)
pair, the matrix ``repro_torch.launch.scenario_matrix`` prints.

Everything is seeded: the same ``(scenario, n)`` gives a bit-identical
stream, grid and caps. Grids are built on the CPU (the reference's numpy
draws reproduced bit for bit) and moved to the routing device by
``FleetRouter``. ``route_scenario`` returns the router's tensors as they
are (the port donates no buffers, so the reference's host copy has no
counterpart); ``caps_violation`` takes tensors or arrays. ``mesh=`` routes
through the sharded program (``repro_torch.serve.distributed``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.configs import get_config
from repro_torch.core.carbon_intensity import (
    DEFAULT_REGIONS,
    CarbonGrid,
    RegionSpec,
    region_power_budgets,
)
from repro_torch.core.infrastructure import (
    Fleet,
    TierEnvelope,
    pack_infra,
    paper_envelope,
    paper_fleet,
    tpu_envelope,
    tpu_fleet,
    watt_caps,
)
from repro_torch.device import resolve_device
from repro_torch.serve.placement import PlacementPolicy
from repro_torch.serve.policy import OraclePolicy
from repro_torch.serve.router import (
    FleetRouter,
    FleetRouteResult,
    RequestBatch,
)
from repro_torch.serve.streams import arrival_stream, bake_ci_events
from repro_torch.serve.temporal import TemporalPolicy

#: default model architecture the matrix routes (any ``get_config`` name
#: works; the matrix compares policies, not models).
ARCH = "h2o-danube-1.8b"


# ---------------------------------------------------------------------------
# the three axes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Arrival-pattern axis: parameters of ``streams.arrival_stream``.

    ``spike_at_h``/``spike_mult``/``spike_width_h`` shape the flash crowd
    (intensity x ``spike_mult`` inside a ``spike_width_h``-wide window);
    ``batch_frac`` tags that share of arrivals deferrable with slack drawn
    from ``slack_range_h`` (hours). The request *rate* is derived from the
    matrix's ``n`` so every scenario routes a comparably sized stream:
    ``rate_per_h ~= n / duration_h`` (the diurnal modulation has mean 1).
    """

    diurnal: bool = True
    peak: float = 20.0
    spike_at_h: float | None = None
    spike_mult: float = 1.0
    spike_width_h: float = 1.0
    batch_frac: float = 0.5
    slack_range_h: tuple[int, int] = (6, 16)

    def build(self, n: int, n_regions: int, duration_h: float, seed: int
              ) -> tuple[RequestBatch, np.ndarray, np.ndarray]:
        """Sample ``~n`` arrivals over ``[0, duration_h)`` hours."""
        return arrival_stream(
            max(n, 1) / duration_h, duration_h, n_regions, seed,
            diurnal=self.diurnal, peak=self.peak,
            spike_at_h=self.spike_at_h, spike_mult=self.spike_mult,
            spike_width_h=self.spike_width_h, batch_frac=self.batch_frac,
            slack_range_h=self.slack_range_h)


@dataclasses.dataclass(frozen=True)
class GridEventSpec:
    """Grid-event axis: what ``streams.bake_ci_events`` bakes into the
    grid's hourly CI (gCO2/kWh) — actuals and forecast alike — plus an
    optional rolling-forecast error overlay (``sigma_h`` is the per-
    hour-ahead relative error scale of ``CarbonGrid.forecast_from_actual``;
    applied BEFORE baking so the event shows up in both views).
    """

    ci_step_region: int | None = None
    ci_step_window: tuple[int, int] = (6, 18)
    ci_step_mult: float = 2.5
    curtail_region: int | None = None
    curtail_window: tuple[int, int] = (11, 15)
    curtail_floor: float = 0.0
    sigma_h: float = 0.0

    def apply(self, grid: CarbonGrid, seed: int) -> CarbonGrid:
        if self.sigma_h:
            grid = grid.forecast_from_actual(self.sigma_h, seed=seed)
        return bake_ci_events(
            grid, ci_step_region=self.ci_step_region,
            ci_step_window=self.ci_step_window,
            ci_step_mult=self.ci_step_mult,
            curtail_region=self.curtail_region,
            curtail_window=self.curtail_window,
            curtail_floor=self.curtail_floor)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Fleet-hardware axis: which ``Fleet`` the router costs against and,
    optionally, per-region watt budgets shaping admission capacity.

    With ``power_budget_w`` set (one ``(mobile, edge_dc, hyper_dc)`` watt
    triple per region, cycled to the scenario's region count and attached
    to each ``RegionSpec``), ``caps`` returns the watt-shaped (R, 3) cap
    matrix ``infrastructure.watt_caps`` derives from the ``envelope``'s
    per-server TDP — tiers on small power feeds admit fewer concurrent
    requests per window. Without budgets, ``caps`` is the uniform per-cell
    DC cap the throughput benchmarks use (mobile unbounded, repo-wide).
    """

    fleet: str = "tpu"  # "tpu" | "paper"
    power_budget_w: tuple[tuple[float, float, float], ...] | None = None
    slots_per_server: float = 64.0

    def make_fleet(self) -> Fleet:
        if self.fleet == "tpu":
            return tpu_fleet()
        if self.fleet == "paper":
            return paper_fleet()
        raise ValueError(f"unknown fleet {self.fleet!r}")

    def envelope(self) -> TierEnvelope:
        return tpu_envelope() if self.fleet == "tpu" else paper_envelope()

    def regions(self, n_regions: int) -> tuple[RegionSpec, ...]:
        """``DEFAULT_REGIONS`` cycled to ``n_regions``, each carrying its
        watt budget when ``power_budget_w`` is set."""
        base = [dataclasses.replace(
            DEFAULT_REGIONS[i % len(DEFAULT_REGIONS)],
            name=f"{DEFAULT_REGIONS[i % len(DEFAULT_REGIONS)].name}"
                 + ("" if i < len(DEFAULT_REGIONS) else f"-{i}"))
            for i in range(n_regions)]
        if self.power_budget_w is not None:
            base = [dataclasses.replace(
                spec, power_budget_w=self.power_budget_w[
                    i % len(self.power_budget_w)])
                for i, spec in enumerate(base)]
        return tuple(base)

    def caps(self, regions: tuple[RegionSpec, ...],
             per_cell: float) -> np.ndarray:
        """(R, 3) float per-window admission caps (requests per window
        cell). Watt-shaped from the region power budgets when set; else
        the uniform DC cap ``per_cell`` with mobile unbounded."""
        if self.power_budget_w is not None:
            return watt_caps(self.envelope(), region_power_budgets(regions),
                             slots_per_server=self.slots_per_server)
        caps = np.full((len(regions), 3), np.inf)
        caps[:, 1] = caps[:, 2] = per_cell
        return caps


# ---------------------------------------------------------------------------
# scenario = one named point of the (arrival x event x fleet) product
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScenarioRun:
    """A built scenario: everything needed to route it."""

    batch: RequestBatch
    region: np.ndarray  # (N,) int home region per request
    t_hours: np.ndarray  # (N,) float arrival hours (absolute, sorted)
    grid: CarbonGrid
    regions: tuple[RegionSpec, ...]
    fleet: Fleet
    caps: np.ndarray  # (R, 3) float per-window admission caps


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named, seeded (arrival x grid event x fleet) composition.

    ``cap_frac`` sizes the uniform DC caps relative to perfectly balanced
    load (``cap_frac * n / (R * duration_h)`` requests per window cell —
    the throughput-benchmark convention); watt-shaped fleets ignore it.
    """

    name: str
    description: str
    arrival: ArrivalSpec = ArrivalSpec()
    event: GridEventSpec = GridEventSpec()
    fleet: FleetSpec = FleetSpec()
    n_regions: int = 4
    n_days: int = 1
    seed: int = 0
    latency_penalty: float = 1.05
    cap_frac: float = 0.5

    @property
    def duration_h(self) -> float:
        return 24.0 * self.n_days

    def build(self, n: int) -> ScenarioRun:
        """Materialise the scenario for a ``~n``-request stream. Seeded:
        same ``(scenario, n)`` -> bit-identical ``ScenarioRun``; the grid
        lies on the CPU."""
        regions = self.fleet.regions(self.n_regions)
        batch, region, t_hours = self.arrival.build(
            n, self.n_regions, self.duration_h, self.seed)
        grid = CarbonGrid.fully_connected(
            regions, latency_penalty=self.latency_penalty,
            n_days=self.n_days, device="cpu")
        grid = self.event.apply(grid, self.seed)
        per_cell = max(1.0, self.cap_frac * n
                       / (self.n_regions * self.duration_h))
        return ScenarioRun(batch=batch, region=region, t_hours=t_hours,
                           grid=grid, regions=regions,
                           fleet=self.fleet.make_fleet(),
                           caps=self.fleet.caps(regions, per_cell))


def default_scenarios() -> dict[str, Scenario]:
    """The named scenario registry the benchmark matrix runs.

    Fresh objects per call (specs are frozen, but callers may extend the
    dict). Names are pinned: the reference's benchmark and
    ``repro_torch.launch.scenario_matrix`` emit one row per (scenario,
    policy) under these names.
    """
    return {s.name: s for s in (
        Scenario(
            "steady_diurnal",
            "Baseline: diurnal arrivals, clean grid, uniform caps.",
        ),
        Scenario(
            "flash_crowd_10x",
            "10x arrival spike at the 20:00 diurnal peak, 2 h wide — "
            "admission pressure exactly when grids are dirtiest.",
            arrival=ArrivalSpec(spike_at_h=20.0, spike_mult=10.0,
                                spike_width_h=2.0),
        ),
        Scenario(
            "curtailment_midday",
            "Region 1's CI drops to 5% inside 11:00-15:00 (solar "
            "curtailment) under a morning-peaking office-hours stream — "
            "deferral and spill should chase the window. Caps are loose "
            "(cap_frac 4) so the comparison isolates CI chasing from "
            "shed accounting.",
            arrival=ArrivalSpec(peak=10.0),
            event=GridEventSpec(curtail_region=1, curtail_window=(11, 15),
                                curtail_floor=0.05),
            cap_frac=4.0,
        ),
        Scenario(
            "curtailment_zero_ci",
            "Same office-hours stream with an exactly-zero-CI "
            "curtailment window (floor 0.0): the edge case every score "
            "must stay finite through.",
            arrival=ArrivalSpec(peak=10.0),
            event=GridEventSpec(curtail_region=1, curtail_window=(11, 15),
                                curtail_floor=0.0),
            cap_frac=4.0,
        ),
        Scenario(
            "ci_step_evening",
            "Region 0's CI steps 2.5x inside 16:00-22:00 (renewable "
            "lull across the evening peak).",
            event=GridEventSpec(ci_step_region=0,
                                ci_step_window=(16, 22)),
        ),
        Scenario(
            "hetero_fleet_watt",
            "Watt-shaped heterogeneous fleet: alternating small/large "
            "per-region DC power feeds (2.5 vs 10 kW edge, 64 vs 260 kW "
            "hyper) turn into hard per-window admission caps via "
            "TierEnvelope TDP — a 4x capacity skew across the fleet.",
            fleet=FleetSpec(power_budget_w=(
                (np.inf, 2500.0, 64000.0),
                (np.inf, 10000.0, 260000.0),
            )),
        ),
        Scenario(
            "multiday_forecast",
            "Two-day horizon with a sigma_h=0.06 rolling forecast error "
            "overlay plus a day-one midday curtailment window.",
            event=GridEventSpec(curtail_region=2, curtail_window=(11, 15),
                                curtail_floor=0.05, sigma_h=0.06),
            n_days=2,
        ),
    )}


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

def default_policies() -> dict[str, "PolicyFactory"]:
    """Named policy factories — each maps ``(infra, caps)`` to a
    ``RoutingPolicy`` routed over every scenario:

      * ``oracle-immediate`` — capacity-capped Table-1 carbon oracle with
        cross-region spill, no deferral.
      * ``temporal-defer``   — the joint (defer, region, tier) policy,
        12 h deferral horizon, mild forecast-risk aversion.
      * ``latency-greedy``   — carbon-blind latency-optimal baseline under
        the same caps (the paper's Fig-5 objective as a policy).
    """
    return {
        "oracle-immediate": lambda infra, caps: PlacementPolicy(
            OraclePolicy(infra), caps),
        "temporal-defer": lambda infra, caps: TemporalPolicy(
            OraclePolicy(infra), caps, max_defer_h=12, risk_lambda=0.5),
        "latency-greedy": lambda infra, caps: PlacementPolicy(
            OraclePolicy(infra, metric="latency"), caps),
    }


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MatrixCell:
    """One (scenario, policy) result row of the matrix. Carbon in gCO2,
    defer in hours, rates as fractions of the stream."""

    scenario: str
    policy: str
    n: int  # stream size actually routed
    total_g: float  # total_carbon_g (shed counted at nominal placement)
    routed_g: float  # carbon over non-shed requests only
    latency_opt_g: float  # same stream, latency-optimal counterfactual
    shed_rate: float
    spill_rate: float
    defer_rate: float
    mean_defer_h: float

    @property
    def saved_vs_latency_g(self) -> float:
        """gCO2 saved vs. the latency-optimal counterfactual."""
        return self.latency_opt_g - self.total_g


def _cell(scenario: str, policy: str, n: int,
          res: FleetRouteResult) -> MatrixCell:
    # rates are host float64 ratios of the integer counts, as the
    # reference forms them from its host copy of the result
    rows = int(res.target.shape[0])
    return MatrixCell(
        scenario=scenario, policy=policy, n=n,
        total_g=float(res.total_carbon_g),
        routed_g=float(res.routed_carbon_g),
        latency_opt_g=float(res.latency_opt_carbon_g),
        shed_rate=int(res.shed_count) / rows,
        spill_rate=int(res.spilled_count) / rows,
        defer_rate=int(res.deferred_count) / rows,
        mean_defer_h=float(res.mean_defer_hours))


def route_scenario(scenario: Scenario, policy_factory, *, n: int = 2000,
                   arch: str = ARCH, mesh=None,
                   device: str | torch.device = "cuda"
                   ) -> tuple[FleetRouteResult, object, ScenarioRun]:
    """Build ``scenario``, route it under ``policy_factory(infra, caps)`` on
    ``device``, and return ``(result, final_policy_state, run)``: the state
    carries per-request execution details (``TemporalState.exec_hour``,
    ``PlacementState.counts``) the cap-property checks consume. ``mesh``
    shards the route (``FleetRouter.route_stream``)."""
    run = scenario.build(n)
    fr = scenario_router(run, policy_factory, arch=arch, device=device)
    res, state = fr.route_stream_with_state(run.batch, run.region,
                                            run.t_hours, mesh=mesh)
    return res, state, run


def scenario_router(run: ScenarioRun, policy_factory, *, arch: str = ARCH,
                    device: str | torch.device = "cuda") -> FleetRouter:
    """The ``FleetRouter`` ``route_scenario`` routes ``run`` with: the
    run's fleet, regions and grid (moved to ``device``) under
    ``policy_factory(infra, caps)``. For callers that route one built run
    more than once (a warm-up, then a timed call)."""
    dev = resolve_device(device)
    infra = pack_infra(run.fleet, "act", device=dev)
    return FleetRouter(get_config(arch), fleet=run.fleet, regions=run.regions,
                       grid=run.grid, policy=policy_factory(infra, run.caps),
                       device=dev)


def run_matrix(scenarios: dict[str, Scenario] | None = None,
               policies: dict[str, "PolicyFactory"] | None = None, *,
               n: int = 2000, arch: str = ARCH, mesh=None,
               device: str | torch.device = "cuda") -> list[MatrixCell]:
    """Route every policy over every scenario: the full results matrix,
    one ``MatrixCell`` per (scenario, policy), scenario-major order
    matching the registries' iteration order. Deterministic for a fixed
    ``(scenarios, policies, n, arch)``, with or without a ``mesh``."""
    scenarios = default_scenarios() if scenarios is None else scenarios
    policies = default_policies() if policies is None else policies
    cells: list[MatrixCell] = []
    for sname, scenario in scenarios.items():
        for pname, factory in policies.items():
            res, _, run = route_scenario(scenario, factory, n=n, arch=arch,
                                         mesh=mesh, device=device)
            cells.append(_cell(sname, pname, len(run.batch), res))
    return cells


def matrix_csv(cells: list[MatrixCell]) -> str:
    """The matrix as CSV text (header + one row per cell)."""
    header = ("scenario,policy,n,total_g,routed_g,latency_opt_g,"
              "shed_rate,spill_rate,defer_rate,mean_defer_h")
    rows = [f"{c.scenario},{c.policy},{c.n},{c.total_g:.3f},"
            f"{c.routed_g:.3f},{c.latency_opt_g:.3f},{c.shed_rate:.4f},"
            f"{c.spill_rate:.4f},{c.defer_rate:.4f},{c.mean_defer_h:.3f}"
            for c in cells]
    return "\n".join([header] + rows)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def caps_violation(res: FleetRouteResult, state, t_hours: np.ndarray,
                   caps: np.ndarray, n_windows: int) -> float:
    """Largest per-(window, region, tier) admission-count excess over
    ``caps`` — <= 0 means no cell ever exceeded its cap (the watt-shaped
    property the benchmark asserts). Non-shed requests are counted at
    their EXECUTED (hour, region, tier): arrival hour for immediate
    policies, ``TemporalState.exec_hour`` for deferring ones. Results and
    states may hold tensors on any device or numpy arrays."""
    target = _host(res.target)
    shed = _host(state.shed)
    exec_hour = (_host(state.exec_hour) if hasattr(state, "exec_hour")
                 else np.floor(np.asarray(t_hours)).astype(np.int64))
    exec_region = (_host(state.exec_region)
                   if state.exec_region is not None
                   else _host(res.exec_region))
    live = ~shed
    win = exec_hour[live].astype(np.int64) % n_windows
    counts = np.zeros((n_windows, caps.shape[0], 3), np.int64)
    np.add.at(counts, (win, exec_region[live], target[live]), 1)
    return float((counts - caps[None]).max())
