"""GreenScaleRouter and FleetRouter — carbon-aware execution-target
selection (paper Table 1 applied to LM serving), from one request to a
fleet-scale stream.

Port of ``Request``, ``RouteDecision``, ``RequestBatch``,
``request_workload``, ``GreenScaleRouter``, ``FleetRouteResult`` and
``FleetRouter`` from the reference ``serve/router.py``. Each request
becomes a workload descriptor and a pluggable ``RoutingPolicy`` (default:
the Table-1 carbon oracle) picks its tier; ``FleetRouter`` routes a
(region, hour)-tagged stream against a ``CarbonGrid`` and charges the
decisions at actual CI. The reference's jit and buffer donation have no
counterpart here: ``_fleet_route`` is the same arithmetic as eager torch
on the router's device. ``route_stream_rolling`` delegates to
``serve.forecast`` and ``admit_windows(queue=...)`` to ``serve.queue``.
With a mesh (``FleetRouter(mesh=...)`` or ``route_stream(..., mesh=...)``,
a 1-D ``DeviceMesh`` of ``serve.distributed.data_mesh``) every stream is
routed by the sharded program of ``serve.distributed``, with the same
decisions.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import carbon_model
from repro_torch.core.carbon_intensity import (
    DEFAULT_REGIONS,
    CarbonGrid,
    RegionSpec,
    site_regions,
)
from repro_torch.core.carbon_model import Environment, RouteOutputs
from repro_torch.core.constants import N_TARGETS
from repro_torch.core.infrastructure import Fleet, pack_infra, tpu_fleet
from repro_torch.core.workloads import Workload, batch_workloads
from repro_torch.device import resolve_device
from repro_torch.serve.policy import OraclePolicy, RoutingPolicy, take_cols


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request."""

    prompt_tokens: int
    max_new_tokens: int
    latency_budget_s: float = 2.0
    bytes_per_token: float = 4.0
    #: which tiers can hold this model at all (e.g. 72B never fits on-device)
    available: tuple[bool, bool, bool] = (True, True, True)
    #: deferral allowance in hours (consumed only by temporal policies)
    slack_hours: float = 0.0


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    target: int  # Target enum value
    carbon_g: float
    latency_s: float
    feasible: bool
    per_target_carbon: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class RequestBatch:
    """Columnar request batch: (N,) float64 columns + (N, 3) availability."""

    prompt_tokens: np.ndarray
    max_new_tokens: np.ndarray
    latency_budget_s: np.ndarray
    bytes_per_token: np.ndarray
    available: np.ndarray  # (N, 3) bool
    slack_hours: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.prompt_tokens)

    @classmethod
    def from_requests(cls, reqs: list[Request]) -> "RequestBatch":
        n = len(reqs)
        col = lambda attr: np.fromiter(
            (getattr(r, attr) for r in reqs), np.float64, n)
        return cls(
            prompt_tokens=col("prompt_tokens"),
            max_new_tokens=col("max_new_tokens"),
            latency_budget_s=col("latency_budget_s"),
            bytes_per_token=col("bytes_per_token"),
            available=np.array([r.available for r in reqs],
                               bool).reshape(n, 3),
            slack_hours=col("slack_hours"),
        )

    @property
    def slack_h(self) -> np.ndarray:
        """(N,) int32 whole-hour slack (zeros when untagged)."""
        if self.slack_hours is None:
            return np.zeros(len(self), np.int32)
        return np.floor(np.asarray(self.slack_hours)).astype(np.int32)

    def workload(self, cfg: ModelConfig, *,
                 device: str | torch.device = "cuda") -> Workload:
        """Stacked descriptors, products taken in float64 on the host."""
        n_active = cfg.active_param_count()
        total_tokens = self.prompt_tokens + self.max_new_tokens
        return batch_workloads(
            flops=2.0 * n_active * total_tokens,
            mem_bytes=2.0 * n_active * np.maximum(self.max_new_tokens, 1),
            data_in=self.bytes_per_token * self.prompt_tokens,
            data_out=self.bytes_per_token * self.max_new_tokens,
            latency_req=self.latency_budget_s,
            device=device,
        )

    def avail(self, *, device: str | torch.device = "cuda") -> torch.Tensor:
        return torch.as_tensor(self.available, device=resolve_device(device))


def request_workload(cfg: ModelConfig, req: Request, *,
                     device: str | torch.device = "cuda") -> Workload:
    """Descriptor for one LM request: 2·N_active FLOPs per token over the
    prefill + decode tokens; decode re-reads the active params every
    generated token."""
    n_active = cfg.active_param_count()
    total_tokens = req.prompt_tokens + req.max_new_tokens
    return Workload.make(
        flops=2.0 * n_active * total_tokens,
        mem_bytes=2.0 * n_active * max(req.max_new_tokens, 1),
        data_in=req.bytes_per_token * req.prompt_tokens,
        data_out=req.bytes_per_token * req.max_new_tokens,
        latency_req=req.latency_budget_s,
        device=device,
    )


def _decisions_from_outputs(out: RouteOutputs) -> list[RouteDecision]:
    """Unpack batched RouteOutputs into per-request RouteDecision objects."""
    target = out.target.cpu().numpy()
    cf = out.total_cf.cpu().numpy()
    lat = out.latency.cpu().numpy()
    ok = out.ok.cpu().numpy()
    idx = np.arange(len(target))
    carbon = cf[idx, target]
    latency = lat[idx, target]
    feas = ok[idx, target]
    return [
        RouteDecision(target=int(t), carbon_g=float(c), latency_s=float(l),
                      feasible=bool(f), per_target_carbon=tuple(map(float, row)))
        for t, c, l, f, row in zip(target, carbon, latency, feas, cf)
    ]


def _check_policy(policy) -> None:
    """Only the port's own policies decide here."""
    if policy is not None and not isinstance(policy, RoutingPolicy):
        raise NotImplementedError(
            f"{type(policy).__name__} is not a repro_torch RoutingPolicy; "
            "the port routes with OraclePolicy, LearnedPolicy, "
            "CapacityLimiter, PlacementPolicy and TemporalPolicy")


@dataclasses.dataclass
class GreenScaleRouter:
    """Carbon-aware tier selection for a serving fleet (one environment).
    ``policy`` plugs any ``RoutingPolicy`` into the decision; None is the
    Table-1 carbon oracle."""

    cfg: ModelConfig
    fleet: Fleet = dataclasses.field(default_factory=tpu_fleet)
    embodied_model: str = "act"
    policy: RoutingPolicy | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        _check_policy(self.policy)
        self.device = resolve_device(self.device)
        self._infra = pack_infra(self.fleet, self.embodied_model,
                                 device=self.device)

    @property
    def infra(self):
        """Packed ``InfraParams`` of this router's fleet."""
        return self._infra

    def route(self, req: Request, env: Environment) -> RouteDecision:
        w = request_workload(self.cfg, req, device=self.device)
        avail = torch.as_tensor(req.available, device=self.device)
        out = carbon_model.route_one(w, self._infra, env, avail)
        t = int(out.target)
        cf = out.total_cf.cpu().numpy()
        return RouteDecision(
            target=t,
            carbon_g=float(cf[t]),
            latency_s=float(out.latency[t]),
            feasible=bool(out.ok[t]),
            per_target_carbon=tuple(float(x) for x in cf),
        )

    def route_batch(self, reqs: list[Request], env: Environment
                    ) -> list[RouteDecision]:
        """All requests in one batched evaluation (no per-request loop)."""
        if not reqs:
            return []
        out = self.route_batch_arrays(RequestBatch.from_requests(reqs), env)
        return _decisions_from_outputs(out)

    def route_batch_arrays(self, batch: RequestBatch, env: Environment,
                           hour=None) -> RouteOutputs:
        """Array-in/array-out batched routing. With a ``policy`` the Table-1
        evaluation still supplies the per-tier columns and ``target`` is
        the policy's decision; ``hour`` (scalar or (N,)) is forwarded to
        the policy."""
        w = batch.workload(self.cfg, device=self.device)
        avail = batch.avail(device=self.device)
        out = carbon_model.route_many(w, self._infra, env, avail)
        if self.policy is None:
            return out
        n = len(batch)
        env_b = Environment(ci=env.ci.expand((n,) + tuple(env.ci.shape)),
                            interference=env.interference,
                            net_slowdown=env.net_slowdown)
        if hour is not None:
            hour = torch.as_tensor(hour, dtype=torch.float32,
                                   device=self.device).expand((n,))
        slack = (None if batch.slack_hours is None
                 else torch.as_tensor(batch.slack_h, device=self.device))
        targets, _ = self.policy.decide(
            w, env_b, avail, self.policy.initial_state(1, n),
            hour=hour, outputs=out, slack=slack)
        return dataclasses.replace(out, target=targets.to(out.target.dtype))


# ---------------------------------------------------------------------------
# Fleet-level routing: many regions, hourly CI traces, aggregate savings
# ---------------------------------------------------------------------------


_admit_windows_warned = False


def _warn_admit_windows() -> None:
    """Warn ONCE per process that bucketed admission is deprecated."""
    global _admit_windows_warned
    if not _admit_windows_warned:
        _admit_windows_warned = True
        warnings.warn(
            "hourly-bucketed admit_windows is deprecated: requests arrive "
            "continuously, not in hour buckets. Continuous-batching "
            "admission: run repro_torch.serve.queue.serve_stream and pass "
            "its QueueServeResult as queue= (or call "
            "repro_torch.serve.queue.admit_batches directly).",
            DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class FleetRouteResult:
    """Aggregate result of routing a request stream across the fleet.

    ``oracle_carbon_g`` is the carbon-optimal Table-1 pick under each
    request's HOME region, ``latency_opt_carbon_g`` / ``energy_opt_carbon_g``
    the paper's baselines, all charged at actual CI. ``exec_region`` is
    where each request executes (home except for cross-region spill)."""

    target: torch.Tensor  # (N,) int32 chosen tier
    carbon_g: torch.Tensor  # (N,) gCO2 of the chosen (region, tier, hour)
    feasible: torch.Tensor  # (N,) bool — chosen tier meets its QoS budget
    counts: torch.Tensor  # (R, 3) int32 assignments per executed pair,
    #                       shed requests excluded
    total_carbon_g: torch.Tensor  # () sum of carbon_g (shed at nominal)
    routed_carbon_g: torch.Tensor  # () sum over NON-shed requests
    latency_opt_carbon_g: torch.Tensor  # ()
    energy_opt_carbon_g: torch.Tensor  # ()
    oracle_carbon_g: torch.Tensor  # ()
    infeasible_count: torch.Tensor  # () picks violating their QoS budget
    shed_count: torch.Tensor  # () capacity-shed requests
    exec_region: torch.Tensor  # (N,) int32 executing region
    spilled_count: torch.Tensor  # () requests executed off-home
    deferred_count: torch.Tensor  # () non-shed requests run after arrival
    mean_defer_hours: torch.Tensor  # () float32 mean defer of those

    @property
    def saved_vs_latency_g(self) -> torch.Tensor:
        return self.latency_opt_carbon_g - self.total_carbon_g

    @property
    def saved_vs_energy_g(self) -> torch.Tensor:
        return self.energy_opt_carbon_g - self.total_carbon_g

    @property
    def extra_vs_oracle_g(self) -> torch.Tensor:
        """Carbon regret of this policy vs. the Table-1 carbon oracle."""
        return self.total_carbon_g - self.oracle_carbon_g

    @property
    def qos_violation_rate(self) -> torch.Tensor:
        return self.infeasible_count / self.target.shape[0]

    @property
    def shed_rate(self) -> torch.Tensor:
        return self.shed_count / self.target.shape[0]

    @property
    def spill_rate(self) -> torch.Tensor:
        """Fraction of the stream executed outside its home region."""
        return self.spilled_count / self.target.shape[0]

    @property
    def defer_rate(self) -> torch.Tensor:
        """Fraction of the stream executed after its arrival hour."""
        return self.deferred_count / self.target.shape[0]


@dataclasses.dataclass
class FleetRouter:
    """Route a (region, time)-tagged request stream against regional grids.

    The fleet's carbon state is one ``CarbonGrid`` (``self.grid``); routing
    gathers each request's CI row by (region, hour) and the policy decides
    (default: the Table-1 carbon oracle). A policy with a ``bind_grid``
    hook adopts the router's grid. ``device`` defaults to the grid's device
    when a grid is given, else ``"cuda"``; a grid on another device is
    moved."""

    cfg: ModelConfig
    fleet: Fleet = dataclasses.field(default_factory=tpu_fleet)
    embodied_model: str = "act"
    regions: tuple[RegionSpec, ...] = DEFAULT_REGIONS
    interference: tuple[float, float, float] = (1.0, 1.0, 1.0)
    net_slowdown: tuple[float, float] = (1.0, 1.0)
    policy: RoutingPolicy | None = None
    grid: CarbonGrid | None = None
    #: 1-D ``DeviceMesh`` to shard every stream over (every rank of it
    #: routes the same whole stream; ``serve.distributed``)
    mesh: object | None = None
    device: str | torch.device | None = None

    def __post_init__(self):
        _check_policy(self.policy)
        if self.device is None:
            self.device = ("cuda" if self.grid is None else self.grid.device)
        self.device = resolve_device(self.device)
        self._infra = pack_infra(self.fleet, self.embodied_model,
                                 device=self.device)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                        device=self.device)
        self._interference = f32(self.interference)
        self._net_slowdown = f32(self.net_slowdown)
        if self.grid is None:
            self.grid = CarbonGrid.from_regions(self.regions,
                                                device=self.device)
        else:
            if self.grid.device != self.device:
                self.grid = self.grid.to(self.device)
            if self.grid.n_regions != len(self.regions):
                if (self.regions is DEFAULT_REGIONS
                        and self.grid.n_regions > len(DEFAULT_REGIONS)):
                    # mesoscale grids carry their own site count
                    self.regions = site_regions(self.grid.n_regions)
                else:
                    raise ValueError(
                        f"grid covers {self.grid.n_regions} regions, "
                        f"router has {len(self.regions)}")
        self._ci_table = self.grid.table  # (R, H, 5) actuals — the charge
        # the forecast view policies decide on: the same tensor when no
        # forecast is attached (the split is inert)
        self._ci_fc = (self._ci_table if self.grid.ci_forecast is None
                       else self.grid.table_forecast)
        self._horizon_h = int(self._ci_table.shape[1])
        if self.policy is None:
            self.policy = OraclePolicy(self._infra)
        bind = getattr(self.policy, "bind_grid", None)
        if bind is not None:
            bind(self.grid)

    @property
    def infra(self):
        """Packed ``InfraParams`` of this router's fleet, for building
        policies: ``OraclePolicy(router.infra, ...)``."""
        return self._infra

    def _route_rows(self, w: Workload, avail, region, hour, ci_table, ci_fc,
                    state, order, inv_order, slack, cap_scale, used0,
                    axis_name=None) -> tuple[dict, object]:
        """One stream through the policy, per row: the policy decides on
        the forecast view ``ci_fc``, carbon is charged at the actuals
        ``ci_table``. Returns ``(rows, new_state)``; ``rows`` holds the
        (N,) ``target``, ``carbon``, ``feas``, ``exec_region``, ``shed``
        (None for a policy without capacity), ``exec_hour`` and ``defer``
        (None unless temporal), and the baselines' carbon at actuals
        (``ref_latency``, ``ref_energy``, ``ref_oracle``). ``axis_name`` is
        the process group of a sharded stream (``serve.distributed``)."""
        interference, net_slowdown = self._interference, self._net_slowdown
        policy, infra = self.policy, self._infra
        # forecast/actual split: decide on the forecast, charge at actuals;
        # without a forecast both are one table and the split is inert
        split = self.grid.ci_forecast is not None
        env = Environment(ci=ci_fc[region, hour],  # (N, 5) forecast view
                          interference=interference,
                          net_slowdown=net_slowdown)
        if getattr(policy, "wants_factors", False):
            factors = carbon_model.energy_factors_batch(
                w, infra, interference, net_slowdown)
            out = carbon_model.route_many_from_factors(factors, w, env.ci,
                                                       avail)
        else:
            factors = None
            out = carbon_model.route_many_envs(w, infra, env, avail)
        # settle at actuals: what a target vector costs at the arrival
        # (region, hour); QoS feasibility is CI-free
        if not split:
            cf_act = out.total_cf
        elif factors is not None:
            cf_act = carbon_model.total_cf_from_factors(
                factors, ci_table[region, hour])
        else:
            cf_act = carbon_model.route_many_envs(
                w, infra, Environment(ci=ci_table[region, hour],
                                      interference=interference,
                                      net_slowdown=net_slowdown),
                avail).total_cf
        take_act = lambda t: take_cols(cf_act, t)
        targets, new_state = policy.decide(
            w, env, avail, state, region=region, hour=hour, outputs=out,
            order=order, inv_order=inv_order, slack=slack, factors=factors,
            fc_table=ci_fc, cap_scale=cap_scale, used0=used0,
            axis_name=axis_name)
        targets = targets.to(torch.int32)
        shed = getattr(new_state, "shed", None)
        exec_region = getattr(new_state, "exec_region", None)
        exec_hour = getattr(new_state, "exec_hour", None)
        if exec_region is None and exec_hour is None:
            # executes on arrival, charged at the arrival cell's actual CI
            exec_region = region
            carbon = take_act(targets)
            feas = take_cols(out.ok, targets)
        elif factors is not None:
            # executed-placement accounting on the factorized evaluator:
            # home [mobile, edge_net] billed in the home region at the
            # execution hour, [edge_dc, core_net, hyper_dc] at the
            # executing region, the WAN hop in the QoS check
            er = region if exec_region is None else exec_region.long()
            eh = hour if exec_hour is None else exec_hour.long()
            exec_region = er
            ci_exec = torch.cat([ci_table[region, eh][:, :2],
                                 ci_table[er, eh][:, 2:]], dim=1)
            cf_exec = carbon_model.total_cf_from_factors(factors, ci_exec)
            ok_exec = carbon_model.qos_feasible_from_factors(
                factors, w, self.grid.rtt_s[region, er]) & avail
            carbon = take_cols(cf_exec, targets)
            feas = take_cols(ok_exec, targets)
        else:
            # legacy sweep path: rows that moved are re-evaluated under the
            # executing region's CI (home [mobile, edge_net] at home)
            er = exec_region.long()
            ci_exec = torch.cat([ci_table[region, hour][:, :2],
                                 ci_table[er, hour][:, 2:]], dim=1)
            out_exec = carbon_model.route_many_envs(
                w, infra, Environment(ci=ci_exec, interference=interference,
                                      net_slowdown=net_slowdown), avail)
            moved = er != region
            if shed is not None:
                moved = moved & ~shed
            carbon = torch.where(moved, take_cols(out_exec.total_cf, targets),
                                 take_act(targets))
            feas = torch.where(moved, take_cols(out_exec.ok, targets),
                               take_cols(out.ok, targets))
            exec_region = er
        return dict(
            target=targets,
            carbon=carbon,
            feas=feas,
            exec_region=exec_region.to(torch.int32),
            shed=shed,
            exec_hour=exec_hour,
            defer=getattr(new_state, "defer_hours", None),
            ref_latency=take_act(out.target_latency),
            ref_energy=take_act(out.target_energy),
            ref_oracle=take_act(out.target),
        ), new_state

    def _fleet_route(self, w: Workload, avail, region, hour, ci_table, ci_fc,
                     state, order, inv_order, slack, cap_scale, used0
                     ) -> tuple[FleetRouteResult, object]:
        """``_route_rows`` and the stream's aggregates, on the device."""
        rows, new_state = self._route_rows(w, avail, region, hour, ci_table,
                                           ci_fc, state, order, inv_order,
                                           slack, cap_scale, used0)
        return self._aggregate(rows, region), new_state

    def _aggregate(self, rows: dict, region) -> FleetRouteResult:
        """The stream's ``FleetRouteResult`` from the per-row outputs of
        ``_route_rows`` (in stream order) and the (N,) arrival regions, on
        the device. The sharded route calls it on the gathered rows, so
        both paths sum the same rows in the same order."""
        n_regions = len(self.regions)
        targets, carbon, feas = rows["target"], rows["carbon"], rows["feas"]
        exec_region, shed = rows["exec_region"], rows["shed"]
        zero_i = torch.zeros((), dtype=torch.int32, device=self.device)
        moved = exec_region.long() != region
        if shed is not None:
            moved = moved & ~shed
        # (region, tier) counts: a histogram of the unshed rows' pairs
        pair = exec_region.long() * N_TARGETS + targets.long()
        if shed is not None:
            pair = pair[~shed]
        counts = torch.bincount(pair, minlength=n_regions * N_TARGETS).to(
            torch.int32).reshape(n_regions, N_TARGETS)
        defer = rows["defer"]
        if defer is None:
            deferred = zero_i
            mean_defer = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
        else:
            dmask = defer > 0
            if shed is not None:
                dmask = dmask & ~shed
            deferred = dmask.sum().to(torch.int32)
            mean_defer = ((defer * dmask).sum().to(torch.float32)
                          / torch.clamp_min(deferred, 1))
        return FleetRouteResult(
            target=targets,
            carbon_g=carbon,
            feasible=feas,
            counts=counts,
            total_carbon_g=carbon.sum(),
            routed_carbon_g=(carbon.sum() if shed is None
                             else (carbon * ~shed).sum()),
            latency_opt_carbon_g=rows["ref_latency"].sum(),
            energy_opt_carbon_g=rows["ref_energy"].sum(),
            oracle_carbon_g=rows["ref_oracle"].sum(),
            infeasible_count=(~feas).sum().to(torch.int32),
            shed_count=(zero_i if shed is None
                        else shed.sum().to(torch.int32)),
            exec_region=exec_region,
            spilled_count=moved.sum().to(torch.int32),
            deferred_count=deferred,
            mean_defer_hours=mean_defer,
        )

    def env_at(self, region: int, hour: int) -> Environment:
        """The Environment a request in ``region`` at absolute ``hour``
        sees (wrapped modulo the grid's horizon)."""
        return Environment(ci=self._ci_table[region, hour % self._horizon_h],
                           interference=self._interference,
                           net_slowdown=self._net_slowdown)

    def route_stream(self, batch: RequestBatch, region: np.ndarray,
                     t_hours: np.ndarray, *, mesh=None) -> FleetRouteResult:
        """Route a stream: ``region`` (N,) region indices, ``t_hours`` (N,)
        arrival times in absolute hours (wrapped modulo the horizon).
        ``mesh`` shards this call (overriding the router's own ``mesh``);
        the decisions are the same either way."""
        return self.route_stream_with_state(batch, region, t_hours,
                                            mesh=mesh)[0]

    def route_stream_with_state(self, batch: RequestBatch, region: np.ndarray,
                                t_hours: np.ndarray, *, mesh=None
                                ) -> tuple[FleetRouteResult, object]:
        """``route_stream`` + the policy's final state."""
        hour_np = (np.floor(np.asarray(t_hours))
                   % self._horizon_h).astype(np.int32)
        region_np = np.asarray(region).astype(np.int32)
        return self._route_arrays(batch, region_np, hour_np, mesh=mesh)

    def _stream_order(self, region_np: np.ndarray, hour_np: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray] | None:
        """The policy's admission-segment order of a stream: a stable host
        ``np.argsort`` by arrival window (or (window, home) for tier-only
        placement) and its inverse, or None for a policy without a
        ``stream_order_key``. The single-rank and the sharded routes both
        sort by it."""
        order_key = getattr(self.policy, "stream_order_key", None)
        if order_key is None:
            return None
        n_win = getattr(self.policy, "n_windows", None) or self._horizon_h
        win_np = hour_np % n_win
        key = (win_np * len(self.regions) + region_np
               if order_key == "window_region" else win_np)
        order_np = np.argsort(key, kind="stable")
        inv_np = np.empty_like(order_np)
        inv_np[order_np] = np.arange(len(order_np))
        return order_np, inv_np

    def _route_arrays(self, batch: RequestBatch, region_np: np.ndarray,
                      hour_np: np.ndarray, *, ci_fc=None, cap_scale=None,
                      used0=None, slack_np: np.ndarray | None = None,
                      mesh=None) -> tuple[FleetRouteResult, object]:
        """One ``_fleet_route`` call on prepared int32 arrays, with the
        re-planner's seams (``ci_fc``, ``cap_scale``, ``used0``,
        ``slack_np``). The stream-order hint is ``_stream_order``. With a
        mesh (``mesh=``, defaulting to the router's) a non-empty stream
        takes the sharded program of ``serve.distributed``, so every
        caller of this seam (``serve_stream``, the rolling re-planner)
        rides it."""
        mesh = self.mesh if mesh is None else mesh
        if mesh is not None and len(batch) > 0:
            from repro_torch.serve import distributed
            return distributed.route_arrays_sharded(
                self, batch, region_np, hour_np, mesh, ci_fc=ci_fc,
                cap_scale=cap_scale, used0=used0, slack_np=slack_np)
        dev = self.device
        sort = self._stream_order(region_np, hour_np)
        if sort is None:
            order = inv_order = None
        else:
            order = torch.as_tensor(sort[0], device=dev)
            inv_order = torch.as_tensor(sort[1], device=dev)
        region = torch.as_tensor(region_np, device=dev).long()
        hour = torch.as_tensor(hour_np, device=dev).long()
        slack = torch.as_tensor(batch.slack_h if slack_np is None
                                else np.asarray(slack_np, np.int32),
                                device=dev)
        state = self.policy.initial_state(len(self.regions), len(batch))
        return self._fleet_route(batch.workload(self.cfg, device=dev),
                                 batch.avail(device=dev), region, hour,
                                 self._ci_table,
                                 self._ci_fc if ci_fc is None else ci_fc,
                                 state, order, inv_order, slack, cap_scale,
                                 used0)

    def route_stream_rolling(self, batch: RequestBatch, region: np.ndarray,
                             t_hours: np.ndarray, *, step_h: int = 6,
                             ledger=None):
        """Rolling re-planned routing: plan the stream in ``step_h``-hour
        steps, holding deferred work in a carry-over queue re-scored each
        step as ``CarbonGrid.roll`` advances the forecast, with an optional
        ``EmissionsLedger``. Requires a ``TemporalPolicy``; returns a
        ``repro_torch.serve.forecast.RollingRouteResult``."""
        from repro_torch.serve import forecast
        return forecast.route_stream_rolling(self, batch, region, t_hours,
                                             step_h=step_h, ledger=ledger)

    def admit_windows(self, res: FleetRouteResult, t_hours: np.ndarray,
                      engine, n_windows: int = 24, *,
                      queue=None) -> list[np.ndarray]:
        """Per hourly window, the stream indices ``engine`` admits
        (``ServeEngine.admit`` over the routed targets, sliced by arrival
        hour). Deprecated, as in the reference. With ``queue=`` (a
        ``QueueServeResult`` of ``serve_stream``) it returns one index
        array per serve step instead (``serve.queue.admit_batches``;
        ``res`` and ``t_hours`` are ignored)."""
        if queue is not None:
            from repro_torch.serve.queue import admit_batches
            return admit_batches(queue, engine)
        _warn_admit_windows()
        hour = np.floor(np.asarray(t_hours)).astype(np.int64) % n_windows
        mask = engine.admit(res.target).cpu().numpy()
        return [np.nonzero(mask & (hour == h))[0] for h in range(n_windows)]
