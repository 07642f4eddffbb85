"""Joint capacity provisioning: how many servers, where, and when (port
of ``src/repro/serve/provision.py``).

The serving engines (``placement``/``temporal``/``queue``) decide where
REQUESTS go under a given capacity; this module decides the CAPACITY:
per-(site, tier, hour) server counts over a demand horizon. Every
provisioned server-hour carries

  * **amortized embodied carbon**: the tier's embodied CF (ACT or LCA)
    spread over its service lifetime x utilization
    (``embodied.amortized_g_per_hour``), and
  * **idle operational carbon**: the server's wall idle power (tier PUE
    folded in) at the hosting site's CI for that hour (the ACTIVE energy
    of admitted requests is charged to the requests by the routing
    settle path, so the plan carries only the standing cost).

``provision_greedy`` sizes the fleet against a demand forecast by marginal
carbon per shed-avoided: candidate server units are taken cheapest-first
(standing carbon per slot they absorb) until the SLO, a shed-rate ceiling,
is met. Baselines: ``static_overprovision_plan`` (peak x headroom,
constant) and ``oracle_plan`` (exact per-cell sizing, zero shed). A
``ProvisioningPlan`` drives ``WorkerPool`` launch/drain schedules
(``apply_to_pool``), whose live slot matrix is the admission ``cap_scale``
of ``serve_stream(plan=...)``.

Everything here is host numpy, as in the reference. The one tensor read
is the grid's DC-view CI, ``ci_hourly * pue``, formed in float32 on the
grid's device as the reference forms it and then brought to the host;
every later step runs in the reference's float64 order. A plan on the
card's grid is bit-identical to one on the CPU's, and to the reference's
wherever the two packages' grids hold the same CI.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.carbon_intensity import CarbonGrid
from repro_torch.core.constants import J_PER_KWH, N_TARGETS
from repro_torch.core.infrastructure import Fleet, server_carbon_rates


@dataclasses.dataclass(frozen=True)
class ProvisioningPlan:
    """Per-(hour, site, tier) server counts plus their carbon accounting.

    ``servers``     (H, R, 3) int64 — provisioned servers per cell; the
                    mobile tier is always 0 (user-owned hardware).
    ``demand``      (H, R, 3) float — the slot-demand forecast the plan was
                    sized against.
    ``cost_g``      (H, R, 3) float — standing gCO2 per server-hour in each
                    cell (amortized embodied + idle operational at that
                    site-hour's CI).
    ``emb_g_per_h`` (3,) float — the embodied share of ``cost_g`` per tier.
    """

    name: str
    servers: np.ndarray
    demand: np.ndarray
    cost_g: np.ndarray
    emb_g_per_h: np.ndarray
    slots_per_server: float

    @property
    def horizon_h(self) -> int:
        return self.servers.shape[0]

    @property
    def n_regions(self) -> int:
        return self.servers.shape[1]

    def served(self) -> np.ndarray:
        """(H, R, 3) forecast demand the plan can absorb per cell."""
        return np.minimum(self.demand,
                          self.servers * self.slots_per_server)

    @property
    def shed_rate(self) -> float:
        """Forecast-side shed fraction: demand the plan cannot serve."""
        total = float(self.demand.sum())
        if total <= 0:
            return 0.0
        return 1.0 - float(self.served().sum()) / total

    @property
    def server_hours(self) -> int:
        return int(self.servers.sum())

    @property
    def embodied_g(self) -> float:
        """Total amortized embodied carbon of every provisioned server-hour."""
        return float((self.servers
                      * self.emb_g_per_h[None, None, :]).sum())

    @property
    def operational_g(self) -> float:
        """Total idle operational carbon (standing energy at site CI)."""
        return float((self.servers
                      * (self.cost_g
                         - self.emb_g_per_h[None, None, :])).sum())

    @property
    def total_carbon_g(self) -> float:
        """Standing total: operational (idle) + amortized embodied."""
        return float((self.servers * self.cost_g).sum())

    def cap_scale(self, hour: int) -> np.ndarray:
        """(R, 3) float32 admission slots at ``hour`` — the serve loop's
        ``cap_scale`` seam (mobile unbounded, repo-wide convention)."""
        h = int(np.clip(hour, 0, self.horizon_h - 1))
        m = (self.servers[h] * self.slots_per_server).astype(np.float32)
        m[:, 0] = np.inf
        return m

    def apply_to_pool(self, pool, hour: int) -> None:
        """Launch/drain ``pool`` toward this plan's ``hour`` server counts.

        Pending (LAUNCHING) workers count toward the target, so repeated
        application is idempotent; shrinking drains ACTIVE workers (they
        leave ``cap_matrix`` immediately — retire them with
        ``terminate_drained``)."""
        h = int(np.clip(hour, 0, self.horizon_h - 1))
        target = self.servers[h]
        current = pool.active + pool.launching
        for r in range(self.n_regions):
            for t in range(1, N_TARGETS):  # mobile is never pooled
                delta = int(target[r, t] - current[r, t])
                if delta > 0:
                    pool.launch(r, t, delta)
                elif delta < 0:
                    pool.drain(r, t, -delta)


def standing_cost_g(grid: CarbonGrid, fleet: Fleet, *,
                    utilization: float = 1.0,
                    embodied_model: str = "act",
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(cost_g (H, R, 3), emb_g_per_h (3,)) — standing gCO2 per
    server-hour in every (hour, site, tier) cell: amortized embodied plus
    idle power at the site-hour's DC-view CI (``ci_hourly x pue``, the
    same view the routing tables charge DC components at). The mobile
    column is zero — user-owned hardware is never provisioned."""
    emb, idle_w = server_carbon_rates(fleet, embodied_model,
                                      utilization=utilization)
    ci_dc = (grid.ci_hourly * grid.pue).cpu().numpy().T  # (H, R) float32
    cost = (emb[None, None, :]
            + idle_w[None, None, :] * 3600.0 / J_PER_KWH
            * ci_dc[:, :, None])
    cost[:, :, 0] = 0.0
    emb = emb.copy()
    emb[0] = 0.0
    return cost, emb


def _check_demand(demand: np.ndarray, grid: CarbonGrid) -> np.ndarray:
    demand = np.asarray(demand, np.float64).copy()
    h = grid.horizon_h
    if demand.shape != (h, grid.n_regions, N_TARGETS):
        raise ValueError(
            f"demand must be (H={h}, R={grid.n_regions}, {N_TARGETS}), "
            f"got {demand.shape}")
    if (demand < 0).any():
        raise ValueError("demand must be non-negative")
    demand[:, :, 0] = 0.0  # mobile serves on the requester's own device
    return demand


def provision_greedy(demand: np.ndarray, grid: CarbonGrid, fleet: Fleet, *,
                     slo_shed: float = 0.0,
                     slots_per_server: float = 64.0,
                     utilization: float = 1.0,
                     embodied_model: str = "act",
                     name: str = "provisioned") -> ProvisioningPlan:
    """Size the fleet by marginal carbon per shed-avoided (exact greedy).

    Candidate units are single servers in a (site, tier, hour) cell; a
    cell's first ``floor(demand/slots)`` servers each absorb a full
    ``slots_per_server`` of demand, one final server absorbs the
    remainder. Units are taken cheapest-first by standing-carbon per
    absorbed slot until at least ``(1 - slo_shed)`` of total forecast
    demand is served — with ``slo_shed = 0`` this degenerates to the
    perfect-hindsight exact sizing (``oracle_plan``)."""
    if not 0.0 <= slo_shed < 1.0:
        raise ValueError(f"slo_shed must be in [0, 1), got {slo_shed}")
    if slots_per_server <= 0:
        raise ValueError("slots_per_server must be positive")
    demand = _check_demand(demand, grid)
    cost, emb = standing_cost_g(grid, fleet, utilization=utilization,
                                embodied_model=embodied_model)
    s = float(slots_per_server)
    flat_cost = cost.reshape(-1)
    flat_d = demand.reshape(-1)
    n_full = np.floor(flat_d / s).astype(np.int64)
    rem = flat_d - n_full * s
    cells = np.arange(flat_d.size)

    f = n_full > 0
    p = rem > 1e-9
    e_cell = np.concatenate([cells[f], cells[p]])
    e_cap = np.concatenate([np.full(int(f.sum()), s), rem[p]])
    e_n = np.concatenate([n_full[f], np.ones(int(p.sum()), np.int64)])
    e_ratio = np.concatenate([flat_cost[f] / s, flat_cost[p] / rem[p]])

    servers_flat = np.zeros(flat_d.size, np.int64)
    target = (1.0 - slo_shed) * float(flat_d.sum())
    if target > 0 and e_cell.size:
        order = np.argsort(e_ratio, kind="stable")
        e_cell, e_cap, e_n = e_cell[order], e_cap[order], e_n[order]
        cum = np.cumsum(e_n * e_cap)
        k = int(np.searchsorted(cum, target - 1e-9))
        take = np.zeros_like(e_n)
        if k >= len(cum):
            take[:] = e_n
        else:
            take[:k] = e_n[:k]
            prev = float(cum[k - 1]) if k else 0.0
            take[k] = min(int(np.ceil((target - prev) / e_cap[k])),
                          int(e_n[k]))
        np.add.at(servers_flat, e_cell, take)
    return ProvisioningPlan(
        name=name, servers=servers_flat.reshape(demand.shape),
        demand=demand, cost_g=cost, emb_g_per_h=emb,
        slots_per_server=s)


def oracle_plan(demand: np.ndarray, grid: CarbonGrid, fleet: Fleet, *,
                slots_per_server: float = 64.0,
                utilization: float = 1.0,
                embodied_model: str = "act") -> ProvisioningPlan:
    """Perfect-hindsight exact sizing: ``ceil(demand / slots)`` per cell —
    the zero-shed standing-carbon lower bound among per-cell plans."""
    demand = _check_demand(demand, grid)
    cost, emb = standing_cost_g(grid, fleet, utilization=utilization,
                                embodied_model=embodied_model)
    s = float(slots_per_server)
    servers = np.ceil(demand / s).astype(np.int64)
    return ProvisioningPlan(name="oracle", servers=servers, demand=demand,
                            cost_g=cost, emb_g_per_h=emb,
                            slots_per_server=s)


def static_overprovision_plan(demand: np.ndarray, grid: CarbonGrid,
                              fleet: Fleet, *, headroom: float = 1.3,
                              slots_per_server: float = 64.0,
                              utilization: float = 1.0,
                              embodied_model: str = "act",
                              ) -> ProvisioningPlan:
    """The carbon-unaware baseline: a constant fleet sized to
    ``peak demand x headroom`` per (site, tier) — what a latency-only
    operator deploys, paying peak-rate standing carbon around the clock."""
    if headroom < 1.0:
        raise ValueError(f"headroom must be >= 1, got {headroom}")
    demand = _check_demand(demand, grid)
    cost, emb = standing_cost_g(grid, fleet, utilization=utilization,
                                embodied_model=embodied_model)
    s = float(slots_per_server)
    peak = demand.max(axis=0)  # (R, 3)
    per_rt = np.ceil(peak * headroom / s).astype(np.int64)
    servers = np.broadcast_to(per_rt, demand.shape).copy()
    return ProvisioningPlan(name="static-overprovision", servers=servers,
                            demand=demand, cost_g=cost, emb_g_per_h=emb,
                            slots_per_server=s)


def smoothed_demand_forecast(demand: np.ndarray, *,
                             window_h: int = 5) -> np.ndarray:
    """Spike-BLIND demand forecast: a centered ``window_h``-hour moving
    average (clipped at the horizon edges) of an (H, R, 3) slot-demand
    history along the hour axis, in requests/hour. A flash crowd much
    narrower than ``window_h`` is averaged away — exactly the forecast a
    naive capacity planner runs on, and the baseline the spike-aware
    provisioning gate beats. ``window_h = 1`` is the identity."""
    d = np.asarray(demand, np.float64)
    if window_h < 1:
        raise ValueError(f"window_h must be >= 1, got {window_h}")
    h = d.shape[0]
    half = window_h // 2
    out = np.empty_like(d)
    for t in range(h):
        lo, hi = max(0, t - half), min(h, t + half + 1)
        out[t] = d[lo:hi].mean(axis=0)
    return out


def spike_demand_forecast(demand: np.ndarray, *, spike_at_h: float,
                          spike_mult: float, spike_width_h: float = 1.0,
                          window_h: int = 5) -> np.ndarray:
    """Spike-AWARE demand forecast: the smoothed (spike-blind) baseline
    with a PREDICTED flash crowd re-injected — hour buckets overlapping
    the ``spike_width_h``-wide window centred at ``spike_at_h`` are
    multiplied by ``spike_mult`` (an announced product launch / scheduled
    event, the 'spike expected' signal). Feeding this to
    ``provision_greedy`` pre-stages capacity in exactly the spike cells,
    so admission does not shed the crowd a blind plan never saw — and
    nowhere else, so the plan stays cheaper than blanket over-provisioning
    (``static_overprovision_plan``) at equal realized shed. Units:
    requests/hour, matching ``demand_from_arrivals``."""
    if spike_mult < 1.0:
        raise ValueError(f"spike_mult must be >= 1, got {spike_mult}")
    base = smoothed_demand_forecast(demand, window_h=window_h)
    centers = np.arange(base.shape[0], dtype=np.float64) + 0.5
    in_spike = np.abs(centers - spike_at_h) < 0.5 * (spike_width_h + 1.0)
    out = base.copy()
    out[in_spike] *= spike_mult
    return out


def realized_shed_rate(plan: ProvisioningPlan,
                       actual_demand: np.ndarray) -> float:
    """Out-of-sample shed fraction: the share of ACTUAL demand (slots,
    (H, R, 3)) the plan's provisioned capacity cannot absorb. A plan is
    sized against a FORECAST; this scores it against what actually
    arrived — ``min(actual, servers x slots_per_server)`` serves per
    cell, the excess sheds. The mobile column is ignored (user-owned
    hardware, never provisioned). 0.0 on zero demand."""
    actual = np.asarray(actual_demand, np.float64).copy()
    if actual.shape != plan.servers.shape:
        raise ValueError(
            f"actual_demand must be {plan.servers.shape}, got {actual.shape}")
    actual[:, :, 0] = 0.0
    total = float(actual.sum())
    if total <= 0:
        return 0.0
    cap = plan.servers * plan.slots_per_server
    return 1.0 - float(np.minimum(actual, cap).sum()) / total


def demand_from_arrivals(region: np.ndarray, t_hours: np.ndarray,
                         horizon_h: int, n_regions: int, *,
                         tier_split=(0.0, 0.6, 0.6)) -> np.ndarray:
    """(H, R, 3) slot-demand forecast from an arrival stream: per-(hour,
    site) arrival counts split across tiers. ``tier_split`` deliberately
    over-completes (sums past 1.0 by default) — the router chooses tiers
    per request, so the forecast must cover either DC tier absorbing the
    hour's load; the greedy sizing then prices that flexibility instead of
    assuming it free."""
    hour = np.floor(np.asarray(t_hours, np.float64)).astype(np.int64)
    region = np.asarray(region, np.int64)
    if hour.size and (hour.min() < 0 or hour.max() >= horizon_h):
        raise ValueError("t_hours outside the forecast horizon")
    counts = np.zeros((horizon_h, n_regions), np.float64)
    np.add.at(counts, (hour, region), 1.0)
    split = np.asarray(tier_split, np.float64)
    if split.shape != (N_TARGETS,):
        raise ValueError(f"tier_split must have {N_TARGETS} entries")
    return counts[:, :, None] * split[None, None, :]
