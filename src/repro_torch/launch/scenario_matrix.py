"""Scenario matrix on the port:
``python -m repro_torch.launch.scenario_matrix [--device cuda] [--n 2000]
[--csv PATH]``.

The port's counterpart of the reference's ``benchmarks/scenario_matrix.py``
plus the mesoscale provisioning pin of ``benchmarks/policy_throughput.py``:

  * the results matrix, one ``MatrixCell`` per (scenario, policy) of
    ``serve.scenarios.default_scenarios()`` x ``default_policies()`` (21
    cells), each with the warm wall time of its route;
  * three gates that raise when they fail:
    ``curtailment_chase`` (on both curtailment scenarios deferral beats
    immediate routing on total gCO2, and deferred work lands inside the
    curtailed region's window), ``spike_aware`` (a provisioning plan sized
    on a forecast with the flash crowd re-injected sheds less of it than
    the spike-blind plan and is no dirtier than static over-provisioning
    at equal shed; an ``EmissionsLedger`` with that demand forecast
    conserves capacity before the spike) and ``watt_caps`` (admission per
    (window, region, tier) never exceeds the ``TierEnvelope`` watt caps,
    over three stream seeds and both capped policies);
  * the mesoscale provisioning pin on the 128-site sparse grid (20,000
    requests, as the README's table): the greedy plan at SLO 0 and 2%,
    static over-provisioning and the oracle (provisioned beats static on
    total carbon at no more shed; the SLO plan is no dirtier than the
    oracle), then ``serve_stream(plan=...)`` with the greedy plan driving
    the worker pool.

Every entry point takes ``device=`` (default ``"cuda"``) and raises on a
host without CUDA unless given ``"cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.carbon_intensity import DEFAULT_REGIONS, CarbonGrid
from repro_torch.core.infrastructure import pack_infra, paper_fleet, tpu_fleet
from repro_torch.device import resolve_device
from repro_torch.serve.forecast import EmissionsLedger
from repro_torch.serve.placement import PlacementPolicy
from repro_torch.serve.policy import OraclePolicy
from repro_torch.serve.provision import (
    ProvisioningPlan,
    demand_from_arrivals,
    oracle_plan,
    provision_greedy,
    realized_shed_rate,
    smoothed_demand_forecast,
    spike_demand_forecast,
    static_overprovision_plan,
)
from repro_torch.serve.queue import serve_stream
from repro_torch.serve.router import FleetRouter
from repro_torch.serve.scenarios import (
    ARCH,
    MatrixCell,
    _cell,
    caps_violation,
    default_policies,
    default_scenarios,
    matrix_csv,
    route_scenario,
    scenario_router,
)
from repro_torch.serve.streams import arrival_stream, multi_region_stream


def _gate(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def matrix_rows(n: int, *, device: str | torch.device = "cuda"
                ) -> list[tuple[MatrixCell, float]]:
    """Every (scenario, policy) cell at ``~n`` requests with the wall time
    in seconds of its route's second call on one router (the first warms
    up; building the stream is not timed)."""
    dev = resolve_device(device)
    out = []
    for sname, scenario in default_scenarios().items():
        run = scenario.build(n)
        for pname, factory in default_policies().items():
            fr = scenario_router(run, factory, device=dev)
            route = lambda: fr.route_stream(run.batch, run.region,
                                            run.t_hours)
            route()
            _sync(dev)
            t0 = time.perf_counter()
            res = route()
            _sync(dev)
            wall = time.perf_counter() - t0
            out.append((_cell(sname, pname, len(run.batch), res), wall))
    return out


def curtailment_gate(cells: list[MatrixCell], n: int, *,
                     device: str | torch.device = "cuda") -> dict:
    """Deferral must CHASE the curtailment window: beat immediate routing
    on total gCO2 on both curtailment scenarios, with deferred work
    landing inside the window in the curtailed region."""
    by = {(c.scenario, c.policy): c for c in cells}
    for sname in ("curtailment_midday", "curtailment_zero_ci"):
        defer = by[(sname, "temporal-defer")]
        imm = by[(sname, "oracle-immediate")]
        _gate(defer.total_g < imm.total_g,
              f"{sname}: deferral ({defer.total_g:.3f} g) must beat "
              f"immediate routing ({imm.total_g:.3f} g)")
    scenario = default_scenarios()["curtailment_midday"]
    ev = scenario.event
    _, state, _ = route_scenario(
        scenario, default_policies()["temporal-defer"], n=n, device=device)
    host = lambda t: t.cpu().numpy()
    deferred = (host(state.defer_hours) > 0) & ~host(state.shed)
    exec_hod = host(state.exec_hour) % 24
    in_window = ((host(state.exec_region) == ev.curtail_region)
                 & (exec_hod >= ev.curtail_window[0])
                 & (exec_hod < ev.curtail_window[1]))
    landed = int((deferred & in_window).sum())
    _gate(landed > 0, "no deferred work landed in the curtailment window")
    d = by[("curtailment_midday", "temporal-defer")]
    i = by[("curtailment_midday", "oracle-immediate")]
    return dict(defer_g=d.total_g, immediate_g=i.total_g,
                landed_in_window=landed)


def spike_aware_gate(n: int, *, device: str | torch.device = "cuda") -> dict:
    """Demand-forecast-aware provisioning must pre-stage the flash crowd:
    less realized shed than the spike-blind greedy plan, and no dirtier
    than blanket static over-provisioning at equal realized shed."""
    dev = resolve_device(device)
    n_regions, spike_at, spike_mult, spike_w = 4, 20.0, 10.0, 2.0
    _, region, t_hours = arrival_stream(
        max(n, 1) / 24.0, 24.0, n_regions, 0, spike_at_h=spike_at,
        spike_mult=spike_mult, spike_width_h=spike_w)
    actual = demand_from_arrivals(region, t_hours, 24, n_regions)
    blind_fc = smoothed_demand_forecast(actual)
    aware_fc = spike_demand_forecast(actual, spike_at_h=spike_at,
                                     spike_mult=spike_mult,
                                     spike_width_h=spike_w)
    grid = CarbonGrid.fully_connected(DEFAULT_REGIONS, device=dev)
    fleet = tpu_fleet()
    # fine-grained servers: at small demand a 64-slot server would mask
    # the spike behind integer sizing granularity
    slots = 8.0
    aware = provision_greedy(aware_fc, grid, fleet, name="spike-aware",
                             slots_per_server=slots)
    blind = provision_greedy(blind_fc, grid, fleet, name="spike-blind",
                             slots_per_server=slots)
    static = static_overprovision_plan(blind_fc, grid, fleet,
                                      headroom=spike_mult,
                                      slots_per_server=slots)
    shed_aware = realized_shed_rate(aware, actual)
    shed_blind = realized_shed_rate(blind, actual)
    shed_static = realized_shed_rate(static, actual)
    _gate(shed_aware < shed_blind,
          f"spike-aware plan must shed less of the crowd than the blind "
          f"plan ({shed_aware:.4f} vs {shed_blind:.4f})")
    # ~equal shed: static's blanket 10x headroom also absorbs off-spike
    # Poisson noise the aware plan does not forecast, so allow 1 pp
    _gate(shed_aware <= shed_static + 0.01,
          f"equal-shed comparison broken: aware {shed_aware:.4f} vs "
          f"static {shed_static:.4f}")
    _gate(aware.total_carbon_g <= static.total_carbon_g,
          f"spike-aware plan ({aware.total_carbon_g:.1f} g) must be no "
          f"dirtier than static over-provisioning "
          f"({static.total_carbon_g:.1f} g) at equal realized shed")
    # the ledger side of the same signal: with a demand forecast attached,
    # capacity is conserved in the step BEFORE the predicted spike
    led = EmissionsLedger(demand_fc=actual.sum(axis=(1, 2)))
    scale_pre, _, _, _ = led.cap_scales(np.full((n_regions, 24), 100.0), 12,
                                        6, np.zeros(n_regions))
    _gate(float(scale_pre.max()) < 1.0,
          "ledger must conserve capacity ahead of the predicted spike")
    return dict(aware_shed=shed_aware, blind_shed=shed_blind,
                static_shed=shed_static, aware_g=aware.total_carbon_g,
                static_g=static.total_carbon_g,
                ledger_prestage_scale=float(scale_pre.max()))


def watt_caps_gate(n: int, *, device: str | torch.device = "cuda",
                   seeds=(0, 1, 2)) -> dict:
    """Per-(window, region, tier) admission counts of the watt-shaped
    fleet never exceed the TierEnvelope-derived cap matrix, over several
    stream seeds and both capped policies."""
    base = default_scenarios()["hetero_fleet_watt"]
    policies = default_policies()
    worst = -np.inf
    for seed in seeds:
        scenario = dataclasses.replace(base, seed=seed)
        for pname in ("oracle-immediate", "temporal-defer"):
            res, state, run = route_scenario(scenario, policies[pname], n=n,
                                             device=device)
            v = caps_violation(res, state, run.t_hours, run.caps,
                               run.grid.horizon_h)
            worst = max(worst, v)
            _gate(v <= 0.0, f"watt caps exceeded by {v} (seed={seed}, "
                  f"policy={pname})")
    return dict(seeds=len(seeds), worst_excess=worst)


MESO_N = 20_000  # the README's mesoscale provisioning table


@dataclasses.dataclass
class MesoscalePlans:
    """The four provisioning plans of a multi-region stream on the
    128-site sparse grid, the stream, and a router under unit-capped
    placement (the pool's slots are the caps) to serve it with."""

    provisioned: ProvisioningPlan
    slo: ProvisioningPlan
    static: ProvisioningPlan
    oracle: ProvisioningPlan
    router: FleetRouter
    stream: tuple  # (RequestBatch, region, t_hours)


def mesoscale_plans(n: int, *, device: str | torch.device = "cuda"
                    ) -> MesoscalePlans:
    """The greedy plan at SLO 0 and 2%, static over-provisioning and the
    oracle for an ``n``-request ``multi_region_stream`` on the 128-site
    sparse grid (K = 8), paper fleet, 64 slots a server."""
    dev = resolve_device(device)
    r, k = 128, 8
    gs = CarbonGrid.from_sites(r, k, seed=0, device=dev)
    stream = multi_region_stream(n, r, seed=1)
    fleet = paper_fleet()
    demand = demand_from_arrivals(stream[1], stream[2], 24, r)
    fr = FleetRouter(get_config(ARCH), grid=gs, device=dev,
                     policy=PlacementPolicy(
                         OraclePolicy(pack_infra(tpu_fleet(), device=dev)),
                         np.ones((r, 3))))
    return MesoscalePlans(
        provisioned=provision_greedy(demand, gs, fleet),
        slo=provision_greedy(demand, gs, fleet, slo_shed=0.02,
                             name="slo_0.02"),
        static=static_overprovision_plan(demand, gs, fleet),
        oracle=oracle_plan(demand, gs, fleet), router=fr, stream=stream)


def mesoscale_pin(*, device: str | torch.device = "cuda") -> dict:
    """The README's pin: ``mesoscale_plans(MESO_N)`` and their gates
    (provisioned beats static on total carbon at no more shed; the 2% SLO
    plan is no dirtier than the oracle), then the greedy plan driving
    ``serve_stream``'s worker pool."""
    m = mesoscale_plans(MESO_N, device=device)
    prov, slo, stat, orac = m.provisioned, m.slo, m.static, m.oracle
    # demand-shaped provisioning beats static over-provisioning on total
    # (operational + amortized embodied) carbon at equal-or-lower shed
    _gate(prov.total_carbon_g < stat.total_carbon_g,
          f"provisioned plan ({prov.total_carbon_g:.6g} g) failed to beat "
          f"static over-provisioning ({stat.total_carbon_g:.6g} g)")
    _gate(prov.shed_rate <= stat.shed_rate + 1e-12,
          f"provisioned shed {prov.shed_rate:.4f} exceeds static "
          f"{stat.shed_rate:.4f}")
    _gate(slo.total_carbon_g <= orac.total_carbon_g,
          "the 2% SLO plan is dirtier than the oracle")
    t0 = time.perf_counter()
    res = serve_stream(m.router, *m.stream, plan=prov)
    return dict(n=MESO_N, plans=(prov, slo, stat, orac), serve=res,
                serve_wall_s=time.perf_counter() - t0)


@dataclasses.dataclass
class MatrixRun:
    """What one run of ``main`` produced."""

    cells: list[MatrixCell]
    walls_s: list[float]
    gates: dict[str, dict]
    mesoscale: dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2000,
                    help="requests per scenario (the flash crowd draws "
                         "about 2.4x as many)")
    ap.add_argument("--csv", default=None,
                    help="also write the matrix as CSV to this path")
    return ap.parse_args(argv)


def main(argv=None) -> MatrixRun:
    args = parse_args(argv)
    if args.n < 1:
        raise SystemExit("--n must be >= 1")
    dev = resolve_device(args.device)
    rows = matrix_rows(args.n, device=dev)
    cells = [c for c, _ in rows]
    print("name,seconds,derived")
    for c, wall in rows:
        print(f"scenario[{c.scenario}/{c.policy}],{wall:.6f},n={c.n} "
              f"total_g={c.total_g:.3f} routed_g={c.routed_g:.3f} "
              f"latency_opt_g={c.latency_opt_g:.3f} shed={c.shed_rate:.3f} "
              f"spill={c.spill_rate:.3f} defer={c.defer_rate:.3f} "
              f"mean_defer_h={c.mean_defer_h:.3f}")
    gates = {}
    for name, fn in (
            ("curtailment_chase",
             lambda: curtailment_gate(cells, args.n, device=dev)),
            ("spike_aware", lambda: spike_aware_gate(args.n, device=dev)),
            ("watt_caps",
             lambda: watt_caps_gate(min(args.n, 600), device=dev))):
        t0 = time.perf_counter()
        gates[name] = fn()
        derived = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in gates[name].items())
        print(f"scenario_gate_{name},{time.perf_counter() - t0:.6f},"
              f"{derived} PASS")
    meso = mesoscale_pin(device=dev)
    for plan in meso["plans"]:
        print(f"mesoscale_plan_{plan.name},0,server_h={plan.server_hours} "
              f"total_g={plan.total_carbon_g:.6g} "
              f"operational_g={plan.operational_g:.4g} "
              f"embodied_g={plan.embodied_g:.4g} "
              f"forecast_shed={plan.shed_rate:.4f}")
    res = meso["serve"]
    print(f"mesoscale_serve_provisioned,{meso['serve_wall_s']:.6f},"
          f"n={meso['n']} routed_g={res.routed_carbon_g:.4g} "
          f"standing_g={meso['plans'][0].total_carbon_g:.6g} "
          f"shed={res.shed_count} steps={len(res.steps)}")
    if args.csv is not None:
        with open(args.csv, "w") as f:
            f.write(matrix_csv(cells) + "\n")
    return MatrixRun(cells=cells, walls_s=[w for _, w in rows], gates=gates,
                     mesoscale=meso)


if __name__ == "__main__":
    main()
