"""The ten-act serving tour on the port:
``python -m repro_torch.launch.tour [--requests 1000000] [--learned]
[--device cuda] [--no-smoke]``.

The port's counterpart of the reference's ``examples/serving_router.py``,
act for act, with the same printed lines so the two outputs can be read
side by side:

  1. per-hour tier shifts of three request classes (``GreenScaleRouter``);
  2. a diurnal stream routed across the fleet in one call (``FleetRouter``):
     per-region/per-tier counts, gCO2 saved vs the latency- and
     energy-optimal baselines;
  3. a tier-pinned engine admits its slice window by window and generates
     a batch (the LM engine: the smoke config, or with ``--no-smoke`` the
     full ``--arch`` in float32 through the port's CUDA kernels);
  4. policies head-to-head: carbon / latency / energy oracles and the
     capacity-capped oracle (``--learned`` adds a regression scheduler);
  5. tier-only vs cross-region spill under binding DC caps;
  6. temporal deferral of a deadline-tagged stream (``TemporalPolicy``)
     with per-hour arrived-vs-executed histograms;
  7. a two-day horizon whose second day is cleaner (``--learned`` adds a
     classification scheduler on the same engine);
  8. forecast-native scheduling: one-shot error-blind deferral vs the
     rolling risk-aware re-planner with an ``EmissionsLedger``;
  9. continuous batching (``serve_stream`` through a ``WorkerPool``, the
     engine admitting per serve step) and the online refit
     (``OnlineRefitter``) between a static learned policy and the oracle;
 10. the scenario matrix on three scenarios (``serve.scenarios``).

The router always costs the full ``--arch`` config, as in the reference.
Prompt tokens (and, with ``--no-smoke``, the weights) come from a
``torch.Generator`` seeded by ``--seed``. ``main`` returns a ``TourResult``
holding each act's headline numbers.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    ChargingBehavior,
    Grid,
    grid_trace,
    mobile_carbon_intensity,
)
from repro_torch.core.carbon_model import Environment
from repro_torch.core.constants import Target
from repro_torch.device import resolve_device
from repro_torch.models import Transformer
from repro_torch.serve import (
    CapacityLimiter,
    CarbonGrid,
    EmissionsLedger,
    FleetRouter,
    GreenScaleRouter,
    LearnedPolicy,
    OnlineRefitter,
    OraclePolicy,
    PlacementPolicy,
    Request,
    ServeEngine,
    TemporalPolicy,
    WorkerPool,
    admit_batches,
    serve_stream,
)
from repro_torch.serve.streams import (
    arrival_stream,
    deferrable_stream,
    deferrable_stream_multiday,
    diurnal_stream,
    forecast_scenario,
    multi_region_stream,
)

TARGETS = ("on-device", "edge-DC", "cloud")


@dataclasses.dataclass
class TourResult:
    """Each act's headline numbers (``acts[k]`` for act k), the request
    count and the device the tour ran on."""

    requests: int
    device: str
    acts: dict[int, dict]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=1_000_000)
    ap.add_argument("--learned", action="store_true",
                    help="also fit a regression scheduler offline and route "
                         "the stream with it (act 4), and a classification "
                         "scheduler on the two-day engine (act 7)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="engine of acts 3 and 9 on the smoke config "
                         "(default) or the full --arch in float32")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _paper_train():
    """The offline training split of the paper's design space at hours
    0, 4, ..., 20 (built and fitted on the host)."""
    from repro_torch.core import (
        ALL_PAPER_WORKLOADS,
        ScenarioAxes,
        build_scenarios,
        explore,
        paper_fleet,
    )
    from repro_torch.core.schedulers import build_dataset

    table = build_scenarios(paper_fleet(),
                            ScenarioAxes(hours=tuple(range(0, 24, 4))),
                            device="cpu")
    return build_dataset(ALL_PAPER_WORKLOADS,
                         explore(ALL_PAPER_WORKLOADS, table), table).split()[0]


def main(argv=None) -> TourResult:
    args = parse_args(argv)
    if args.requests < 1:
        raise SystemExit("--requests must be >= 1")
    dev = resolve_device(args.device)
    acts: dict[int, dict] = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def warm(fn):
        """(result, wall of the second call) — the first call warms up."""
        fn()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    # --- engine on --smoke or the full config, router on the full config ----
    eng_cfg = get_config(args.arch, smoke=args.smoke)
    full = get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = Transformer(eng_cfg, device=dev, dtype=torch.float32,
                        generator=gen)
    engine = ServeEngine(eng_cfg, model, max_seq=64,
                         tier=int(Target.EDGE_DC), device=dev)
    router = GreenScaleRouter(full, device=dev)

    # --- act 1: per-hour tier shifts on three request classes ---------------
    ciso = grid_trace(Grid.CISO, device=dev)
    rural = grid_trace(Grid.RURAL, device=dev)
    ci_mob = float(mobile_carbon_intensity(ChargingBehavior.AVERAGE, ciso))
    requests = [
        Request(prompt_tokens=64, max_new_tokens=32, latency_budget_s=1.0),
        Request(prompt_tokens=2048, max_new_tokens=512,
                latency_budget_s=20.0),
        Request(prompt_tokens=16384, max_new_tokens=64,
                latency_budget_s=30.0),
    ]
    print(f"routing {len(requests)} request classes over 24h "
          f"({full.name}, {full.active_param_count() / 1e9:.1f}B active):")
    day = collections.defaultdict(list)
    ciso_mean = float(ciso.ci_mean)
    for hour in range(24):
        env = Environment.make(
            ci_mob, float(rural.ci_hourly[hour]), ciso_mean,
            float(ciso.ci_hourly[hour]), device=dev)
        for ri, d in enumerate(router.route_batch(requests, env)):
            day[ri].append(d.target)
    acts[1] = {}
    for ri, req in enumerate(requests):
        hist = {TARGETS[t]: day[ri].count(t) for t in range(3)}
        acts[1][ri] = hist
        print(f"  class {ri} ({req.prompt_tokens}p/{req.max_new_tokens}g): "
              f"{hist}")

    # --- act 2: the synthetic diurnal trace across the fleet ----------------
    fleet = FleetRouter(full, device=dev)
    n = args.requests
    R = len(fleet.regions)
    batch, region, t_hours = diurnal_stream(n, R, seed=0)
    res, dt = warm(lambda: fleet.route_stream(batch, region, t_hours))
    print(f"\nfleet-routed {n:,} requests across {R} regions "
          f"in {dt:.3f}s ({n / dt / 1e6:.2f}M req/s):")
    counts = res.counts.cpu().numpy()
    for ri, spec in enumerate(fleet.regions):
        row = {TARGETS[t]: int(counts[ri, t]) for t in range(3)}
        print(f"  {spec.name:6s}: {row}")
    print(f"  carbon: {float(res.total_carbon_g):.4g} gCO2 routed | "
          f"saves {float(res.saved_vs_latency_g):.4g} g vs latency-optimal, "
          f"{float(res.saved_vs_energy_g):.4g} g vs energy-optimal")
    acts[2] = dict(total_carbon_g=float(res.total_carbon_g),
                   latency_opt_carbon_g=float(res.latency_opt_carbon_g),
                   energy_opt_carbon_g=float(res.energy_opt_carbon_g),
                   saved_vs_latency_g=float(res.saved_vs_latency_g),
                   saved_vs_energy_g=float(res.saved_vs_energy_g),
                   counts=counts, wall_s=dt)

    # --- act 3: tier-pinned engine admits its slice, window by window -------
    admitted = engine.admit_indices(res.target)
    windows = fleet.admit_windows(res, t_hours, engine)
    peak = max(range(24), key=lambda h: len(windows[h]))
    print(f"\nedge-DC engine admits {len(admitted):,}/{n:,} requests "
          f"({len(admitted) / n:.1%}); busiest window {peak}:00 with "
          f"{len(windows[peak]):,} requests")
    toks = torch.randint(0, eng_cfg.vocab_size, (args.batch, 16),
                         generator=gen, device=dev)
    t0 = time.perf_counter()
    out = engine.generate(toks, max_new_tokens=8)
    sync()
    gen_s = time.perf_counter() - t0
    print(f"engine generated {out.shape[1]} tokens for a batch of "
          f"{out.shape[0]} admitted requests: {out[0].tolist()}")
    acts[3] = dict(admitted=len(admitted), busiest_window=peak,
                   busiest_count=len(windows[peak]),
                   engine=eng_cfg.name, tokens=out.cpu().numpy(),
                   generate_s=gen_s)

    # --- act 4: pluggable policies head-to-head on the same stream ----------
    infra = fleet.infra
    caps = np.full((R, 3), np.inf)
    caps[:, 2] = 0.8 * n / (R * 24)  # bind the cloud tier
    policies = [
        ("oracle-carbon", None),
        ("oracle-latency", OraclePolicy(infra, metric="latency")),
        ("oracle-energy", OraclePolicy(infra, metric="energy")),
        ("capped-oracle", CapacityLimiter(OraclePolicy(infra), caps)),
    ]
    if args.learned:
        from repro_torch.core.schedulers import RegressionScheduler

        train = _paper_train()
        policies.append(("learned-regression",
                         LearnedPolicy.fit(RegressionScheduler(), train,
                                           device=dev)))
    print(f"\npolicy head-to-head on the same {n:,}-request stream:")
    acts[4] = {}
    for name, policy in policies:
        fr = fleet if policy is None else FleetRouter(full, policy=policy,
                                                      device=dev)
        r, dt = warm(lambda: fr.route_stream(batch, region, t_hours))
        print(f"  {name:20s}: {n / dt / 1e6:5.2f}M req/s  "
              f"carbon {float(r.total_carbon_g):9.4g} g  "
              f"(+{float(r.extra_vs_oracle_g):.3g} vs oracle)  "
              f"qos {float(r.qos_violation_rate):.2%}  "
              f"shed {int(r.shed_count):,}")
        acts[4][name] = dict(total_carbon_g=float(r.total_carbon_g),
                             extra_vs_oracle_g=float(r.extra_vs_oracle_g),
                             qos_violation_rate=float(r.qos_violation_rate),
                             shed=int(r.shed_count), wall_s=dt)

    # --- act 5: geo-temporal placement, tier-only vs cross-region spill -----
    mbatch, mregion, mt_hours = multi_region_stream(n, R, seed=0)
    caps = np.full((R, 3), np.inf)
    caps[:, 1] = caps[:, 2] = max(1.0, 0.25 * n / (R * 24))
    xgrid = CarbonGrid.fully_connected(fleet.regions, latency_penalty=1.05,
                                       device=dev)
    placements = [
        ("tier-only spill", FleetRouter(full, device=dev,
                                        policy=PlacementPolicy(
                                            OraclePolicy(infra), caps))),
        ("cross-region spill", FleetRouter(full, grid=xgrid, device=dev,
                                           policy=PlacementPolicy(
                                               OraclePolicy(infra), caps))),
    ]
    print(f"\ngeo-temporal placement on a {n:,}-request multi-region stream "
          f"(staggered peaks, capped DC tiers):")
    acts[5] = {}
    for name, fr in placements:
        r, dt = warm(lambda: fr.route_stream(mbatch, mregion, mt_hours))
        print(f"  {name:18s}: {n / dt / 1e6:5.2f}M req/s  "
              f"carbon {float(r.total_carbon_g):9.4g} g  "
              f"shed {int(r.shed_count):,}  "
              f"spilled cross-region {int(r.spilled_count):,} "
              f"({float(r.spill_rate):.1%})")
        acts[5][name] = dict(total_carbon_g=float(r.total_carbon_g),
                             shed=int(r.shed_count),
                             spilled=int(r.spilled_count), wall_s=dt)

    # --- act 6: temporal deferral, riding the solar dip within deadlines ----
    dn = min(n, 200_000)  # candidate scores are (N, slack+1, R, 3)
    dbatch, dregion, dt_hours = deferrable_stream(dn, R, seed=0)
    caps = np.full((R, 3), np.inf)
    caps[:, 1] = caps[:, 2] = max(1.0, 0.6 * dn / (R * 24))
    space_only = FleetRouter(full, grid=xgrid, device=dev,
                             policy=PlacementPolicy(OraclePolicy(infra),
                                                    caps))
    joint = FleetRouter(full, grid=xgrid, device=dev, policy=TemporalPolicy(
        OraclePolicy(infra), caps, max_defer_h=12))
    rs = space_only.route_stream(dbatch, dregion, dt_hours)
    rj, sj = joint.route_stream_with_state(dbatch, dregion, dt_hours)
    print(f"\ntemporal deferral on a {dn:,}-request deadline-tagged stream "
          f"({float(np.mean(dbatch.slack_h > 0)):.0%} batch-class, slack up "
          f"to {int(dbatch.slack_h.max())}h):")
    acts[6] = {}
    for name, r in (("space-only (placement)", rs),
                    ("joint (region,tier,hour)", rj)):
        print(f"  {name:24s}: carbon {float(r.routed_carbon_g):9.4g} g  "
              f"shed {int(r.shed_count):,}  "
              f"deferred {int(r.deferred_count):,} "
              f"(mean {float(r.mean_defer_hours):.1f}h)")
        acts[6][name] = dict(routed_carbon_g=float(r.routed_carbon_g),
                             shed=int(r.shed_count),
                             deferred=int(r.deferred_count),
                             mean_defer_h=float(r.mean_defer_hours))
    sj_defer = sj.defer_hours.cpu().numpy()
    sj_shed = sj.shed.cpu().numpy()
    violations = int((sj_defer > dbatch.slack_h).sum())
    cut = 1 - float(rj.routed_carbon_g) / float(rs.routed_carbon_g)
    print(f"  joint deferral cuts routed gCO2 by {cut:.1%} "
          f"with {violations} deadline violations")
    acts[6]["deadline_violations"] = violations
    arrived = np.bincount(np.floor(dt_hours).astype(int) % 24, minlength=24)
    # shed requests execute nowhere: keep them out of the executed bars
    executed = np.bincount(sj.exec_hour.cpu().numpy()[~sj_shed],
                           minlength=24)
    peak = max(int(arrived.max()), int(executed.max()))
    print("  hour | arrived | executed   (joint policy, # = load)")
    for h in range(24):
        bars = (int(round(arrived[h] / peak * 30)),
                int(round(executed[h] / peak * 30)))
        print(f"  {h:4d} | {'#' * bars[0]:30s} | {'#' * bars[1]:30s}")

    # --- act 7: multi-day horizon, deferring across midnight into day two ---
    # the horizon tail does not wrap: windows past hour 47 are refused
    grid2 = CarbonGrid.fully_connected(
        fleet.regions, latency_penalty=1.05, n_days=2,
        device="cpu").scaled_days((1.0, 0.85)).to(dev)
    mbatch2, mregion2, mt2 = deferrable_stream_multiday(dn, R, n_days=2,
                                                        seed=0)
    joint2 = FleetRouter(full, grid=grid2, device=dev, policy=TemporalPolicy(
        OraclePolicy(infra), caps, max_defer_h=16))
    r2, s2 = joint2.route_stream_with_state(mbatch2, mregion2, mt2)
    arr_abs = np.floor(mt2).astype(int) % grid2.horizon_h
    eh2 = s2.exec_hour.cpu().numpy()
    crossed = int(((arr_abs < 24) & (eh2 >= 24)
                   & ~s2.shed.cpu().numpy()).sum())
    print("\nmulti-day horizon: the same engine on a rolling 2-day grid "
          "(day two 15% cleaner):")
    print(f"  routed carbon {float(r2.routed_carbon_g):9.4g} g  "
          f"shed {int(r2.shed_count):,}  "
          f"deferred {int(r2.deferred_count):,} "
          f"(mean {float(r2.mean_defer_hours):.1f}h)")
    print(f"  {crossed:,} requests crossed midnight into day-two capacity "
          f"cells (no modulo-24 aliasing)")
    acts[7] = dict(routed_carbon_g=float(r2.routed_carbon_g),
                   shed=int(r2.shed_count), deferred=int(r2.deferred_count),
                   crossed_midnight=crossed)
    if args.learned:
        from repro_torch.core.schedulers import ClassificationScheduler

        learned2 = FleetRouter(full, grid=grid2, device=dev,
                               policy=TemporalPolicy(
                                   LearnedPolicy.fit(
                                       ClassificationScheduler(), train,
                                       device=dev),
                                   caps, max_defer_h=16))
        rl2 = learned2.route_stream(mbatch2, mregion2, mt2)
        print(f"  learned (classification) on the same factorized engine: "
              f"carbon {float(rl2.routed_carbon_g):9.4g} g  "
              f"deferred {int(rl2.deferred_count):,}")
        acts[7]["learned_routed_carbon_g"] = float(rl2.routed_carbon_g)

    # --- act 8: forecast-native scheduling, plan on forecasts, settle on
    # actuals ----------------------------------------------------------------
    fn = min(n, 20_000)  # the rolling planner re-plans per 6h step
    fbatch, fregion, ft_hours, fgrid = forecast_scenario(
        fn, fleet.regions, sigma_h=0.06, seed=0, device=dev)
    fcaps = np.full((R, 3), np.inf)
    blind = FleetRouter(full, grid=fgrid, device=dev, policy=TemporalPolicy(
        OraclePolicy(infra), fcaps, max_defer_h=12))
    aware = FleetRouter(full, grid=fgrid, device=dev, policy=TemporalPolicy(
        OraclePolicy(infra), fcaps, max_defer_h=12, risk_lambda=1.0))
    one = blind.route_stream(fbatch, fregion, ft_hours)
    roll = aware.route_stream_rolling(fbatch, fregion, ft_hours, step_h=6,
                                      ledger=EmissionsLedger())
    print(f"\nforecast-native scheduling ({fn:,} requests, CI forecast "
          f"error ~6%/sqrt(h) ahead; carbon charged at ACTUALS):")
    print(f"  one-shot, error-blind   : carbon "
          f"{float(one.routed_carbon_g):9.4g} g  "
          f"shed {int(one.shed_count):,}")
    print(f"  rolling, risk-aware     : carbon "
          f"{roll.routed_carbon_g:9.4g} g  "
          f"shed {roll.shed_count:,}  (re-planned every 6h as the "
          f"forecast rolled)")
    print(f"  forecast-native re-planning cuts routed gCO2 by "
          f"{1 - roll.routed_carbon_g / float(one.routed_carbon_g):.1%}")
    earned = np.sum([s.earned for s in roll.steps], axis=0)
    spent = np.sum([s.spent for s in roll.steps], axis=0)
    print(f"  emissions ledger: credit earned {earned.sum():.1f}h, "
          f"spent {spent.sum():.1f}h across {R} regions (spent <= earned "
          f"per region: {bool((spent <= earned + 1e-9).all())})")
    acts[8] = dict(one_shot_routed_g=float(one.routed_carbon_g),
                   rolling_routed_g=float(roll.routed_carbon_g),
                   rolling_shed=int(roll.shed_count),
                   earned_h=float(earned.sum()), spent_h=float(spent.sum()))

    # --- act 9: continuous batching + online refit --------------------------
    # Poisson arrivals with an evening flash crowd, EDF-ordered drafts, live
    # worker slots gating admission, the engine admitting per serve step;
    # then the policy learns from what it routed
    qbatch, qregion, qt = arrival_stream(
        max(200.0, min(n, 100_000) / 24.0), n_regions=R, seed=0,
        batch_frac=0.3, spike_at_h=19.0, spike_mult=3.0)
    pool = WorkerPool(R, slots_per_worker=max(64.0, len(qbatch) / (R * 12)),
                      launch_delay_steps=1)
    for r in range(R):
        for tier in (1, 2):
            pool.launch(r, tier, n=2)
    qfr = FleetRouter(full, grid=xgrid, device=dev, policy=PlacementPolicy(
        OraclePolicy(infra), np.ones((R, 3))))  # pool slots ARE the caps
    t0 = time.perf_counter()
    qres = serve_stream(qfr, qbatch, qregion, qt, pool=pool)
    qdt = time.perf_counter() - t0
    spike = [s for s in qres.steps if s.now == 19][0]
    n_batches = sum(s.n_batches for s in qres.steps)
    print(f"\ncontinuous batching: {len(qbatch):,} Poisson arrivals "
          f"(flash crowd at 19:00) served in {len(qres.steps)} steps, "
          f"{n_batches} drafted batches, "
          f"{qdt:.2f}s ({len(qbatch) / qdt / 1e3:.0f}k req/s):")
    print(f"  flash-crowd step 19:00 drafted {spike.drafted:,} "
          f"(vs {np.mean([s.drafted for s in qres.steps]):.0f} mean), "
          f"shed {qres.shed_count:,} total under live worker slots")
    step_windows = admit_batches(qres, engine)
    busiest = max(range(len(step_windows)),
                  key=lambda i: len(step_windows[i]))
    print(f"  edge-DC engine admits per serve step; busiest step drains "
          f"{len(step_windows[busiest]):,} requests")

    # the learning loop: static offline fit vs hot-swapped online refit
    from repro_torch.core.schedulers import ClassificationScheduler

    qn = min(n, 30_000)
    mb, mr, mt = deferrable_stream_multiday(qn, R, n_days=2, seed=0)
    qgrid2 = CarbonGrid.fully_connected(fleet.regions, latency_penalty=1.05,
                                        n_days=2, device=dev)
    qcaps = np.full((R, 3), np.inf)
    qcaps[:, 1] = qcaps[:, 2] = max(1.0, 0.6 * qn / (R * 48))
    train9 = _paper_train()
    static9 = LearnedPolicy.fit(
        ClassificationScheduler(carbon_head=False), train9, infra=infra,
        device=dev)
    serve9 = lambda inner, refitter=None: serve_stream(
        FleetRouter(full, grid=qgrid2, device=dev,
                    policy=TemporalPolicy(inner, qcaps, max_defer_h=16)),
        mb, mr, mt, step_h=2, refitter=refitter)
    g_static = serve9(static9).routed_carbon_g
    g_oracle = serve9(OraclePolicy(infra)).routed_carbon_g
    refitter = OnlineRefitter(min_observations=max(256, qn // 12),
                              refit_every=max(512, qn // 6))
    r_refit = serve9(static9, refitter=refitter)
    closed = (g_static - r_refit.routed_carbon_g) / max(
        g_static - g_oracle, 1e-9)
    print(f"  online refit on the multiday joint stream ({qn:,} requests): "
          f"static {g_static:.4g} g -> refit {r_refit.routed_carbon_g:.4g} g "
          f"(oracle {g_oracle:.4g} g)")
    print(f"  {r_refit.refits} hot-swaps closed {closed:.0%} of the "
          f"static-learned-vs-oracle routed-carbon gap")
    acts[9] = dict(arrivals=len(qbatch), steps=len(qres.steps),
                   batches=n_batches, shed=qres.shed_count,
                   spike_drafted=spike.drafted,
                   busiest_step_admitted=len(step_windows[busiest]),
                   routed_carbon_g=qres.routed_carbon_g, wall_s=qdt,
                   static_g=g_static, refit_g=r_refit.routed_carbon_g,
                   oracle_g=g_oracle, refits=r_refit.refits,
                   gap_closed=closed)

    # --- act 10: the scenario matrix ----------------------------------------
    # named (arrival pattern x grid event x fleet) compositions, every
    # registered policy over each: the compact version of
    # ``python -m repro_torch.launch.scenario_matrix``
    from repro_torch.serve.scenarios import (
        default_policies,
        default_scenarios,
        run_matrix,
    )

    mn = max(200, min(n, 100_000) // 50)
    msc = {k: v for k, v in default_scenarios().items()
           if k in ("curtailment_midday", "flash_crowd_10x",
                    "hetero_fleet_watt")}
    cells = run_matrix(msc, default_policies(), n=mn, device=dev)
    print(f"\nscenario matrix ({len(msc)} scenarios x "
          f"{len(default_policies())} policies, ~{mn} requests each):")
    print(f"  {'scenario':<20} {'policy':<18} {'total g':>9} "
          f"{'shed':>6} {'defer':>6}")
    for c in cells:
        print(f"  {c.scenario:<20} {c.policy:<18} {c.total_g:>9.3f} "
              f"{c.shed_rate:>6.1%} {c.defer_rate:>6.1%}")
    best = {}
    for c in cells:
        if c.scenario not in best or c.total_g < best[c.scenario].total_g:
            best[c.scenario] = c
    for name, c in best.items():
        print(f"  {name}: {c.policy} wins at {c.total_g:.3f} g")
    acts[10] = dict(n=mn, cells=cells,
                    winners={k: c.policy for k, c in best.items()})
    return TourResult(requests=n, device=str(dev), acts=acts)


if __name__ == "__main__":
    main()
