"""The port's capacity provisioning (``serve/provision.py``), its rates in
``core/infrastructure.py`` (``watt_caps``, ``server_carbon_rates``) and
``serve_stream(plan=...)`` against the JAX reference, on the CPU: the
cases of ``tests/test_provision.py`` (cost decomposition, greedy at SLO 0
equals the oracle, SLO bounds and monotone carbon, provisioned beats
static, validation, ``cap_scale``, ``apply_to_pool``, the plan-driven serve
loop) on both packages, plans bit-identical (server counts exactly, carbon
within rtol 1e-5), and the README's mesoscale provisioning table from the
port alone."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core import carbon_intensity as r_ci  # noqa: E402
from repro.core import infrastructure as r_inf  # noqa: E402
from repro.serve import placement as r_pl  # noqa: E402
from repro.serve import policy as r_pol  # noqa: E402
from repro.serve import provision as r_prov  # noqa: E402
from repro.serve import queue as r_q  # noqa: E402
from repro.serve import router as r_router  # noqa: E402
from repro.serve import streams as r_streams  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.core import infrastructure as t_inf  # noqa: E402
from repro_torch.core.constants import J_PER_KWH  # noqa: E402
from repro_torch.serve import placement as t_pl  # noqa: E402
from repro_torch.serve import policy as t_pol  # noqa: E402
from repro_torch.serve import provision as t_prov  # noqa: E402
from repro_torch.serve import queue as t_q  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402
from repro_torch.serve import streams as t_streams  # noqa: E402

from torch_fleet_parity import (  # noqa: E402
    ARCH,
    CPU,
    RTOL,
    assert_served_equal,
    one_thread,  # noqa: F401 (the module's fixture)
    torch_batch,
)

pytestmark = pytest.mark.usefixtures("one_thread")

R, K = 16, 4
PLAN_FLOATS = ("total_carbon_g", "operational_g", "embodied_g")
#: every draft of the plan-driven serve pads to one shape, so the
#: reference compiles its route once
ONE_SHAPE = 4096


@pytest.fixture(scope="module")
def grids():
    return (r_ci.CarbonGrid.from_sites(R, K, seed=0),
            t_ci.CarbonGrid.from_sites(R, K, seed=0, device=CPU))


@pytest.fixture(scope="module")
def fleets():
    return r_inf.paper_fleet(), t_inf.paper_fleet()


@pytest.fixture(scope="module")
def demand():
    _, region, t_hours = t_streams.multi_region_stream(6000, R, seed=1)
    return t_prov.demand_from_arrivals(region, t_hours, 24, R)


def assert_plans_equal(r_plan, t_plan):
    """Server counts and demand exactly; the per-cell costs and the plan's
    carbon within ``RTOL``; the forecast shed rate exactly (a ratio of
    equal sums)."""
    assert t_plan.name == r_plan.name
    assert t_plan.slots_per_server == r_plan.slots_per_server
    assert t_plan.servers.dtype == r_plan.servers.dtype
    for f in ("servers", "demand", "emb_g_per_h"):
        np.testing.assert_array_equal(getattr(t_plan, f),
                                      getattr(r_plan, f), err_msg=f)
    np.testing.assert_allclose(t_plan.cost_g, r_plan.cost_g, rtol=RTOL,
                               atol=0)
    for f in PLAN_FLOATS:
        np.testing.assert_allclose(getattr(t_plan, f), getattr(r_plan, f),
                                   rtol=RTOL, err_msg=f)
    assert t_plan.server_hours == r_plan.server_hours
    assert t_plan.shed_rate == r_plan.shed_rate


class TestRates:
    @pytest.mark.parametrize("fleet", ["paper", "tpu"])
    @pytest.mark.parametrize("model", ["act", "lca"])
    @pytest.mark.parametrize("utilization", [1.0, 0.5])
    def test_server_carbon_rates_match(self, fleet, model, utilization):
        r_f = getattr(r_inf, f"{fleet}_fleet")()
        t_f = getattr(t_inf, f"{fleet}_fleet")()
        for a, b in zip(t_inf.server_carbon_rates(t_f, model,
                                                  utilization=utilization),
                        r_inf.server_carbon_rates(r_f, model,
                                                  utilization=utilization)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    def test_server_carbon_rates_reject_unknown_model(self, fleets):
        with pytest.raises(ValueError, match="embodied model"):
            t_inf.server_carbon_rates(fleets[1], "bottom-up")

    @pytest.mark.parametrize("env", ["tpu", "paper"])
    @pytest.mark.parametrize("slots", [64.0, 10.0])
    def test_watt_caps_match(self, env, slots):
        budgets = np.array([[np.inf, 2500.0, 64000.0],
                            [np.inf, 10000.0, 260000.0],
                            [5.0, np.inf, 0.0]])
        got = t_inf.watt_caps(getattr(t_inf, f"{env}_envelope")(), budgets,
                              slots_per_server=slots)
        want = r_inf.watt_caps(getattr(r_inf, f"{env}_envelope")(), budgets,
                               slots_per_server=slots)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert np.isinf(got[:, 0]).all()  # mobile is user-owned: unbounded

    @pytest.mark.parametrize("budgets,slots", [
        (np.ones((2, 2)), 64.0), (-np.ones((2, 3)), 64.0),
        (np.ones((2, 3)), 0.0)])
    def test_watt_caps_validation(self, budgets, slots):
        with pytest.raises(ValueError):
            t_inf.watt_caps(t_inf.tpu_envelope(), budgets,
                            slots_per_server=slots)

    def test_infra_replace(self):
        infra = t_inf.pack_infra(t_inf.paper_fleet(), device=CPU)
        lat = infra.net_lat + 0.01
        moved = infra.replace(net_lat=lat)
        assert moved.net_lat is lat and moved.eff_flops is infra.eff_flops
        assert infra.net_lat is not lat


class TestStandingCost:
    def test_cost_decomposition(self, grids, fleets):
        # the grids hold the same CI bits (traces summed in XLA's order),
        # so the cost tables are bit-identical too
        for f in ("ci_hourly", "pue", "ci_mobile", "ci_core"):
            np.testing.assert_array_equal(getattr(grids[1], f).numpy(),
                                          np.asarray(getattr(grids[0], f)))
        cost, emb = t_prov.standing_cost_g(grids[1], fleets[1])
        r_cost, r_emb = r_prov.standing_cost_g(grids[0], fleets[0])
        np.testing.assert_array_equal(cost, r_cost)
        np.testing.assert_array_equal(emb, r_emb)
        emb_rates, idle_w = t_inf.server_carbon_rates(fleets[1])
        ci_dc = (grids[1].ci_hourly * grids[1].pue).numpy().T
        # mobile column carries no provisioning cost (user-owned hardware)
        assert (cost[:, :, 0] == 0).all() and emb[0] == 0.0
        for t in (1, 2):
            expect = emb_rates[t] + idle_w[t] * 3600.0 / J_PER_KWH * ci_dc
            np.testing.assert_allclose(cost[:, :, t], expect, rtol=1e-12)
            assert emb[t] == pytest.approx(emb_rates[t])

    @pytest.mark.parametrize("model,utilization", [("lca", 1.0),
                                                   ("act", 0.25)])
    def test_cost_options_match(self, grids, fleets, model, utilization):
        got = t_prov.standing_cost_g(grids[1], fleets[1],
                                     utilization=utilization,
                                     embodied_model=model)
        want = r_prov.standing_cost_g(grids[0], fleets[0],
                                      utilization=utilization,
                                      embodied_model=model)
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=0)
        np.testing.assert_array_equal(got[1], want[1])


class TestPlans:
    def test_demand_matches(self):
        _, region, t_hours = r_streams.multi_region_stream(6000, R, seed=1)
        np.testing.assert_array_equal(
            t_prov.demand_from_arrivals(region, t_hours, 24, R,
                                        tier_split=(0.1, 0.5, 0.7)),
            r_prov.demand_from_arrivals(region, t_hours, 24, R,
                                        tier_split=(0.1, 0.5, 0.7)))

    def test_greedy_zero_slo_matches_oracle(self, grids, fleets, demand):
        prov = t_prov.provision_greedy(demand, grids[1], fleets[1],
                                       slo_shed=0.0)
        orac = t_prov.oracle_plan(demand, grids[1], fleets[1])
        np.testing.assert_array_equal(prov.servers, orac.servers)
        assert prov.shed_rate == 0.0
        assert_plans_equal(r_prov.oracle_plan(demand, grids[0], fleets[0]),
                           orac)

    @pytest.mark.parametrize("slo", [0.0, 0.01, 0.02, 0.05, 0.1, 0.2])
    def test_greedy_matches_reference(self, grids, fleets, demand, slo):
        plan = t_prov.provision_greedy(demand, grids[1], fleets[1],
                                       slo_shed=slo)
        assert_plans_equal(
            r_prov.provision_greedy(demand, grids[0], fleets[0],
                                    slo_shed=slo), plan)
        assert plan.shed_rate <= slo + 1e-9

    @pytest.mark.parametrize("kw", [
        dict(), dict(headroom=2.0), dict(slots_per_server=16.0),
        dict(embodied_model="lca", utilization=0.5)])
    def test_static_matches_reference(self, grids, fleets, demand, kw):
        assert_plans_equal(
            r_prov.static_overprovision_plan(demand, grids[0], fleets[0],
                                             **kw),
            t_prov.static_overprovision_plan(demand, grids[1], fleets[1],
                                             **kw))

    def test_slo_monotone_carbon(self, grids, fleets, demand):
        totals = [t_prov.provision_greedy(demand, grids[1], fleets[1],
                                          slo_shed=s).total_carbon_g
                  for s in (0.0, 0.02, 0.1)]
        assert totals[0] >= totals[1] >= totals[2]

    def test_provisioned_beats_static_at_equal_or_lower_shed(
            self, grids, fleets, demand):
        prov = t_prov.provision_greedy(demand, grids[1], fleets[1])
        stat = t_prov.static_overprovision_plan(demand, grids[1], fleets[1])
        assert prov.total_carbon_g < stat.total_carbon_g
        assert prov.shed_rate <= stat.shed_rate + 1e-12
        assert prov.total_carbon_g == pytest.approx(
            prov.operational_g + prov.embodied_g)

    def test_greedy_prefers_cheaper_cells(self, grids, fleets):
        """Under an SLO the greedy drops the dirtiest cells first: every
        cell filled with full servers is no more carbon-per-slot expensive
        than any cell left a full server short. Four slots a server, so
        that at this demand both kinds of cell exist."""
        _, region, t_hours = t_streams.multi_region_stream(6000, R, seed=2)
        demand = t_prov.demand_from_arrivals(region, t_hours, 24, R)
        plan = t_prov.provision_greedy(demand, grids[1], fleets[1],
                                       slo_shed=0.1, slots_per_server=4.0)
        unmet = plan.demand - plan.served()
        s = plan.slots_per_server
        ratio = plan.cost_g / s
        full = (plan.servers * s <= plan.demand) & (plan.servers > 0)
        dropped = unmet > s
        assert full.any() and dropped.any()
        assert ratio[full].max() <= ratio[dropped].min() + 1e-9

    @pytest.mark.parametrize("case", [
        "slo_one", "short_demand", "negative_demand", "low_headroom",
        "zero_slots", "outside_horizon", "bad_split"])
    def test_validation(self, grids, fleets, demand, case):
        g, f = grids[1], fleets[1]
        call = {
            "slo_one": lambda: t_prov.provision_greedy(demand, g, f,
                                                       slo_shed=1.0),
            "short_demand": lambda: t_prov.provision_greedy(demand[:12], g,
                                                            f),
            "negative_demand": lambda: t_prov.oracle_plan(-demand, g, f),
            "low_headroom": lambda: t_prov.static_overprovision_plan(
                demand, g, f, headroom=0.9),
            "zero_slots": lambda: t_prov.provision_greedy(
                demand, g, f, slots_per_server=0.0),
            "outside_horizon": lambda: t_prov.demand_from_arrivals(
                np.zeros(3, int), np.array([0.5, 1.5, 99.0]), 24, R),
            "bad_split": lambda: t_prov.demand_from_arrivals(
                np.zeros(1, int), np.array([0.5]), 24, R,
                tier_split=(0.5, 0.5)),
        }[case]
        with pytest.raises(ValueError):
            call()

    @pytest.mark.parametrize("hour", [5, -3, 99])
    def test_cap_scale_mobile_unbounded(self, grids, fleets, demand, hour):
        plan = t_prov.provision_greedy(demand, grids[1], fleets[1])
        m = plan.cap_scale(hour)
        assert m.shape == (R, 3) and m.dtype == np.float32
        assert np.isinf(m[:, 0]).all()
        h = int(np.clip(hour, 0, 23))
        np.testing.assert_array_equal(
            m[:, 1:], plan.servers[h, :, 1:] * plan.slots_per_server)
        np.testing.assert_array_equal(
            m, r_prov.provision_greedy(demand, grids[0],
                                       fleets[0]).cap_scale(hour))

    def test_forecasts_match(self, demand):
        for fn, kw in ((t_prov.smoothed_demand_forecast, {}),
                       (t_prov.smoothed_demand_forecast, dict(window_h=3)),
                       (t_prov.spike_demand_forecast,
                        dict(spike_at_h=20.0, spike_mult=10.0,
                             spike_width_h=2.0))):
            ref = getattr(r_prov, fn.__name__)
            np.testing.assert_array_equal(fn(demand, **kw),
                                          ref(demand, **kw))
        with pytest.raises(ValueError):
            t_prov.smoothed_demand_forecast(demand, window_h=0)
        with pytest.raises(ValueError):
            t_prov.spike_demand_forecast(demand, spike_at_h=1.0,
                                         spike_mult=0.5)

    def test_realized_shed_rate_matches(self, grids, fleets, demand):
        blind = t_prov.smoothed_demand_forecast(demand)
        plan = t_prov.provision_greedy(blind, grids[1], fleets[1],
                                       slo_shed=0.05)
        r_plan = r_prov.provision_greedy(blind, grids[0], fleets[0],
                                         slo_shed=0.05)
        assert t_prov.realized_shed_rate(plan, demand) == \
            r_prov.realized_shed_rate(r_plan, demand)
        assert t_prov.realized_shed_rate(plan, np.zeros_like(demand)) == 0.0
        with pytest.raises(ValueError):
            t_prov.realized_shed_rate(plan, demand[:3])


class TestPoolSchedule:
    def test_apply_to_pool_reaches_plan_counts(self, grids, fleets, demand):
        plan = t_prov.provision_greedy(demand, grids[1], fleets[1])
        r_plan = r_prov.provision_greedy(demand, grids[0], fleets[0])
        pool = t_q.WorkerPool(R, slots_per_worker=plan.slots_per_server)
        r_pool = r_q.WorkerPool(R, slots_per_worker=plan.slots_per_server)
        plan.apply_to_pool(pool, 0)
        r_plan.apply_to_pool(r_pool, 0)
        pool.tick()  # one-step launch delay
        r_pool.tick()
        np.testing.assert_array_equal(pool.active[:, 1:],
                                      plan.servers[0, :, 1:])
        # idempotent: re-applying the same hour changes nothing
        plan.apply_to_pool(pool, 0)
        assert pool.launching.sum() == 0
        # another hour drains the excess and launches the deficit; one tick
        # later the pool matches the new target exactly
        h2 = int(np.argmin(plan.servers.sum(axis=(1, 2))))
        plan.apply_to_pool(pool, h2)
        r_plan.apply_to_pool(r_pool, h2)
        pool.tick()
        r_pool.tick()
        np.testing.assert_array_equal(pool.active[:, 1:],
                                      plan.servers[h2, :, 1:])
        for f in ("active", "draining", "launching"):
            np.testing.assert_array_equal(getattr(pool, f),
                                          getattr(r_pool, f), err_msg=f)
        np.testing.assert_array_equal(pool.cap_matrix(), r_pool.cap_matrix())


@pytest.fixture(scope="module")
def served(grids, fleets):
    """A 3000-request stream on the 16-site grid served under the greedy
    and the static plan (16 slots a server) by both packages."""
    batch, region, t_hours = r_streams.multi_region_stream(3000, R, seed=3)
    demand = r_prov.demand_from_arrivals(region, t_hours, 24, R)
    plans = {}
    for name, mod, g, f in (("r", r_prov, grids[0], fleets[0]),
                            ("t", t_prov, grids[1], fleets[1])):
        plans[name] = (mod.provision_greedy(demand, g, f,
                                            slots_per_server=16.0),
                       mod.static_overprovision_plan(demand, g, f,
                                                     slots_per_server=16.0))
    r_cfg, t_cfg = r_get_config(ARCH), t_get_config(ARCH)
    r_infra = r_router.FleetRouter(r_cfg).infra
    t_infra = t_router.FleetRouter(t_cfg, device=CPU).infra
    r_fr = r_router.FleetRouter(r_cfg, grid=grids[0], policy=r_pl.
                                PlacementPolicy(r_pol.OraclePolicy(r_infra),
                                                np.ones((R, 3))))
    t_fr = t_router.FleetRouter(t_cfg, grid=grids[1], device=CPU,
                                policy=t_pl.PlacementPolicy(
                                    t_pol.OraclePolicy(t_infra),
                                    np.ones((R, 3))))
    out = {}
    for k in (0, 1):
        out[("r", k)] = r_q.serve_stream(
            r_fr, batch, region, t_hours, plan=plans["r"][k],
            former=r_q.BatchFormer(min_pad=ONE_SHAPE))
        out[("t", k)] = t_q.serve_stream(
            t_fr, torch_batch(batch), region, t_hours, plan=plans["t"][k],
            former=t_q.BatchFormer(min_pad=ONE_SHAPE))
    return plans, out, len(region)


class TestServeWithPlan:
    @pytest.mark.parametrize("k", [0, 1], ids=["provisioned", "static"])
    def test_decisions_match_reference(self, served, k):
        plans, out, _ = served
        assert_plans_equal(plans["r"][k], plans["t"][k])
        assert_served_equal(out[("r", k)], out[("t", k)])

    def test_serve_stream_with_plan(self, served):
        """The plan drives the pool inside serve_stream: the provisioned
        serve sheds no more than the static one (within 2% of the stream)
        while standing plus routed carbon is lower."""
        plans, out, n = served
        prov, stat = plans["t"]
        qp, qs = out[("t", 0)], out[("t", 1)]
        assert qp.shed_count + (~qp.shed).sum() == n
        assert qp.shed_count <= qs.shed_count + int(0.02 * n)
        assert prov.total_carbon_g < stat.total_carbon_g
        assert (prov.total_carbon_g + qp.routed_carbon_g
                < stat.total_carbon_g + qs.routed_carbon_g)
        # every step's live slots are the plan's counts at that hour
        for s in qp.steps:
            np.testing.assert_array_equal(s.slots, prov.cap_scale(s.now))

    def test_plan_builds_pool_of_its_width(self, served):
        plans, _, _ = served
        prov = plans["t"][0]
        assert prov.n_regions == R and prov.horizon_h == 24


def test_readme_mesoscale_provisioning_table():
    """The README's 'Mesoscale provisioning' table (20k requests over the
    128-site sparse grid, paper fleet, 64 slots a server) from the port:
    server-hours exactly, total gCO2 to its printed digits, shed rates."""
    grid = t_ci.CarbonGrid.from_sites(128, 8, seed=0, device=CPU)
    _, region, t_hours = t_streams.multi_region_stream(20_000, 128, seed=1)
    demand = t_prov.demand_from_arrivals(region, t_hours, 24, 128)
    fleet = t_inf.paper_fleet()
    plans = {
        "static": t_prov.static_overprovision_plan(demand, grid, fleet),
        "oracle": t_prov.oracle_plan(demand, grid, fleet),
        "slo0": t_prov.provision_greedy(demand, grid, fleet),
        "slo2": t_prov.provision_greedy(demand, grid, fleet, slo_shed=0.02),
    }
    want = {"static": (6144, 1_035_304, 0.0), "oracle": (5788, 973_133, 0.0),
            "slo0": (5788, 973_133, 0.0), "slo2": (5257, 792_473, 0.02)}
    for k, (hours, total_g, shed) in want.items():
        p = plans[k]
        assert (p.server_hours, round(p.total_carbon_g)) == (hours, total_g), k
        assert round(p.shed_rate, 2) == shed, k
    assert plans["slo0"].name == "provisioned"
