"""The port's rolling forecast-native re-planner (``serve/forecast.py``)
against the JAX reference, on the CPU: ``route_stream_rolling`` with and
without an ``EmissionsLedger`` on ``forecast_scenario`` streams (every
commitment, the step trace and carbon), the ledger's ``cap_scales`` with
and without a demand forecast, the pow-2 sub-batch padding; and, within
the port, the reference's own properties: a zero-error forecast reproduces
the error-blind route bit for bit, rolling risk-aware re-planning beats the
one-shot error-blind plan at sigma 0.06, conservation and deadlines hold.
Integers exactly, carbon within rtol 1e-5."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.serve import forecast as r_fc  # noqa: E402
from repro.serve import policy as r_pol  # noqa: E402
from repro.serve import router as r_router  # noqa: E402
from repro.serve import streams as r_streams  # noqa: E402
from repro.serve import temporal as r_tmp  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.serve import forecast as t_fc  # noqa: E402
from repro_torch.serve import placement as t_pl  # noqa: E402
from repro_torch.serve import policy as t_pol  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402
from repro_torch.serve import streams as t_streams  # noqa: E402
from repro_torch.serve import temporal as t_tmp  # noqa: E402

from torch_fleet_parity import ARCH, CPU, RTOL, host, torch_batch  # noqa: E402

N = 1000
R = 4
COMMIT_FIELDS = ("target", "exec_region", "exec_hour", "defer_hours",
                 "shed")
STEP_INT = ("now", "planned", "committed", "held", "shed")
STEP_FLOAT = ("trend", "cap_scale", "earned", "spent")


@pytest.fixture(scope="module")
def env():
    r_cfg, t_cfg = r_get_config(ARCH), t_get_config(ARCH)
    r_base = r_router.FleetRouter(r_cfg)
    t_base = t_router.FleetRouter(t_cfg, device=CPU)
    return dict(r_cfg=r_cfg, t_cfg=t_cfg, r_inf=r_base.infra,
                t_inf=t_base.infra, regions=r_base.regions)


def _scenario(env, n, sigma, seed):
    """The same ``forecast_scenario`` from both packages (the port's grid
    on the CPU); the streams are numpy and must be equal."""
    r = r_streams.forecast_scenario(n, env["regions"], sigma_h=sigma,
                                    seed=seed)
    t = t_streams.forecast_scenario(n, env["regions"], sigma_h=sigma,
                                    seed=seed, device=CPU)
    np.testing.assert_array_equal(t[1], r[1])
    np.testing.assert_array_equal(t[2], r[2])
    return r, t


def _temporal(env, grids, caps, **kw):
    r_fr = r_router.FleetRouter(env["r_cfg"], grid=grids[0],
                                policy=r_tmp.TemporalPolicy(
                                    r_pol.OraclePolicy(env["r_inf"]), caps,
                                    **kw))
    t_fr = t_router.FleetRouter(env["t_cfg"], grid=grids[1],
                                policy=t_tmp.TemporalPolicy(
                                    t_pol.OraclePolicy(env["t_inf"]), caps,
                                    **kw), device=CPU)
    return r_fr, t_fr


def assert_rolling_equal(r_roll, t_roll):
    for f in COMMIT_FIELDS:
        got, want = getattr(t_roll, f), getattr(r_roll, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_allclose(t_roll.carbon_g, r_roll.carbon_g, rtol=RTOL,
                               atol=0)
    for f in ("total_carbon_g", "routed_carbon_g"):
        np.testing.assert_allclose(getattr(t_roll, f), getattr(r_roll, f),
                                   rtol=RTOL, err_msg=f)
    assert (t_roll.shed_count, t_roll.deferred_count) == (
        r_roll.shed_count, r_roll.deferred_count)
    assert len(t_roll.steps) == len(r_roll.steps)
    for ts, rs in zip(t_roll.steps, r_roll.steps):
        for f in STEP_INT:
            assert getattr(ts, f) == getattr(rs, f), f
        for f in STEP_FLOAT:
            np.testing.assert_allclose(getattr(ts, f), getattr(rs, f),
                                       rtol=RTOL, err_msg=f)


class TestRollingParity:
    def test_route_stream_rolling_risk_aware(self, env):
        """The benchmark's rolling row: uncapped, risk-aware, no ledger."""
        (rb, rr, rt, rg), (tb, _, _, tg) = _scenario(env, N, 0.03, 0)
        r_fr, t_fr = _temporal(env, (rg, tg), np.full((R, 3), np.inf),
                               max_defer_h=12, risk_lambda=1.0)
        r_roll = r_fr.route_stream_rolling(rb, rr, rt, step_h=6)
        t_roll = t_fr.route_stream_rolling(tb, rr, rt, step_h=6)
        assert_rolling_equal(r_roll, t_roll)
        assert t_roll.deferred_count > 0

    def test_route_stream_rolling_ledger_under_caps(self, env):
        """Binding DC caps (sheds and holds), the emissions ledger with a
        demand forecast, error-blind scores, sigma 0.06."""
        (rb, rr, rt, rg), (tb, _, _, tg) = _scenario(env, N, 0.06, 2)
        caps = np.full((R, 3), 2.0)
        caps[:, 0] = np.inf
        r_fr, t_fr = _temporal(env, (rg, tg), caps, max_defer_h=12)
        demand = np.bincount(np.floor(rt).astype(int),
                             minlength=rg.horizon_h) * 1.0
        r_roll = r_fr.route_stream_rolling(
            rb, rr, rt, step_h=6,
            ledger=r_fc.EmissionsLedger(demand_fc=demand))
        t_roll = t_fr.route_stream_rolling(
            torch_batch(rb), rr, rt, step_h=6,
            ledger=t_fc.EmissionsLedger(demand_fc=demand))
        assert_rolling_equal(r_roll, t_roll)
        assert t_roll.shed_count > 0 and t_roll.deferred_count > 0
        assert sum(s.held for s in t_roll.steps) > 0
        assert (np.stack([s.cap_scale for s in t_roll.steps]) != 1.0).any()

    def test_router_delegates(self, env):
        assert t_router.FleetRouter.route_stream_rolling.__doc__
        (_, rr, rt, _), (tb, _, _, tg) = _scenario(env, 64, 0.03, 0)
        caps = np.full((R, 3), np.inf)
        fr = t_router.FleetRouter(env["t_cfg"], grid=tg, device=CPU,
                                  policy=t_pl.PlacementPolicy(
                                      t_pol.OraclePolicy(env["t_inf"]),
                                      caps))
        with pytest.raises(ValueError, match="TemporalPolicy"):
            fr.route_stream_rolling(tb, rr, rt)
        fr = t_router.FleetRouter(env["t_cfg"], grid=tg, device=CPU,
                                  policy=t_tmp.TemporalPolicy(
                                      t_pol.OraclePolicy(env["t_inf"]),
                                      caps))
        with pytest.raises(ValueError, match="step_h"):
            fr.route_stream_rolling(tb, rr, rt, step_h=0)
        with pytest.raises(ValueError, match="never wraps"):
            fr.route_stream_rolling(tb, rr, rt + tg.horizon_h)


class TestLedger:
    def test_validation(self):
        with pytest.raises(ValueError, match="conserve_scale"):
            t_fc.EmissionsLedger(conserve_scale=0.0)
        with pytest.raises(ValueError, match="spend_scale"):
            t_fc.EmissionsLedger(spend_scale=0.5)
        with pytest.raises(ValueError, match="spike_threshold"):
            t_fc.EmissionsLedger(spike_threshold=1.0)

    @pytest.mark.parametrize("demand", [None, "flat", "spike"])
    def test_cap_scales(self, demand):
        rng = np.random.default_rng(5)
        fc = rng.uniform(50, 500, (R, 48))
        d = {None: None, "flat": np.full(48, 100.0),
             "spike": np.where(np.arange(48) % 17 == 3, 400.0, 80.0)}[demand]
        led = dict(lookahead_h=6, demand_fc=d)
        r_led, t_led = r_fc.EmissionsLedger(**led), t_fc.EmissionsLedger(**led)
        bal_r = bal_t = np.zeros(R)
        for now in range(0, 48, 6):
            want = r_led.cap_scales(fc, now, 6, bal_r)
            got = t_led.cap_scales(fc, now, 6, bal_t)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            bal_r, bal_t = want[1], got[1]

    def test_pad_pow2_and_slice_batch(self, env):
        for n in (0, 1, 15, 16, 17, 1000, 4097):
            assert t_fc.pad_pow2(n) == r_fc.pad_pow2(n)
            assert t_fc.pad_pow2(n, 4) == r_fc.pad_pow2(n, 4)
        (rb, _, _, _), (tb, _, _, _) = _scenario(env, 40, 0.03, 1)
        idx = np.array([3, 0, 17, 39])
        r_s, t_s = r_fc.slice_batch(rb, idx, 16), t_fc.slice_batch(tb, idx, 16)
        for f in dataclasses.fields(t_s):
            np.testing.assert_array_equal(getattr(t_s, f.name),
                                          np.asarray(getattr(r_s, f.name)))
        assert not t_s.available[4:].any()  # pad rows are unroutable


class TestPortProperties:
    """The reference's own forecast properties, on the port alone."""

    def test_zero_error_forecast_is_the_error_blind_route(self, env):
        n = 1500
        batch, region, t_hours = t_streams.deferrable_stream_multiday(
            n, R, n_days=2, seed=3)
        g = t_ci.CarbonGrid.fully_connected(latency_penalty=1.05, n_days=2,
                                            device=CPU)
        g_eq = g.with_forecast(g.ci_hourly)  # an explicit perfect forecast
        caps = np.full((R, 3), 40.0)
        out = []
        for grid in (g, g_eq):
            fr = t_router.FleetRouter(env["t_cfg"], grid=grid, device=CPU,
                                      policy=t_tmp.TemporalPolicy(
                                          t_pol.OraclePolicy(env["t_inf"]),
                                          caps, max_defer_h=12))
            out.append(fr.route_stream_with_state(batch, region, t_hours))
        (ra, sa), (rb, sb) = out
        for a, b in ((ra.target, rb.target), (ra.exec_region, rb.exec_region),
                     (sa.exec_hour, sb.exec_hour), (sa.shed, sb.shed),
                     (ra.carbon_g, rb.carbon_g)):
            assert torch.equal(a, b)
        assert t_ci.CarbonGrid.fully_connected(
            device=CPU).forecast_from_actual(0.0).ci_forecast is None

    def test_rolling_beats_one_shot_at_sigma_006(self, env):
        n = 3000
        batch, region, t_hours, grid = t_streams.forecast_scenario(
            n, env["regions"], sigma_h=0.06, seed=0, device=CPU)
        caps = np.full((R, 3), np.inf)
        mk = lambda risk: t_router.FleetRouter(
            env["t_cfg"], grid=grid, device=CPU,
            policy=t_tmp.TemporalPolicy(t_pol.OraclePolicy(env["t_inf"]),
                                        caps, max_defer_h=12,
                                        risk_lambda=risk))
        blind, aware = mk(0.0), mk(1.0)
        g_blind = float(blind.route_stream(batch, region,
                                           t_hours).routed_carbon_g)
        roll_blind = blind.route_stream_rolling(batch, region, t_hours,
                                                step_h=6).routed_carbon_g
        roll_aware = aware.route_stream_rolling(batch, region, t_hours,
                                                step_h=6).routed_carbon_g
        assert roll_aware < 0.95 * g_blind, (roll_aware, g_blind)
        assert roll_aware < roll_blind, (roll_aware, roll_blind)

    def test_conservation_deadlines_and_ledger_credit(self, env):
        n = 1200
        batch, region, t_hours, grid = t_streams.forecast_scenario(
            n, env["regions"], sigma_h=0.06, seed=1, device=CPU)
        caps = np.full((R, 3), 25.0)
        fr = t_router.FleetRouter(env["t_cfg"], grid=grid, device=CPU,
                                  policy=t_tmp.TemporalPolicy(
                                      t_pol.OraclePolicy(env["t_inf"]), caps,
                                      max_defer_h=12))
        roll = fr.route_stream_rolling(batch, region, t_hours, step_h=6,
                                       ledger=t_fc.EmissionsLedger())
        arr = np.floor(t_hours).astype(np.int32)
        slack = np.minimum(batch.slack_h, 12)
        live = ~roll.shed
        for s in roll.steps:
            assert s.planned == s.committed + s.held
        assert sum(s.committed for s in roll.steps) == n
        assert (roll.exec_hour[live] >= arr[live]).all()
        assert (roll.exec_hour[live] <= arr[live] + slack[live]).all()
        assert (roll.exec_hour < grid.horizon_h).all()
        np.testing.assert_array_equal(roll.defer_hours[live],
                                      roll.exec_hour[live] - arr[live])
        assert roll.total_carbon_g >= roll.routed_carbon_g >= 0.0
        earned = np.sum([s.earned for s in roll.steps], axis=0)
        spent = np.sum([s.spent for s in roll.steps], axis=0)
        assert (spent <= earned + 1e-9).all()
        assert (np.stack([s.cap_scale for s in roll.steps]) != 1.0).any()
        # the settle is the host sum of the float32 per-request carbon
        assert roll.carbon_g.dtype == np.float32
        assert roll.routed_carbon_g == float(roll.carbon_g[live].sum())
        assert host(torch.as_tensor(roll.target)).shape == (n,)
