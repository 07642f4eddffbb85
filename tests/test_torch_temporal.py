"""Parity of the port's ``TemporalPolicy`` with the JAX reference, on the
CPU: defer-only (identity adjacency), joint spatio-temporal deferral, a
two-day horizon, a rolling forecast with ``risk_lambda``, a WAN-hop grid
and a sparse site grid, fed the same numpy streams. Integer outputs
(targets, executing region and hour, defer hours, shed masks, counts) must
match exactly and carbon within rtol 1e-5. Within the port, zero slack
reproduces ``PlacementPolicy`` and dense == sparse neighbour lists."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core import carbon_intensity as r_ci  # noqa: E402
from repro.serve import policy as r_pol  # noqa: E402
from repro.serve import router as r_router  # noqa: E402
from repro.serve import streams as r_streams  # noqa: E402
from repro.serve import temporal as r_tmp  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.serve import placement as t_pl  # noqa: E402
from repro_torch.serve import policy as t_pol  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402
from repro_torch.serve import temporal as t_tmp  # noqa: E402

from torch_fleet_parity import (  # noqa: E402
    ARCH,
    CPU,
    assert_results_equal,
    dc_caps,
    host,
    route_both,
    torch_batch,
)

N = 4000
N_MESO, R_MESO = 3000, 24


@pytest.fixture(scope="module")
def env():
    r_cfg, t_cfg = r_get_config(ARCH), t_get_config(ARCH)
    return dict(
        r_cfg=r_cfg, t_cfg=t_cfg,
        r_inf=r_router.FleetRouter(r_cfg).infra,
        t_inf=t_router.FleetRouter(t_cfg, device=CPU).infra,
        stream=r_streams.deferrable_stream(N, 4),
        multiday=r_streams.deferrable_stream_multiday(N, 4, n_days=2,
                                                      seed=3),
        meso=r_streams.deferrable_stream(N_MESO, R_MESO, seed=2))


#: name -> (grid(module, **device kw) or None, stream key, cap fraction,
#: TemporalPolicy keyword arguments)
CONFIGS = {
    "defer-only": (None, "stream", 0.6, dict(max_defer_h=12)),
    "joint": (lambda m, **kw: m.CarbonGrid.fully_connected(
        latency_penalty=1.05, **kw), "stream", 0.6, dict(max_defer_h=12)),
    "joint-uncapped-latency": (lambda m, **kw: m.CarbonGrid.fully_connected(
        latency_penalty=1.05, **kw), "stream", None,
        dict(max_defer_h=8, metric="latency")),
    "joint-2-day": (lambda m, **kw: m.CarbonGrid.fully_connected(
        latency_penalty=1.05, n_days=2, **kw), "multiday", 0.6,
        dict(max_defer_h=12)),
    "defer-only-2-day-6h-windows": (lambda m, **kw: m.CarbonGrid.from_regions(
        n_days=2, **kw), "multiday", 0.5, dict(max_defer_h=4, n_windows=6)),
    "forecast-risk": (lambda m, **kw: m.CarbonGrid.fully_connected(
        latency_penalty=1.05, n_days=2, forecast_sigma_h=0.06,
        forecast_seed=5, **kw), "multiday", 0.6,
        dict(max_defer_h=12, risk_lambda=1.5)),
    "joint-rtt": (lambda m, **kw: m.CarbonGrid.fully_connected(
        latency_penalty=1.05, rtt_s=0.9, **kw), "stream", 0.6,
        dict(max_defer_h=10)),
    "sparse-sites": (lambda m, **kw: m.CarbonGrid.from_sites(
        R_MESO, 5, seed=0, **kw), "meso", 0.5, dict(max_defer_h=6)),
}


def _routers(env, name):
    grid_fn, key, frac, kw = CONFIGS[name]
    kw = dict(kw)
    metric = kw.pop("metric", "carbon")
    n_regions = R_MESO if key == "meso" else 4
    caps = dc_caps(len(env[key][0]), n_regions, frac or 1.0)
    if frac is None:
        caps[:] = np.inf
    out = []
    for m, pol, tmp, router, cfg, inf, dev in (
            (r_ci, r_pol, r_tmp, r_router, env["r_cfg"], env["r_inf"], {}),
            (t_ci, t_pol, t_tmp, t_router, env["t_cfg"], env["t_inf"],
             dict(device=CPU))):
        grid = None if grid_fn is None else grid_fn(m, **dev)
        policy = tmp.TemporalPolicy(pol.OraclePolicy(inf, metric), caps,
                                    **kw)
        out.append(router.FleetRouter(cfg, grid=grid, policy=policy, **dev))
    return out[0], out[1], env[key]


class TestTemporalParity:
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_route_stream(self, env, name):
        r_fr, t_fr, stream = _routers(env, name)
        r_res, r_st, t_res, t_st = route_both(r_fr, t_fr, stream)
        assert_results_equal(r_res, t_res, r_st, t_st)
        assert t_st.exec_hour.dtype == torch.int32
        if "metric" not in CONFIGS[name][3]:  # latency scores are CI-free
            assert int(t_res.deferred_count) > 0
        slack = np.minimum(np.floor(stream[0].slack_hours),
                           t_fr.policy.max_defer_h)
        defer = host(t_st.defer_hours)
        assert ((defer >= 0) & (defer <= slack)).all()
        assert (host(t_st.exec_hour) < t_fr.grid.horizon_h).all()
        assert t_fr.policy.last_rounds > 0


class TestPortEqualities:
    @pytest.mark.parametrize("grid_kind", ["identity", "fully_connected"])
    def test_zero_slack_equals_placement(self, env, grid_kind):
        batch, region, t_hours = env["stream"]
        batch = dataclasses.replace(torch_batch(batch),
                                    slack_hours=np.zeros(N))
        caps = dc_caps(N, 4, 0.4)
        inf = env["t_inf"]
        out = []
        for cls, kw in ((t_pl.PlacementPolicy, {}),
                        (t_tmp.TemporalPolicy, dict(max_defer_h=12))):
            grid = (t_ci.CarbonGrid.from_regions(device=CPU)
                    if grid_kind == "identity" else
                    t_ci.CarbonGrid.fully_connected(latency_penalty=1.05,
                                                    device=CPU))
            fr = t_router.FleetRouter(
                env["t_cfg"], grid=grid, device=CPU,
                policy=cls(t_pol.OraclePolicy(inf), caps, **kw))
            out.append(fr.route_stream_with_state(batch, region, t_hours))
        (a, sa), (b, sb) = out
        for f in ("target", "counts", "shed_count", "exec_region",
                  "spilled_count"):
            np.testing.assert_array_equal(host(getattr(a, f)),
                                          host(getattr(b, f)), err_msg=f)
        np.testing.assert_array_equal(host(sa.shed), host(sb.shed))
        assert int(b.deferred_count) == 0
        np.testing.assert_allclose(float(b.total_carbon_g),
                                   float(a.total_carbon_g), rtol=1e-6)

    def test_dense_equals_sparse(self, env):
        caps = dc_caps(N, 4, 0.6)
        dense = t_ci.CarbonGrid.fully_connected(latency_penalty=1.05,
                                                rtt_s=0.4, device=CPU)
        res = []
        for grid in (dense, dense.with_sparse_neighbors()):
            fr = t_router.FleetRouter(
                env["t_cfg"], grid=grid, device=CPU,
                policy=t_tmp.TemporalPolicy(t_pol.OraclePolicy(env["t_inf"]),
                                            caps, max_defer_h=12))
            res.append(fr.route_stream_with_state(
                torch_batch(env["stream"][0]), *env["stream"][1:]))
        (a, sa), (b, sb) = res
        for f in ("target", "exec_region", "counts", "shed_count"):
            np.testing.assert_array_equal(host(getattr(a, f)),
                                          host(getattr(b, f)), err_msg=f)
        np.testing.assert_array_equal(host(sa.exec_hour), host(sb.exec_hour))
        assert float(a.total_carbon_g) == float(b.total_carbon_g)


class TestValidation:
    def test_rejections(self, env):
        inf = env["t_inf"]
        caps = np.ones((4, 3))
        oracle = t_pol.OraclePolicy(inf)
        with pytest.raises(ValueError):  # 5 divides neither way into 24
            t_tmp.TemporalPolicy(oracle, caps, n_windows=5)
        with pytest.raises(ValueError):  # defer horizon beyond the windows
            t_tmp.TemporalPolicy(oracle, caps, n_windows=6, max_defer_h=6)
        with pytest.raises(ValueError):  # needs the factorized scorer
            t_tmp.TemporalPolicy(oracle, caps, factorized=False)
        with pytest.raises(ValueError):  # resolved horizon of 24 windows
            t_router.FleetRouter(env["t_cfg"], device=CPU,
                                 policy=t_tmp.TemporalPolicy(
                                     oracle, caps, max_defer_h=24))
        pol = t_tmp.TemporalPolicy(oracle, caps)
        t_router.FleetRouter(env["t_cfg"], device=CPU, policy=pol)
        assert pol.n_windows == 24 and pol.wants_factors
