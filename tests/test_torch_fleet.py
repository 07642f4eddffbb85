"""Parity of the port's fleet routing with the JAX reference, on the CPU:
``FleetRouter`` over the oracle's three metrics, ``CapacityLimiter``,
``PlacementPolicy`` (tier-only, cross-region factorized, the legacy sweep,
a WAN-hop grid and a sparse mesoscale grid) and ``GreenScaleRouter(policy=
...)``, fed the same numpy streams. Integer outputs must match exactly and
carbon within rtol 1e-5. Within the port, the reference's own equalities
hold: ``adjacency=I`` placement == ``CapacityLimiter`` and dense == sparse
neighbour lists."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core import carbon_intensity as r_ci  # noqa: E402
from repro.launch.serve import env_at_hour as r_env_at_hour  # noqa: E402
from repro.serve import placement as r_pl  # noqa: E402
from repro.serve import policy as r_pol  # noqa: E402
from repro.serve import router as r_router  # noqa: E402
from repro.serve import streams as r_streams  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.launch.serve import env_at_hour as t_env_at_hour  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve import placement as t_pl  # noqa: E402
from repro_torch.serve import policy as t_pol  # noqa: E402
from repro_torch.serve import queue as t_q  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402

import torch_dist_parity as tdp  # noqa: E402
from torch_fleet_parity import (  # noqa: E402
    ARCH,
    CPU,
    RTOL,
    assert_results_equal,
    dc_caps,
    host,
    route_both,
    torch_batch,
)

N = 4000
N_MESO, R_MESO = 3000, 32


@pytest.fixture(scope="module")
def env():
    r_cfg, t_cfg = r_get_config(ARCH), t_get_config(ARCH)
    r_base = r_router.FleetRouter(r_cfg)
    t_base = t_router.FleetRouter(t_cfg, device=CPU)
    return dict(r_cfg=r_cfg, t_cfg=t_cfg, r_inf=r_base.infra,
                t_inf=t_base.infra,
                stream=r_streams.multi_region_stream(N, 4),
                meso=r_streams.multi_region_stream(N_MESO, R_MESO, seed=1))


def _fc(m, **kw):
    return m.CarbonGrid.fully_connected(latency_penalty=1.05, **kw)


#: name -> (grid(module, **device kw) or None, policy(pol, pl, infra, caps)
#: or None, stream key, cap fraction)
CONFIGS = {
    "oracle-carbon": (None, lambda pol, pl, inf, c: pol.OraclePolicy(inf),
                      "stream", None),
    "oracle-latency": (None, lambda pol, pl, inf, c: pol.OraclePolicy(
        inf, "latency"), "stream", None),
    "oracle-energy": (None, lambda pol, pl, inf, c: pol.OraclePolicy(
        inf, "energy"), "stream", None),
    "default-policy": (_fc, None, "stream", None),
    "capacity-limiter": (None, lambda pol, pl, inf, c: pol.CapacityLimiter(
        pol.OraclePolicy(inf), c), "stream", 0.4),
    "tier-spill": (None, lambda pol, pl, inf, c: pl.PlacementPolicy(
        pol.OraclePolicy(inf), c), "stream", 0.4),
    "tier-spill-fractional-6-windows": (
        None, lambda pol, pl, inf, c: pl.PlacementPolicy(
            pol.OraclePolicy(inf, "latency"), c * 0.37 + 0.5, n_windows=6),
        "stream", 0.4),
    "xregion": (_fc, lambda pol, pl, inf, c: pl.PlacementPolicy(
        pol.OraclePolicy(inf), c), "stream", 0.4),
    "xregion-energy": (_fc, lambda pol, pl, inf, c: pl.PlacementPolicy(
        pol.OraclePolicy(inf, "energy"), c), "stream", 0.4),
    "xregion-legacy-sweep": (_fc, lambda pol, pl, inf, c: pl.PlacementPolicy(
        pol.OraclePolicy(inf), c, factorized=False), "stream", 0.4),
    "xregion-rtt": (lambda m, **kw: m.CarbonGrid.fully_connected(
        latency_penalty=1.05, rtt_s=0.9, **kw),
        lambda pol, pl, inf, c: pl.PlacementPolicy(pol.OraclePolicy(inf), c),
        "stream", 0.4),
    "xregion-forecast": (lambda m, **kw: _fc(
        m, n_days=2, forecast_sigma_h=0.06, forecast_seed=1, **kw),
        lambda pol, pl, inf, c: pl.PlacementPolicy(pol.OraclePolicy(inf), c),
        "stream", 0.4),
    "mesoscale-sparse": (lambda m, **kw: m.CarbonGrid.from_sites(
        R_MESO, 6, seed=0, **kw),
        lambda pol, pl, inf, c: pl.PlacementPolicy(pol.OraclePolicy(inf), c),
        "meso", 0.4),
}


def _routers(env, name):
    grid_fn, pol_fn, key, frac = CONFIGS[name]
    n_regions = R_MESO if key == "meso" else 4
    caps = dc_caps(len(env[key][0]), n_regions, frac or 1.0)
    if frac is None:
        caps[:] = np.inf
    out = []
    for m, pol, pl, router, cfg, inf, kw in (
            (r_ci, r_pol, r_pl, r_router, env["r_cfg"], env["r_inf"], {}),
            (t_ci, t_pol, t_pl, t_router, env["t_cfg"], env["t_inf"],
             dict(device=CPU))):
        grid = None if grid_fn is None else grid_fn(m, **kw)
        policy = None if pol_fn is None else pol_fn(pol, pl, inf, caps)
        out.append(router.FleetRouter(cfg, grid=grid, policy=policy, **kw))
    return out[0], out[1], env[key]


class TestFleetParity:
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_route_stream(self, env, name):
        r_fr, t_fr, stream = _routers(env, name)
        r_res, r_st, t_res, t_st = route_both(r_fr, t_fr, stream)
        assert_results_equal(r_res, t_res, r_st, t_st)
        assert t_res.target.dtype == torch.int32
        assert (int(t_res.counts.sum()) + int(t_res.shed_count)
                == len(stream[0]))
        if name in ("xregion", "tier-spill", "mesoscale-sparse"):
            assert int(t_res.shed_count) > 0  # the caps bind
        if name.startswith("xregion") or name == "mesoscale-sparse":
            assert int(t_res.spilled_count) > 0

    def test_env_at_and_scalar_router(self, env):
        r_fr = r_router.FleetRouter(env["r_cfg"])
        t_fr = t_router.FleetRouter(env["t_cfg"], device=CPU)
        r_gs = r_router.GreenScaleRouter(env["r_cfg"])
        t_gs = t_router.GreenScaleRouter(env["t_cfg"], device=CPU)
        batch, region, t_hours = env["stream"]
        res = t_fr.route_stream(torch_batch(batch), region, t_hours)
        for i in range(0, 400, 37):
            r, h = int(region[i]), int(np.floor(t_hours[i]))
            np.testing.assert_allclose(host(t_fr.env_at(r, h + 24).ci),
                                       np.asarray(r_fr.env_at(r, h).ci),
                                       rtol=RTOL)
            req = t_router.Request(
                prompt_tokens=int(batch.prompt_tokens[i]),
                max_new_tokens=int(batch.max_new_tokens[i]),
                latency_budget_s=float(batch.latency_budget_s[i]),
                available=tuple(bool(x) for x in batch.available[i]))
            dec = t_gs.route(req, t_fr.env_at(r, h))
            assert dec.target == int(res.target[i])
            assert dec.target == r_gs.route(
                r_router.Request(**dataclasses.asdict(req)),
                r_fr.env_at(r, h)).target

    def test_result_properties(self, env):
        r_fr, t_fr, stream = _routers(env, "xregion")
        r_res, _, t_res, _ = route_both(r_fr, t_fr, stream)
        for p in ("saved_vs_latency_g", "saved_vs_energy_g",
                  "extra_vs_oracle_g", "qos_violation_rate", "shed_rate",
                  "spill_rate", "defer_rate"):
            np.testing.assert_allclose(float(getattr(t_res, p)),
                                       float(getattr(r_res, p)),
                                       rtol=1e-4, atol=1e-7, err_msg=p)


class TestPortEqualities:
    def test_identity_adjacency_equals_capacity_limiter(self, env):
        batch, region, t_hours = env["stream"]
        caps = dc_caps(N, 4, 0.4)
        inf = env["t_inf"]
        out = []
        for pol in (t_pol.CapacityLimiter(t_pol.OraclePolicy(inf), caps),
                    t_pl.PlacementPolicy(t_pol.OraclePolicy(inf), caps)):
            fr = t_router.FleetRouter(env["t_cfg"], policy=pol, device=CPU)
            out.append(fr.route_stream_with_state(torch_batch(batch), region,
                                                  t_hours))
        (a, sa), (b, sb) = out
        for f in ("target", "counts", "shed_count", "exec_region"):
            np.testing.assert_array_equal(host(getattr(a, f)),
                                          host(getattr(b, f)), err_msg=f)
        np.testing.assert_array_equal(host(sa.shed), host(sb.shed))
        np.testing.assert_array_equal(host(sa.counts), host(sb.counts))
        assert float(a.total_carbon_g) == float(b.total_carbon_g)

    @pytest.mark.parametrize("frac", [0.4, None])
    def test_dense_equals_sparse(self, env, frac):
        caps = dc_caps(N, 4, frac or 1.0)
        if frac is None:
            caps[:] = np.inf
        dense = _fc(t_ci, rtt_s=0.5, device=CPU)
        res = []
        for grid in (dense, dense.with_sparse_neighbors()):
            fr = t_router.FleetRouter(
                env["t_cfg"], grid=grid, device=CPU,
                policy=t_pl.PlacementPolicy(t_pol.OraclePolicy(env["t_inf"]),
                                            caps))
            res.append(fr.route_stream(torch_batch(env["stream"][0]),
                                       *env["stream"][1:]))
        for f in ("target", "exec_region", "counts", "shed_count"):
            np.testing.assert_array_equal(host(getattr(res[0], f)),
                                          host(getattr(res[1], f)))
        assert float(res[0].total_carbon_g) == float(res[1].total_carbon_g)


class TestGreenScaleRouterPolicy:
    """``GreenScaleRouter(policy=...)`` (no longer refused) against the
    reference on one environment."""

    @pytest.mark.parametrize("kind", ["carbon", "latency", "energy",
                                      "capacity", "placement"])
    def test_route_batch_arrays_with_policy(self, env, kind):
        batch = torch_batch(env["stream"][0])
        n = len(batch)
        caps = np.array([[np.inf, n / 60.0, n / 90.0]])
        rgrid = r_ci.CarbonGrid.from_regions(r_ci.DEFAULT_REGIONS[:1])
        tgrid = t_ci.CarbonGrid.from_regions(t_ci.DEFAULT_REGIONS[:1],
                                             device=CPU)
        make = {
            "carbon": lambda pol, pl, inf, g: pol.OraclePolicy(inf),
            "latency": lambda pol, pl, inf, g: pol.OraclePolicy(inf,
                                                                "latency"),
            "energy": lambda pol, pl, inf, g: pol.OraclePolicy(inf, "energy"),
            "capacity": lambda pol, pl, inf, g: pol.CapacityLimiter(
                pol.OraclePolicy(inf), caps),
            "placement": lambda pol, pl, inf, g: pl.PlacementPolicy(
                pol.OraclePolicy(inf), caps, grid=g),
        }[kind]
        r_rt = r_router.GreenScaleRouter(env["r_cfg"])
        r_rt.policy = make(r_pol, r_pl, r_rt.infra, rgrid)
        t_rt = t_router.GreenScaleRouter(env["t_cfg"], device=CPU)
        t_rt.policy = make(t_pol, t_pl, t_rt.infra, tgrid)
        hour = np.floor(env["stream"][2]).astype(np.float32)
        for h in (3, 19):
            r_out = r_rt.route_batch_arrays(env["stream"][0], r_env_at_hour(h),
                                            hour=hour)
            t_out = t_rt.route_batch_arrays(batch, t_env_at_hour(h,
                                                                 device=CPU),
                                            hour=hour)
            for f in ("target", "target_latency", "target_energy", "ok"):
                np.testing.assert_array_equal(host(getattr(t_out, f)),
                                              np.asarray(getattr(r_out, f)),
                                              err_msg=f)
            np.testing.assert_allclose(host(t_out.total_cf),
                                       np.asarray(r_out.total_cf), rtol=RTOL)

    def test_route_batch_with_default_policy_equals_oracle(self, env):
        t_cfg = env["t_cfg"]
        reqs = [t_router.Request(prompt_tokens=p, max_new_tokens=64,
                                 latency_budget_s=b)
                for p, b in ((64, 0.5), (3000, 20.0), (700, 2.0))]
        e = t_env_at_hour(12, device=CPU)
        plain = t_router.GreenScaleRouter(t_cfg, device=CPU)
        oracle = t_router.GreenScaleRouter(
            t_cfg, device=CPU, policy=t_pol.OraclePolicy(plain.infra))
        assert plain.route_batch(reqs, e) == oracle.route_batch(reqs, e)


class _TierStub:
    """An engine for ``admit_windows``: only the tier matters."""

    admit = ServeEngine.admit

    def __init__(self, tier):
        self.tier = tier


class TestAdmissionAndRefusals:
    def test_admit_windows_partitions_the_tier(self, env):
        r_fr, t_fr, stream = _routers(env, "xregion")
        batch, region, t_hours = stream
        res = t_fr.route_stream(torch_batch(batch), region, t_hours)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            wins = t_fr.admit_windows(res, t_hours, _TierStub(1))
        assert len(wins) == 24
        got = np.sort(np.concatenate(wins))
        np.testing.assert_array_equal(got,
                                      np.nonzero(host(res.target) == 1)[0])
        for h, idx in enumerate(wins):
            assert (np.floor(t_hours[idx]).astype(int) % 24 == h).all()

    def test_not_ported_paths_raise(self, env, tmp_path):
        cfg, inf = env["t_cfg"], env["t_inf"]
        fr = t_router.FleetRouter(cfg, device=CPU)
        b, reg, th = env["stream"]
        # the sharded path is ported (tests/test_torch_distributed.py): a
        # mesh, on the router or on the call, routes the same decisions
        want = fr.route_stream(torch_batch(b), reg, th)
        with tdp.one_rank_world(str(tmp_path)) as mesh:
            for got in (t_router.FleetRouter(cfg, device=CPU, mesh=mesh)
                        .route_stream(torch_batch(b), reg, th),
                        fr.route_stream(torch_batch(b), reg, th, mesh=mesh)):
                for f in ("target", "exec_region", "counts", "carbon_g"):
                    np.testing.assert_array_equal(host(getattr(got, f)),
                                                  host(getattr(want, f)))
        # the serving loop is ported: the rolling planner refuses only a policy
        # that cannot defer, and admit_windows(queue=) delegates
        with pytest.raises(ValueError, match="TemporalPolicy"):
            fr.route_stream_rolling(torch_batch(b), reg, th)
        k = 500
        head = dataclasses.replace(torch_batch(b), **{
            f: getattr(b, f)[:k] for f in ("prompt_tokens", "max_new_tokens",
                                           "latency_budget_s",
                                           "bytes_per_token", "available")})
        served = t_q.serve_stream(fr, head, reg[:k], th[:k])
        got = fr.admit_windows(None, None, _TierStub(1), queue=served)
        want = t_q.admit_batches(served, _TierStub(1))
        assert len(got) == len(want) > 0
        for a, c in zip(got, want):
            np.testing.assert_array_equal(a, c)
        # policies of another package are refused
        with pytest.raises(NotImplementedError, match="RoutingPolicy"):
            t_router.GreenScaleRouter(cfg, policy=object(), device=CPU)
        with pytest.raises(NotImplementedError, match="RoutingPolicy"):
            t_router.FleetRouter(cfg, device=CPU,
                                 policy=r_pol.OraclePolicy(env["r_inf"]))
        pol = t_pl.PlacementPolicy(t_pol.OraclePolicy(inf), dc_caps(N, 4, 1))
        t_router.FleetRouter(cfg, device=CPU, policy=pol)
        w = torch_batch(b).workload(cfg, device=CPU)
        args = (w, fr.env_at(0, 0), torch.ones((N, 3), dtype=bool),
                pol.initial_state(4, N))
        want, _ = pol.decide(*args)
        (tmp_path / "decide").mkdir()
        with tdp.one_rank_world(str(tmp_path / "decide")) as mesh:
            got, _ = pol.decide(*args, axis_name=mesh.get_group())
        np.testing.assert_array_equal(host(got), host(want))

    def test_validation(self, env):
        cfg, inf = env["t_cfg"], env["t_inf"]
        with pytest.raises(ValueError):
            t_pl.PlacementPolicy(t_pol.OraclePolicy(inf), np.ones((4, 2)))
        with pytest.raises(ValueError):
            t_pol.OraclePolicy(inf, "water")
        with pytest.raises(ValueError):  # policy caps cover 3 regions
            t_router.FleetRouter(cfg, device=CPU, policy=t_pl.PlacementPolicy(
                t_pol.OraclePolicy(inf), np.ones((3, 3))))
        with pytest.raises(ValueError):  # a grid that disagrees
            t_router.FleetRouter(
                cfg, device=CPU, grid=_fc(t_ci, device=CPU),
                policy=t_pl.PlacementPolicy(t_pol.OraclePolicy(inf),
                                            np.ones((4, 3)),
                                            grid=t_ci.CarbonGrid.from_regions(
                                                device=CPU)))
        with pytest.raises(ValueError):  # sparse needs the factorized scorer
            t_pl.PlacementPolicy(
                t_pol.OraclePolicy(inf), np.ones((8, 3)), factorized=False,
                grid=t_ci.CarbonGrid.from_sites(8, 2, device=CPU))
        with pytest.raises(ValueError):  # no grid bound
            t_pl.PlacementPolicy(t_pol.OraclePolicy(inf),
                                 np.ones((4, 3))).initial_state(4, 10)
        with pytest.raises(ValueError):
            t_router.FleetRouter(cfg, device=CPU,
                                 regions=t_ci.DEFAULT_REGIONS[:2],
                                 grid=_fc(t_ci, device=CPU))
        meso = t_router.FleetRouter(
            cfg, device=CPU, grid=t_ci.CarbonGrid.from_sites(9, 2, device=CPU))
        assert meso.regions == t_ci.site_regions(9)


class _FixedScores(t_pol.RoutingPolicy):
    """An inner policy with given (N, 3) scores."""

    def __init__(self, s):
        self.s = s

    def scores(self, w, env, avail, *, hour=None):
        return self.s


class TestNanScores:
    """A NaN score is never picked (argmin would take it, argsort ranks it
    last): every decide path reads it as +inf."""

    NAN = float("nan")

    def test_nan_candidates_are_infeasible(self, env):
        nan, inf = self.NAN, float("inf")
        s = torch.tensor([[nan, 2.0, 1.0], [3.0, nan, 4.0], [nan] * 3,
                          [nan, inf, 5.0]])
        want = [2, 0, 0, 2]  # an all-NaN row is unroutable: MOBILE, unshed
        n = s.shape[0]
        batch = dataclasses.replace(
            torch_batch(env["stream"][0]),
            **{f: getattr(env["stream"][0], f)[:n]
               for f in ("prompt_tokens", "max_new_tokens",
                         "latency_budget_s", "bytes_per_token",
                         "available")})
        w = batch.workload(env["t_cfg"], device=CPU)
        e = t_env_at_hour(0, device=CPU)
        avail = torch.ones((n, 3), dtype=torch.bool)
        grid = t_ci.CarbonGrid.from_regions(t_ci.DEFAULT_REGIONS[:1],
                                            device=CPU)
        caps = np.full((1, 3), np.inf)
        zeros = torch.zeros(n, dtype=torch.long)
        inner = _FixedScores(s)
        for pol in (inner, t_pol.CapacityLimiter(inner, caps),
                    t_pl.PlacementPolicy(inner, caps, grid=grid)):
            got, st = pol.decide(w, e, avail, pol.initial_state(1, n),
                                 region=zeros, hour=zeros)
            assert host(got).tolist() == want, pol.name
            if st != ():
                assert not host(st.shed).any()

    def test_nan_divergence_from_the_bare_reference_policy(self, env):
        """The port's guard differs from the reference on purpose: the
        reference's bare ``RoutingPolicy.decide`` takes ``argmin`` and
        picks the NaN candidate, [0, 1, 0, 0], while its
        ``CapacityLimiter`` and ``PlacementPolicy`` never pick it,
        [2, 0, 0, 2]; the port gives [2, 0, 0, 2] on all three."""
        import jax.numpy as jnp

        nan, inf = self.NAN, float("inf")
        rows = [[nan, 2.0, 1.0], [3.0, nan, 4.0], [nan] * 3,
                [nan, inf, 5.0]]
        n = len(rows)

        class RFixed(r_pol.RoutingPolicy):
            def scores(self, w, env_, avail, *, hour=None):
                return jnp.asarray(rows, jnp.float32)

        batch = dataclasses.replace(
            env["stream"][0],
            **{f: getattr(env["stream"][0], f)[:n]
               for f in ("prompt_tokens", "max_new_tokens",
                         "latency_budget_s", "bytes_per_token",
                         "available")})
        r_w = batch.workload(env["r_cfg"])
        r_e = r_env_at_hour(0)
        r_avail = jnp.ones((n, 3), bool)
        zeros = jnp.zeros(n, jnp.int32)
        caps = np.full((1, 3), np.inf)
        r_grid = r_ci.CarbonGrid.from_regions(r_ci.DEFAULT_REGIONS[:1])
        inner = RFixed()
        got = {}
        for name, pol in (("bare", inner),
                          ("capacity", r_pol.CapacityLimiter(inner, caps)),
                          ("placement", r_pl.PlacementPolicy(
                              inner, caps, grid=r_grid))):
            t, _ = pol.decide(r_w, r_e, r_avail, pol.initial_state(1, n),
                              region=zeros, hour=zeros)
            got[name] = np.asarray(t).tolist()
        assert got == {"bare": [0, 1, 0, 0], "capacity": [2, 0, 0, 2],
                       "placement": [2, 0, 0, 2]}
        t_w = torch_batch(batch).workload(env["t_cfg"], device=CPU)
        t_inner = _FixedScores(torch.tensor(rows))
        t_got, _ = t_inner.decide(t_w, t_env_at_hour(0, device=CPU),
                                  torch.ones((n, 3), dtype=torch.bool), (),
                                  region=torch.zeros(n, dtype=torch.long),
                                  hour=torch.zeros(n, dtype=torch.long))
        assert host(t_got).tolist() == got["capacity"] != got["bare"]
