"""The port's design space, schedulers and ``LearnedPolicy`` against the
JAX reference, on the CPU, on a reduced design space (every axis but the
hours: 0, 8 and 16; 13 workloads, 3 x 2 x 2 x 2 x 2 x 4 x 3 scenarios).

- ``build_scenarios`` / ``explore``: the tables equal the reference's
  (integers exactly, floats within rtol 1e-5; the CI columns differ by an
  ulp where the port's grid traces round differently), every decision
  exactly.
- ``build_dataset``: labels exactly, features within 1e-6.
- Schedulers: from the reference's fitted params (``load_fitted_params``)
  the port's ``torch_scores`` equal the reference's ``jax_scores`` within
  rtol 1e-5 / atol 1e-6 and decide identically. Fitted independently, the
  decisions are identical and the RL fits (float64 numpy in both) agree
  within the same bar; the ridge and GP fits of both packages solve float32
  systems (the ridge ones ill-conditioned), so their scores are held to a
  float64 solve of the same equations instead: the port's error may not
  exceed the reference's own.
- ``LearnedPolicy`` routes as a sweep, inside ``PlacementPolicy`` (the
  CI-linear sensitivity path and the per-region path) and as the
  ``TemporalPolicy`` scorer, with the reference's decisions exactly and
  carbon within rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core import carbon_intensity as r_ci  # noqa: E402
from repro.core import design_space as r_ds  # noqa: E402
from repro.core import infrastructure as r_inf  # noqa: E402
from repro.core import schedulers as r_sch  # noqa: E402
from repro.core import workloads as r_wl  # noqa: E402
from repro.serve import placement as r_pl  # noqa: E402
from repro.serve import policy as r_pol  # noqa: E402
from repro.serve import router as r_router  # noqa: E402
from repro.serve import streams as r_streams  # noqa: E402
from repro.serve import temporal as r_tmp  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.core import design_space as t_ds  # noqa: E402
from repro_torch.core import infrastructure as t_inf  # noqa: E402
from repro_torch.core import schedulers as t_sch  # noqa: E402
from repro_torch.core import workloads as t_wl  # noqa: E402
from repro_torch.core.carbon_model import Environment  # noqa: E402
from repro_torch.serve import placement as t_pl  # noqa: E402
from repro_torch.serve import policy as t_pol  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402
from repro_torch.serve import temporal as t_tmp  # noqa: E402

from torch_fleet_parity import (  # noqa: E402
    ARCH,
    CPU,
    RTOL,
    assert_results_equal,
    dc_caps,
    route_both,
)

HOURS = (0, 8, 16)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
N = 3000


@pytest.fixture(scope="module")
def space():
    r_tab = r_ds.build_scenarios(r_inf.paper_fleet(),
                                 r_ds.ScenarioAxes(hours=HOURS))
    t_tab = t_ds.build_scenarios(t_inf.paper_fleet(),
                                 t_ds.ScenarioAxes(hours=HOURS), device=CPU)
    r_res = r_ds.explore(r_wl.ALL_PAPER_WORKLOADS, r_tab)
    t_res = t_ds.explore(t_wl.ALL_PAPER_WORKLOADS, t_tab)
    r_set = r_sch.build_dataset(r_wl.ALL_PAPER_WORKLOADS, r_res, r_tab)
    t_set = t_sch.build_dataset(t_wl.ALL_PAPER_WORKLOADS, t_res, t_tab)
    return dict(r_tab=r_tab, t_tab=t_tab, r_res=r_res, t_res=t_res,
                r_set=r_set, t_set=t_set, r_split=r_set.split(),
                t_split=t_set.split())


class TestDesignSpace:
    def test_axes_and_rows(self, space):
        assert t_ds.ScenarioAxes().grid_size() == \
            r_ds.ScenarioAxes().grid_size()
        assert t_ds.ScenarioAxes(hours=HOURS).grid_size() == \
            len(space["t_tab"].rows)
        assert space["t_tab"].rows == space["r_tab"].rows
        assert t_ds.CARBON_FREE_CI == r_ds.CARBON_FREE_CI
        assert t_ds.RURAL_EXTRA_EDGE_LATENCY_S == \
            r_ds.RURAL_EXTRA_EDGE_LATENCY_S

    def test_stacked_tables(self, space):
        r_tab, t_tab = space["r_tab"], space["t_tab"]
        np.testing.assert_allclose(t_tab.envs.ci.numpy(),
                                   np.asarray(r_tab.envs.ci), rtol=RTOL)
        for f in ("interference", "net_slowdown"):
            np.testing.assert_array_equal(getattr(t_tab.envs, f).numpy(),
                                          np.asarray(getattr(r_tab.envs, f)))
        for name in ("infras", "infras_jetson"):
            r_i, t_i = getattr(r_tab, name), getattr(t_tab, name)
            for f in dataclasses.fields(t_i):
                np.testing.assert_array_equal(
                    getattr(t_i, f.name).numpy(),
                    np.asarray(getattr(r_i, f.name)), err_msg=f.name)

    def test_explore_tables_and_decisions(self, space):
        r_res, t_res = space["r_res"], space["t_res"]
        assert t_res.workload_names == r_res.workload_names
        assert t_res.n_points == r_res.n_points
        for f in ("total_cf", "op_cf", "emb_cf", "energy_j", "latency"):
            np.testing.assert_allclose(getattr(t_res, f),
                                       getattr(r_res, f), rtol=RTOL,
                                       atol=0, err_msg=f)
        for f in ("feasible", "carbon_opt", "energy_opt", "latency_opt"):
            got, want = getattr(t_res, f), getattr(r_res, f)
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)

    def test_scenario_mask(self, space):
        rows = space["t_tab"].rows
        for conds in ({"hour": 8}, {"embodied": "lca",
                                    "variance": "COLOCATED"},
                      {"dc_carbon_free": True, "edge_location": "RURAL"}):
            np.testing.assert_array_equal(t_ds.scenario_mask(rows, **conds),
                                          r_ds.scenario_mask(rows, **conds))

    def test_paper_fleet_without_jetson_and_tpu_fleet(self):
        """``tpu_fleet`` has no AR/VR device: one infra stack only."""
        axes = dict(hours=(12,), charging=(r_ci.ChargingBehavior.AVERAGE,))
        r_tab = r_ds.build_scenarios(r_inf.tpu_fleet(),
                                     r_ds.ScenarioAxes(**axes))
        t_tab = t_ds.build_scenarios(
            t_inf.tpu_fleet(),
            t_ds.ScenarioAxes(hours=(12,),
                              charging=(t_ci.ChargingBehavior.AVERAGE,)),
            device=CPU)
        assert r_tab.infras_jetson is None and t_tab.infras_jetson is None
        infos = (r_wl.AI_WORKLOADS, t_wl.AI_WORKLOADS)
        r_res = r_ds.explore(infos[0], r_tab)
        t_res = t_ds.explore(infos[1], t_tab)
        np.testing.assert_array_equal(t_res.carbon_opt, r_res.carbon_opt)
        np.testing.assert_allclose(t_res.total_cf, r_res.total_cf, rtol=RTOL)


class TestDataset:
    def test_build_dataset(self, space):
        r, t = space["r_set"], space["t_set"]
        np.testing.assert_array_equal(t.labels, r.labels)
        np.testing.assert_allclose(t.features, r.features, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(t.feat_mean, r.feat_mean, rtol=RTOL)
        np.testing.assert_allclose(t.feat_std, r.feat_std, rtol=RTOL)
        np.testing.assert_array_equal(t.feasible, r.feasible)
        for f in ("total_cf", "energy", "latency"):
            np.testing.assert_allclose(getattr(t, f), getattr(r, f),
                                       rtol=RTOL, err_msg=f)

    def test_split(self, space):
        (rtr, rte), (ttr, tte) = space["r_split"], space["t_split"]
        np.testing.assert_array_equal(ttr.labels, rtr.labels)
        np.testing.assert_array_equal(tte.labels, rte.labels)
        assert len(ttr.labels) + len(tte.labels) == len(
            space["t_set"].labels)


def _schedulers():
    """(id, reference scheduler, port scheduler), small BO/RL budgets."""
    return [
        ("regression", r_sch.RegressionScheduler(),
         t_sch.RegressionScheduler()),
        ("classification", r_sch.ClassificationScheduler(),
         t_sch.ClassificationScheduler()),
        ("classification-headless",
         r_sch.ClassificationScheduler(carbon_head=False),
         t_sch.ClassificationScheduler(carbon_head=False)),
        ("bo", r_sch.BOScheduler(budget=10), t_sch.BOScheduler(budget=10)),
        ("rl", r_sch.RLScheduler(episodes=2), t_sch.RLScheduler(episodes=2)),
        ("energy-aware", r_sch.EnergyAwareScheduler(episodes=2),
         t_sch.EnergyAwareScheduler(episodes=2)),
    ]


SCHEDULERS = {k: (r, t) for k, r, t in _schedulers()}
SOLVED = ("regression", "classification", "classification-headless",
          "bo")


@pytest.fixture(scope="module")
def fits(space):
    """Each scheduler fitted once per package on its own train split."""
    (rtr, _), (ttr, _) = space["r_split"], space["t_split"]
    out = {}
    for key, (r_s, t_s) in SCHEDULERS.items():
        r_p = {k: np.asarray(v) for k, v in r_s.fit_params(rtr).items()}
        out[key] = (r_p, t_sch.load_fitted_params(t_s.fit_params(ttr),
                                                  device=CPU))
    return out


def _f64_params(key, train, t_p) -> dict:
    """The float32 solves of a fit redone in float64: the ridge
    schedulers' normal equations, or the GP weights on the port's own
    support (the same support as the reference's, ``test_bo_picks_the_
    reference_support``)."""
    X = train.features.astype(np.float64)
    log = lambda a: np.log(a.astype(np.float64) + 1e-9)
    if key == "bo":
        idx = t_p["idx"].numpy()
        y = log(train.total_cf)
        y = (y - y.mean(0)) / np.maximum(y.std(0), 1e-9)
        Xc = X[idx]
        d2 = ((Xc[:, None] - Xc[None]) ** 2).sum(-1)
        K = np.exp(-0.5 * d2 / float(t_p["ls"]) ** 2) + 1e-2 * np.eye(len(idx))
        return dict(t_p, alpha=np.linalg.solve(K, y[idx]), support=Xc)
    Xb = np.concatenate([X, np.ones((len(X), 1))], axis=1)
    d = Xb.shape[1]
    if key == "regression":
        gram = Xb.T @ Xb + 1e-3 * np.eye(d)
        return {"W_cf": np.linalg.solve(gram, Xb.T @ log(train.total_cf)),
                "W_lat": np.linalg.solve(gram, Xb.T @ log(train.latency))}
    gram = Xb.T @ Xb + 1e-2 * len(Xb) * np.eye(d)
    out = {"W": np.linalg.solve(gram, Xb.T @ (2.0 * np.eye(3)[train.labels]
                                              - 1.0))}
    if key == "classification":
        out["W_cf"] = np.linalg.solve(gram, Xb.T @ log(train.total_cf))
        out["head_w"] = np.float32(1.0)
    return out


class TestSchedulers:
    @pytest.mark.parametrize("key", list(SCHEDULERS))
    def test_scores_from_the_reference_params(self, space, fits, key):
        r_s, t_s = SCHEDULERS[key]
        X = space["r_split"][1].features
        r_p, _ = fits[key]
        want = np.asarray(type(r_s).jax_scores(
            jax.tree.map(jnp.asarray, r_p), jnp.asarray(X)))
        got = type(t_s).torch_scores(t_sch.load_fitted_params(r_p,
                                                              device=CPU),
                                     torch.from_numpy(X)).numpy()
        np.testing.assert_allclose(got, want, **SCORE_TOL)
        np.testing.assert_array_equal(got.argmin(1), want.argmin(1))

    @pytest.mark.parametrize("key", list(SCHEDULERS))
    def test_independent_fit_decides_identically(self, space, fits, key):
        r_s, t_s = SCHEDULERS[key]
        X_r, X_t = space["r_split"][1].features, space["t_split"][1].features
        r_p, t_p = fits[key]
        want = np.asarray(type(r_s).jax_scores(
            jax.tree.map(jnp.asarray, r_p), jnp.asarray(X_r)))
        got = type(t_s).torch_scores(t_p, torch.from_numpy(X_t)).numpy()
        np.testing.assert_array_equal(got.argmin(1), want.argmin(1))
        if key in SOLVED:
            # both packages solve the same float32 systems (the ridge ones
            # ill-conditioned); the port's fit is held to no more error
            # against a float64 solve than the reference's own
            truth = type(t_s).torch_scores(
                t_sch.load_fitted_params(
                    _f64_params(key, space["t_split"][0], t_p), device=CPU),
                torch.from_numpy(X_t)).numpy()
            assert np.abs(got - truth).max() <= np.abs(want - truth).max()
        else:
            assert set(t_p) == set(r_p)
            for k in r_p:
                np.testing.assert_allclose(t_p[k].double().numpy(),
                                           r_p[k].astype(np.float32),
                                           **SCORE_TOL, err_msg=k)
            np.testing.assert_allclose(got, want, **SCORE_TOL)

    @pytest.mark.parametrize("key", list(SCHEDULERS) + ["oracle"])
    def test_evaluate_scheduler(self, space, key):
        (rtr, rte), (ttr, tte) = space["r_split"], space["t_split"]
        if key == "oracle":
            r_s, t_s = r_sch.OracleScheduler(), t_sch.OracleScheduler()
        else:
            r_s, t_s = SCHEDULERS[key]
        r_e = r_sch.evaluate_scheduler(r_s, rtr, rte)
        t_e = t_sch.evaluate_scheduler(t_s, ttr, tte)
        assert t_e.name == r_e.name
        assert t_e.accuracy == r_e.accuracy
        assert t_e.qos_violation_rate == r_e.qos_violation_rate
        np.testing.assert_allclose(t_e.cf_degradation, r_e.cf_degradation,
                                   rtol=RTOL, atol=1e-9)
        assert (t_e.train_flops, t_e.flops_per_decision) == (
            r_e.train_flops, r_e.flops_per_decision)

    def test_bo_picks_the_reference_support(self, fits):
        r_p, t_p = fits["bo"]
        np.testing.assert_array_equal(t_p["idx"].numpy(), r_p["idx"])

    def test_load_fitted_params(self, fits):
        r_p, _ = fits["bo"]
        p = t_sch.load_fitted_params(r_p, device=CPU)
        assert p["alpha"].dtype == torch.float32
        assert p["idx"].dtype == torch.int32
        rl = t_sch.load_fitted_params(fits["rl"][0], device=CPU)
        assert fits["rl"][0]["W"].dtype == np.float64
        assert rl["W"].dtype == torch.float32
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                t_sch.load_fitted_params(r_p)


# ---------------------------------------------------------------------------
# LearnedPolicy
# ---------------------------------------------------------------------------


def _port_policy(r_lp, t_sched, infra):
    """The port's LearnedPolicy holding a reference policy's params,
    statistics and probed sensitivities."""
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    return t_pol.LearnedPolicy(
        params=t_sch.load_fitted_params(
            {k: np.asarray(v) for k, v in r_lp.params.items()}, device=CPU),
        score_fn=type(t_sched).torch_scores, feat_mean=f32(r_lp.feat_mean),
        feat_std=f32(r_lp.feat_std), emb_lca=r_lp.emb_lca, name=r_lp.name,
        infra=infra,
        ci_sens=None if r_lp.ci_sens is None else f32(r_lp.ci_sens))


@pytest.fixture(scope="module")
def env(space):
    r_cfg, t_cfg = r_get_config(ARCH), t_get_config(ARCH)
    r_base = r_router.FleetRouter(r_cfg)
    t_base = t_router.FleetRouter(t_cfg, device=CPU)
    train = space["r_split"][0]
    lp = {key: r_pol.LearnedPolicy.fit(SCHEDULERS[key][0], train,
                                       infra=r_base.infra)
          for key in ("classification", "regression")}
    return dict(r_cfg=r_cfg, t_cfg=t_cfg, r_inf=r_base.infra,
                t_inf=t_base.infra, r_lp=lp,
                t_lp={k: _port_policy(v, SCHEDULERS[k][1], t_base.infra)
                      for k, v in lp.items()},
                stream=r_streams.multi_region_stream(N, 4),
                deferrable=r_streams.deferrable_stream(N, 4))


class TestLearnedPolicy:
    def test_fit_probes_the_reference_sensitivities(self, space, env):
        """The port's probe on the reference's params gives the reference's
        ``ci_sens``; only CI-linear schedulers get one."""
        r_lp = env["r_lp"]["classification"]
        t_lp = env["t_lp"]["classification"]
        n = t_lp.feat_mean.shape[0]
        probes = torch.cat([torch.zeros((1, n)), torch.eye(n)])
        s = t_lp.score_fn(t_lp.params, probes)
        np.testing.assert_allclose((s[1:] - s[:1]).numpy(),
                                   np.asarray(r_lp.ci_sens), **SCORE_TOL)
        own = t_pol.LearnedPolicy.fit(t_sch.ClassificationScheduler(),
                                      space["t_split"][0], device=CPU)
        assert own.name == r_lp.name == "learned-classification"
        assert own.ci_sens.shape == r_lp.ci_sens.shape
        reg = t_pol.LearnedPolicy.fit(t_sch.RegressionScheduler(),
                                      space["t_split"][0], device=CPU)
        assert reg.ci_sens is None and env["r_lp"]["regression"].ci_sens \
            is None

    def test_fit_requires_feature_stats(self, space):
        bare = dataclasses.replace(space["t_split"][0], feat_mean=None,
                                   feat_std=None)
        with pytest.raises(ValueError, match="feature statistics"):
            t_pol.LearnedPolicy.fit(t_sch.RegressionScheduler(), bare,
                                    device=CPU)

    def test_feature_rows_match_the_reference(self, space):
        from repro.serve.policy import feature_rows as r_rows

        tab = space["t_tab"]
        k = 96
        rng = np.random.default_rng(3)
        flops = rng.uniform(1e6, 1e14, k)
        r_w = r_wl.batch_workloads(flops=flops, mem_bytes=flops / 3,
                                   data_in=rng.uniform(1, 1e6, k),
                                   data_out=rng.uniform(1, 1e6, k),
                                   latency_req=rng.uniform(0.01, 10, k),
                                   continuous=rng.integers(0, 2, k))
        t_w = t_wl.Workload(*[torch.from_numpy(np.array(getattr(r_w, f.name)))
                              for f in dataclasses.fields(t_wl.Workload)])
        ci = np.asarray(space["r_tab"].envs.ci)[:k]
        hour = rng.integers(0, 72, k).astype(np.float32)
        interf, net = np.array([1.5, 1.2, 1.0]), np.array([2.0, 1.0])
        for emb in (False, True):
            want = np.asarray(r_rows(r_w, jnp.asarray(ci), jnp.asarray(interf),
                                     jnp.asarray(net), jnp.asarray(hour),
                                     emb))
            got = t_pol.feature_rows(t_w, torch.from_numpy(ci),
                                     torch.from_numpy(interf),
                                     torch.from_numpy(net),
                                     torch.from_numpy(hour), emb).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        # policy_features is feature_rows of an Environment
        e = Environment(ci=tab.envs.ci[:k], interference=tab.envs.interference[0],
                        net_slowdown=tab.envs.net_slowdown[0])
        np.testing.assert_array_equal(
            t_pol.policy_features(t_w, e).numpy(),
            t_pol.feature_rows(t_w, tab.envs.ci[:k], e.interference,
                               e.net_slowdown).numpy())

    @pytest.mark.parametrize("key", ["classification", "regression"])
    def test_sweep(self, env, key):
        r_fr = r_router.FleetRouter(env["r_cfg"], policy=env["r_lp"][key])
        t_fr = t_router.FleetRouter(env["t_cfg"], policy=env["t_lp"][key],
                                    device=CPU)
        assert_results_equal(*route_both(r_fr, t_fr, env["stream"])[::2])

    @pytest.mark.parametrize("key", ["classification", "regression"])
    def test_placement(self, env, key):
        """CI-linear (the sensitivity sum) and per-region scoring inside
        cross-region placement under binding caps."""
        caps = dc_caps(N, 4, 0.4)
        grids = (r_ci.CarbonGrid.fully_connected(latency_penalty=1.05),
                 t_ci.CarbonGrid.fully_connected(latency_penalty=1.05,
                                                 device=CPU))
        r_fr = r_router.FleetRouter(env["r_cfg"], grid=grids[0],
                                    policy=r_pl.PlacementPolicy(
                                        env["r_lp"][key], caps))
        t_fr = t_router.FleetRouter(env["t_cfg"], grid=grids[1],
                                    policy=t_pl.PlacementPolicy(
                                        env["t_lp"][key], caps), device=CPU)
        r_res, r_st, t_res, t_st = route_both(r_fr, t_fr, env["stream"])
        assert_results_equal(r_res, t_res, r_st, t_st)
        assert int(t_res.spilled_count) > 0

    def test_temporal_scorer(self, env):
        caps = dc_caps(N, 4, 0.6)
        grids = (r_ci.CarbonGrid.fully_connected(latency_penalty=1.05),
                 t_ci.CarbonGrid.fully_connected(latency_penalty=1.05,
                                                 device=CPU))
        r_fr = r_router.FleetRouter(env["r_cfg"], grid=grids[0],
                                    policy=r_tmp.TemporalPolicy(
                                        env["r_lp"]["classification"], caps,
                                        max_defer_h=8))
        t_fr = t_router.FleetRouter(env["t_cfg"], grid=grids[1],
                                    policy=t_tmp.TemporalPolicy(
                                        env["t_lp"]["classification"], caps,
                                        max_defer_h=8), device=CPU)
        r_res, r_st, t_res, t_st = route_both(r_fr, t_fr, env["deferrable"])
        assert_results_equal(r_res, t_res, r_st, t_st)
        assert int(t_res.deferred_count) > 0

    def test_to_moves_every_tensor(self, env):
        lp = env["t_lp"]["classification"].to(CPU)
        assert lp.ci_sens.device.type == "cpu"
        assert all(v.device.type == "cpu" for v in lp.params.values())

    def test_router_refuses_a_policy_of_another_package(self, env):
        with pytest.raises(NotImplementedError, match="RoutingPolicy"):
            t_router.FleetRouter(env["t_cfg"],
                                 policy=env["r_lp"]["classification"],
                                 device=CPU)
