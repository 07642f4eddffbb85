"""The port's online policy refit (``serve/online.py``) against the JAX
reference, on the CPU: the ``ReplayBuffer``'s FIFO eviction and fresh
standardization; the static learned policy (the reference's fitted params,
carried over with ``load_fitted_params``) serving a two-day deferrable
stream through ``serve_stream``; and the refit path, each package refitting
with its own scheduler, whose buffers, refit count and decisions equal the
reference's. Integers exactly, carbon within rtol 1e-5."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core import carbon_intensity as r_ci  # noqa: E402
from repro.core import design_space as r_ds  # noqa: E402
from repro.core import infrastructure as r_inf  # noqa: E402
from repro.core import schedulers as r_sch  # noqa: E402
from repro.core import workloads as r_wl  # noqa: E402
from repro.serve import online as r_online  # noqa: E402
from repro.serve import policy as r_pol  # noqa: E402
from repro.serve import queue as r_q  # noqa: E402
from repro.serve import router as r_router  # noqa: E402
from repro.serve import streams as r_streams  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.core import schedulers as t_sch  # noqa: E402
from repro_torch.serve import online as t_online  # noqa: E402
from repro_torch.serve import policy as t_pol  # noqa: E402
from repro_torch.serve import queue as t_q  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402

from torch_fleet_parity import (  # noqa: E402
    ARCH,
    CPU,
    RTOL,
    assert_served_equal,
    serve_routers,
    torch_batch,
)

R = 4
ONE_SHAPE = 2048  # every draft pads to one shape (one compile a router)


@pytest.fixture(scope="module")
def env():
    r_cfg, t_cfg = r_get_config(ARCH), t_get_config(ARCH)
    return dict(r_cfg=r_cfg, t_cfg=t_cfg,
                r_inf=r_router.FleetRouter(r_cfg).infra,
                t_inf=t_router.FleetRouter(t_cfg, device=CPU).infra)


def _replay_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 19)), rng.integers(0, 3, n),
            rng.uniform(1.0, 2.0, (n, 3)), rng.uniform(size=(n, 3)),
            rng.uniform(size=(n, 3)), rng.random((n, 3)) < 0.8)


class TestReplayBuffer:
    def test_fifo_and_fresh_statistics(self):
        bufs = (r_online.ReplayBuffer(max_rows=100),
                t_online.ReplayBuffer(max_rows=100))
        for i in range(6):
            rows = _replay_rows(20 + i, seed=i)
            for b in bufs:
                b.append(*rows)
        assert len(bufs[1]) == len(bufs[0])
        rd, td = bufs[0].dataset(), bufs[1].dataset()
        for f in dataclasses.fields(td):
            np.testing.assert_array_equal(getattr(td, f.name),
                                          getattr(rd, f.name), err_msg=f.name)
        with pytest.raises(ValueError, match="empty"):
            t_online.ReplayBuffer().dataset()


@pytest.fixture(scope="module")
def learned(env):
    """The static classification policy fitted by the reference on a small
    design space, and the port's policy holding the same params."""
    table = r_ds.build_scenarios(r_inf.paper_fleet(),
                                 r_ds.ScenarioAxes(hours=(0, 8, 16)))
    res = r_ds.explore(r_wl.ALL_PAPER_WORKLOADS, table)
    train = r_sch.build_dataset(r_wl.ALL_PAPER_WORKLOADS, res,
                                table).split()[0]
    r_lp = r_pol.LearnedPolicy.fit(
        r_sch.ClassificationScheduler(carbon_head=False), train,
        infra=env["r_inf"])
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    t_lp = t_pol.LearnedPolicy(
        params=t_sch.load_fitted_params(
            {k: np.asarray(v) for k, v in r_lp.params.items()}, device=CPU),
        score_fn=t_sch.ClassificationScheduler.torch_scores,
        feat_mean=f32(r_lp.feat_mean), feat_std=f32(r_lp.feat_std),
        name=r_lp.name, infra=env["t_inf"], ci_sens=f32(r_lp.ci_sens))
    return r_lp, t_lp


class TestOnlineRefit:
    N = 1200

    def test_refit_serving_matches_the_reference(self, env, learned):
        """The benchmark's refit row, reduced: a two-day deferrable stream,
        temporal deferral on a fully connected two-day grid, twelve-hour
        serve steps (the reference compiles its observation ops for each
        new draft size, so fewer steps keep the test short),
        a first refit after 300 settled requests, then every 500. Each package refits with
        its own scheduler; the buffers, the refit count and every decision
        agree, carbon within rtol 1e-5."""
        n = self.N
        batch, region, t = r_streams.deferrable_stream_multiday(
            n, R, n_days=2)
        grids = (r_ci.CarbonGrid.fully_connected(latency_penalty=1.05,
                                                 n_days=2),
                 t_ci.CarbonGrid.fully_connected(latency_penalty=1.05,
                                                 n_days=2, device=CPU))
        caps = np.full((R, 3), np.inf)
        caps[:, 1] = caps[:, 2] = max(1.0, 0.6 * n / (R * 48))
        r_fr, t_fr = serve_routers(env, "temporal", caps, grids=grids,
                              inner=learned, max_defer_h=16)
        kw = dict(min_observations=300, refit_every=500)
        refitters = (r_online.OnlineRefitter(**kw),
                     t_online.OnlineRefitter(**kw))
        r_res = r_q.serve_stream(r_fr, batch, region, t, step_h=12,
                                 refitter=refitters[0],
                                 former=r_q.BatchFormer(min_pad=ONE_SHAPE))
        t_res = t_q.serve_stream(t_fr, torch_batch(batch), region, t,
                                 step_h=12, refitter=refitters[1],
                                 former=t_q.BatchFormer(min_pad=ONE_SHAPE))
        assert_served_equal(r_res, t_res)
        assert t_res.refits == refitters[1].n_refits >= 2
        assert sum(s.refit for s in t_res.steps) == t_res.refits
        final = refitters[1].router
        assert final.device.type == "cpu" and final is not t_fr
        assert "W_cf" in final.policy.inner.params
        rd, td = refitters[0].buffer.dataset(), refitters[1].buffer.dataset()
        np.testing.assert_array_equal(td.labels, rd.labels)
        np.testing.assert_array_equal(td.feasible, rd.feasible)
        np.testing.assert_allclose(td.total_cf, rd.total_cf, rtol=RTOL)
        np.testing.assert_allclose(td.feat_mean, rd.feat_mean, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(td.features, rd.features, rtol=0,
                                   atol=1e-5)

    def test_static_learned_serving(self, env, learned):
        n = self.N
        batch, region, t = r_streams.deferrable_stream_multiday(
            n, R, n_days=2, seed=1)
        grids = (r_ci.CarbonGrid.fully_connected(latency_penalty=1.05,
                                                 n_days=2),
                 t_ci.CarbonGrid.fully_connected(latency_penalty=1.05,
                                                 n_days=2, device=CPU))
        caps = np.full((R, 3), np.inf)
        caps[:, 1] = caps[:, 2] = max(1.0, 0.6 * n / (R * 48))
        r_fr, t_fr = serve_routers(env, "temporal", caps, grids=grids,
                              inner=learned, max_defer_h=16)
        assert_served_equal(
            r_q.serve_stream(r_fr, batch, region, t, step_h=2,
                             former=r_q.BatchFormer(min_pad=ONE_SHAPE)),
            t_q.serve_stream(t_fr, torch_batch(batch), region, t, step_h=2,
                             former=t_q.BatchFormer(min_pad=ONE_SHAPE)))
