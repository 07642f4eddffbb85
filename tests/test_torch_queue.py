"""The port's continuous-batching serve loop (``serve/queue.py``) against
the JAX reference, on the CPU:
``serve_stream`` with and without a ``WorkerPool`` (cross-region
placement under live slots, a pool drained mid-stream, temporal deferral
under caps), every commitment, the per-step conservation ledger and the
settled carbon; ``BatchFormer`` drafts (pow-2 padding, KV sizing by an
engine and by ``for_envelope``); ``admit_batches`` and
``admit_windows(queue=)``. Integers exactly, carbon within rtol 1e-5. The
stub that waits for ROADMAP item 9 raises. The online refit is in
``test_torch_online.py``; ``serve_stream(plan=...)`` is in
``test_torch_provision.py``."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core import carbon_intensity as r_ci  # noqa: E402
from repro.core import infrastructure as r_inf  # noqa: E402
from repro.serve import engine as r_engine  # noqa: E402
from repro.serve import queue as r_q  # noqa: E402
from repro.serve import router as r_router  # noqa: E402
from repro.serve import streams as r_streams  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.core import infrastructure as t_inf  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve import placement as t_pl  # noqa: E402
from repro_torch.serve import queue as t_q  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402

from torch_fleet_parity import (  # noqa: E402
    ARCH,
    CPU,
    assert_served_equal,
    serve_routers,
    torch_batch,
)

R = 4
#: every draft of these streams pads to one shape, so the reference
#: compiles its route once per router instead of once per pow-2 size
ONE_SHAPE = 4096


@pytest.fixture(scope="module")
def env():
    r_cfg, t_cfg = r_get_config(ARCH), t_get_config(ARCH)
    r_base = r_router.FleetRouter(r_cfg)
    t_base = t_router.FleetRouter(t_cfg, device=CPU)
    return dict(r_cfg=r_cfg, t_cfg=t_cfg, r_inf=r_base.infra,
                t_inf=t_base.infra,
                grids=(r_ci.CarbonGrid.fully_connected(latency_penalty=1.05),
                       t_ci.CarbonGrid.fully_connected(latency_penalty=1.05,
                                                       device=CPU)))


def assert_conserved(res, n):
    """Every request settles exactly once; each step's ledger balances:
    queued + routed + shed == pushed after every step."""
    assert (res.step >= 0).all()
    routed = shed = 0
    for s in res.steps:
        assert s.drafted == s.routed + s.shed + s.held
        routed += s.routed
        shed += s.shed
        assert s.queued_after + routed + shed == n
    assert routed + shed == n
    assert shed == res.shed_count


def _pool(mod, slots, delay=0, drain_step=None):
    """Two workers per (region, DC tier); optionally drains every active
    worker at one serve step (an operator pulling the fleet)."""
    class Drain(mod.WorkerPool):
        t = 0

        def tick(self):
            super().tick()
            self.t += 1
            if self.t == drain_step:
                for r in range(self.n_regions):
                    for tier in range(3):
                        if self.active[r, tier]:
                            self.drain(r, tier, int(self.active[r, tier]))

    pool = Drain(R, slots_per_worker=slots, launch_delay_steps=delay)
    for r in range(R):
        for tier in (1, 2):
            pool.launch(r, tier, n=2)
    return pool


class TestServeStream:
    @pytest.mark.parametrize("slots,delay,drain", [(30_000.0, 0, None),
                                                   (8.0, 1, 14)])
    def test_placement_through_a_pool(self, env, slots, delay, drain):
        """The benchmark's queue row (live slots as caps), then binding
        slots with a launch delay and the pool drained mid-stream."""
        batch, region, t = r_streams.diurnal_stream(3000, R)
        unit = np.ones((R, 3))
        r_fr, t_fr = serve_routers(env, "placement", unit)
        r_res = r_q.serve_stream(r_fr, batch, region, t,
                                 pool=_pool(r_q, slots, delay, drain),
                                 former=r_q.BatchFormer(min_pad=ONE_SHAPE))
        t_res = t_q.serve_stream(t_fr, torch_batch(batch), region, t,
                                 pool=_pool(t_q, slots, delay, drain),
                                 former=t_q.BatchFormer(min_pad=ONE_SHAPE))
        assert_served_equal(r_res, t_res)
        assert_conserved(t_res, len(batch))
        if slots < 100:
            assert t_res.shed_count > 0

    def test_temporal_under_caps(self, env, step_h=2, max_batch=256):
        """Deferral under DC caps, drafts of at most 256 rows (several a
        step), two-hour steps."""
        batch, region, t = r_streams.arrival_stream(
            60.0, n_regions=R, seed=1, batch_frac=0.4, spike_at_h=12.0,
            spike_mult=3.0)
        caps = np.full((R, 3), np.inf)
        caps[:, 1] = caps[:, 2] = max(2.0, len(batch) / (R * 48))
        r_fr, t_fr = serve_routers(env, "temporal", caps, max_defer_h=8)
        pad = min(max_batch, ONE_SHAPE)
        r_res = r_q.serve_stream(r_fr, batch, region, t, step_h=step_h,
                                 former=r_q.BatchFormer(max_batch=max_batch,
                                                        min_pad=pad))
        t_res = t_q.serve_stream(t_fr, torch_batch(batch), region, t,
                                 step_h=step_h,
                                 former=t_q.BatchFormer(max_batch=max_batch,
                                                        min_pad=pad))
        assert_served_equal(r_res, t_res)
        assert_conserved(t_res, len(batch))
        assert t_res.deferred_count > 0 and t_res.shed_count > 0
        assert max(s.n_batches for s in t_res.steps) > 1

    def test_placement_under_static_caps(self, env):
        """No pool: the policy's own caps; a placement policy defers
        nothing, so its shed rows commit at once."""
        batch, region, t = r_streams.arrival_stream(
            50.0, n_regions=R, seed=2, batch_frac=0.5)
        caps = np.full((R, 3), 2.0)
        caps[:, 0] = np.inf
        r_fr, t_fr = serve_routers(env, "placement", caps)
        r_res = r_q.serve_stream(r_fr, batch, region, t, step_h=2,
                                 former=r_q.BatchFormer(min_pad=ONE_SHAPE))
        t_res = t_q.serve_stream(t_fr, torch_batch(batch), region, t,
                                 step_h=2,
                                 former=t_q.BatchFormer(min_pad=ONE_SHAPE))
        assert_served_equal(r_res, t_res)
        assert t_res.shed_count > 0
        assert sum(s.held for s in t_res.steps) == 0

    def test_empty_stream_and_validation(self, env):
        _, t_fr = serve_routers(env, "placement", np.full((R, 3), np.inf))
        batch, region, t = r_streams.arrival_stream(5.0, n_regions=R, seed=0)
        empty = dataclasses.replace(torch_batch(batch), **{
            f: np.asarray(getattr(batch, f))[:0]
            for f in ("prompt_tokens", "max_new_tokens", "latency_budget_s",
                      "bytes_per_token", "available")})
        res = t_q.serve_stream(t_fr, empty, region[:0], t[:0])
        assert res.total_carbon_g == 0.0 and len(res.steps) == 24
        with pytest.raises(ValueError, match="never wraps"):
            t_q.serve_stream(t_fr, torch_batch(batch), region, t + 24.0)
        with pytest.raises(ValueError, match="step_h"):
            t_q.serve_stream(t_fr, torch_batch(batch), region, t, step_h=0)


class TestQueueParts:
    def test_request_queue(self):
        b1, r1, t1 = r_streams.arrival_stream(10.0, n_regions=R, seed=0,
                                              batch_frac=0.5)
        b2, r2, t2 = r_streams.arrival_stream(10.0, n_regions=R, seed=1)
        qs = (r_q.RequestQueue(), t_q.RequestQueue())
        for q, conv in zip(qs, (lambda b: b, torch_batch)):
            q.push(conv(b1), r1, t1)
            q.push(conv(b2), r2, t2)
        rq, tq = qs
        np.testing.assert_array_equal(tq.batch.slack_h, rq.batch.slack_h)
        for before, defer in ((6.0, 0), (13.5, 8), (np.inf, 16)):
            np.testing.assert_array_equal(tq.ready(before, defer),
                                          rq.ready(before, defer))
        idx = tq.ready(5.0)
        tq.mark_routed(idx[:3])
        tq.mark_shed(idx[3:5])
        assert (tq.n_queued, tq.n_routed, tq.n_shed) == (len(tq) - 5, 3, 2)
        with pytest.raises(ValueError, match="double transition"):
            tq.mark_routed(idx[:1])
        with pytest.raises(ValueError, match="must be"):
            tq.push(torch_batch(b1), r1[:-1], t1)

    def test_drafts(self, env):
        batch, region, t = r_streams.arrival_stream(40.0, n_regions=R,
                                                    seed=2, batch_frac=0.3)
        qs = (r_q.RequestQueue.from_stream(batch, region, t),
              t_q.RequestQueue.from_stream(torch_batch(batch), region, t))
        model = Transformer(t_get_config(ARCH, smoke=True), device=CPU)
        formers = [
            (r_q.BatchFormer(max_batch=128, min_pad=16),
             t_q.BatchFormer(max_batch=128, min_pad=16)),
            (r_q.BatchFormer(max_batch=64, engine=r_engine.ServeEngine(
                env["r_cfg"], params=None, max_seq=512, kv_slots=8)),
             t_q.BatchFormer(max_batch=64, engine=ServeEngine(
                 env["t_cfg"], model, max_seq=512, kv_slots=8,
                 device=CPU))),
            (r_q.BatchFormer.for_envelope(r_inf.tpu_envelope(),
                                          kv_bytes_per_token=2.5e6),
             t_q.BatchFormer.for_envelope(t_inf.tpu_envelope(),
                                          kv_bytes_per_token=2.5e6)),
            (r_q.BatchFormer.for_envelope(r_inf.paper_envelope(),
                                          kv_bytes_per_token=1e5,
                                          max_seq=2048, max_batch=512),
             t_q.BatchFormer.for_envelope(t_inf.paper_envelope(),
                                          kv_bytes_per_token=1e5,
                                          max_seq=2048, max_batch=512)),
        ]
        for rf, tf in formers:
            assert tf.kv_slots == rf.kv_slots
            for now, defer in ((0, 0), (10, 8)):
                ready = qs[0].ready(now + 1 if now else np.inf, defer)
                rd = rf.draft(qs[0], ready, now, defer)
                td = tf.draft(qs[1], ready, now, defer)
                assert len(td) == len(rd) > 0
                for a, b in zip(td, rd):
                    assert (a.n, a.pad_to) == (b.n, b.pad_to)
                    for f in ("idx", "region", "hour", "slack"):
                        np.testing.assert_array_equal(getattr(a, f),
                                                      getattr(b, f))
                    np.testing.assert_array_equal(a.batch.available,
                                                  np.asarray(b.batch.available))
        assert formers[2][1].kv_slots is not None
        with pytest.raises(ValueError, match="max_batch"):
            t_q.BatchFormer(max_batch=0)

    def test_worker_pool(self):
        pools = (r_q.WorkerPool(R, slots_per_worker=8.0),
                 t_q.WorkerPool(R, slots_per_worker=8.0))
        for p in pools:
            p.launch(0, 1, n=3)
            p.launch(2, 2)
            p.tick()
            p.drain(0, 1, n=2)
        for f in ("active", "draining", "terminated", "launching"):
            np.testing.assert_array_equal(getattr(pools[1], f),
                                          getattr(pools[0], f), err_msg=f)
        np.testing.assert_array_equal(pools[1].cap_matrix(),
                                      pools[0].cap_matrix())
        assert pools[1].terminate_drained() == pools[0].terminate_drained()
        with pytest.raises(ValueError):
            t_q.WorkerPool(R, slots_per_worker=0.0)
        with pytest.raises(ValueError):
            pools[1].launch(0, 1, n=0)


class TestAdmission:
    @pytest.fixture(scope="class")
    def served(self, env):
        batch, region, t = r_streams.arrival_stream(40.0, n_regions=R,
                                                    seed=3)
        r_fr, t_fr = serve_routers(env, "placement", np.full((R, 3), np.inf))
        engines = (r_engine.ServeEngine(env["r_cfg"], params=None, tier=1),
                   ServeEngine(env["t_cfg"],
                               Transformer(t_get_config(ARCH, smoke=True),
                                           device=CPU), tier=1, device=CPU))
        return (r_fr, t_fr, engines, batch, region, t,
                r_q.serve_stream(r_fr, batch, region, t, step_h=2,
                                 former=r_q.BatchFormer(min_pad=ONE_SHAPE)),
                t_q.serve_stream(t_fr, torch_batch(batch), region, t,
                                 step_h=2,
                                 former=t_q.BatchFormer(min_pad=ONE_SHAPE)))

    def test_admit_batches(self, served):
        _, _, (r_eng, t_eng), _, _, _, r_res, t_res = served
        want = r_q.admit_batches(r_res, r_eng)
        got = t_q.admit_batches(t_res, t_eng)
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    def test_admit_windows_delegates_to_the_queue(self, served):
        _, t_fr, (_, t_eng), _, _, _, _, t_res = served
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # delegation must not warn
            via = t_fr.admit_windows(None, None, t_eng, queue=t_res)
        direct = t_q.admit_batches(t_res, t_eng)
        assert len(via) == len(direct)
        for a, b in zip(via, direct):
            np.testing.assert_array_equal(a, b)


class TestStubs:
    """The parts that wait for other ROADMAP items raise, naming them."""

    def test_mesh_is_item_9(self, env):
        with pytest.raises(NotImplementedError, match="item 9"):
            t_q.BatchFormer(mesh=object())
        with pytest.raises(NotImplementedError, match="item 9"):
            t_router.FleetRouter(env["t_cfg"], mesh=object(), device=CPU)
