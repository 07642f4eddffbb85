"""The port's sharded routing (``repro_torch.serve.distributed``) against
the JAX reference, on the CPU over gloo process groups (FileStore init
under ``tmp_path``, so concurrent test workers never race for a port).

World 1 runs in this process: the reference's six-router matrix
(``tests/test_distributed.py``) routed through ``data_mesh(1)`` holds the
reference's meshless route and its ``data_mesh(1)`` route, and the seams
that ride the mesh (``serve_stream``, the rolling re-planner, a scenario
cell) equal their meshless runs. Worlds 2 and 4 are spawned ranks
(``torch_dist_parity``, which imports no JAX): every rank returns the same
result, its decisions are the reference's single-device program's, and
every aggregate, routed gCO2 included, is bit-identical across worlds 1, 2
and 4 and to the port's single-rank route. Against the reference integers
exactly, carbon within rtol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core.carbon_intensity import CarbonGrid as r_Grid  # noqa: E402
from repro.core.carbon_intensity import DEFAULT_REGIONS  # noqa: E402
from repro.serve import distributed as r_dist  # noqa: E402
from repro.serve import placement as r_pl  # noqa: E402
from repro.serve import policy as r_pol  # noqa: E402
from repro.serve import router as r_router  # noqa: E402
from repro.serve import temporal as r_tmp  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.serve import distributed as t_dist  # noqa: E402
from repro_torch.serve import placement as t_pl  # noqa: E402
from repro_torch.serve import policy as t_pol  # noqa: E402
from repro_torch.serve import queue as t_q  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402
from repro_torch.serve import scenarios as t_sc  # noqa: E402
from repro_torch.serve import streams as t_streams  # noqa: E402
from repro_torch.serve import temporal as t_tmp  # noqa: E402

import torch_dist_parity as tdp  # noqa: E402
from torch_fleet_parity import (ARCH, CPU, RTOL, host,  # noqa: E402,F401
                                one_thread)

R = len(DEFAULT_REGIONS)
MATRIX = ("oracle", "placement-diag", "placement-cross",
          "placement-uncapped", "temporal-joint", "temporal-diag")
DECISIONS = ("target", "feasible", "exec_region", "counts", "shed_count",
             "spilled_count", "deferred_count", "infeasible_count")
STATE_DECISIONS = ("counts", "shed", "shed_pair", "exec_region",
                   "exec_hour", "defer_hours")


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory, one_thread):
    """A world of one gloo rank in this process, and its 1-D mesh."""
    with tdp.one_rank_world(str(tmp_path_factory.mktemp("world1"))) as mesh:
        yield mesh


def _stream(n: int, seed: int = 0, slack: bool = False):
    """``tests/test_distributed.py``'s ``_stream``."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(16, 4096, n).astype(np.float64)
    new = rng.integers(8, 512, n).astype(np.float64)
    avail = np.ones((n, 3), bool)
    avail[:, 0] = prompt < 2048
    cols = dict(prompt_tokens=prompt, max_new_tokens=new,
                latency_budget_s=rng.choice([0.5, 2.0, 10.0], n),
                bytes_per_token=np.full(n, 4.0), available=avail,
                slack_hours=(rng.integers(0, 6, n).astype(np.float64)
                             if slack else None))
    return cols, rng.integers(0, R, n), rng.uniform(0.0, 24.0, n)


def _routers(name, r_cfg, t_cfg):
    """One router of the reference's parity matrix, in both packages."""
    caps = np.full((R, 3), np.inf if name == "placement-uncapped" else 30.0)
    out = []
    for pl, pol, tmp, router, grid_cls, cfg, dev in (
            (r_pl, r_pol, r_tmp, r_router, r_Grid, r_cfg, {}),
            (t_pl, t_pol, t_tmp, t_router, t_ci.CarbonGrid, t_cfg,
             {"device": CPU})):
        infra = router.FleetRouter(cfg, **dev).infra
        kw = {}
        if name in ("placement-cross", "placement-uncapped",
                    "temporal-joint"):
            kw["grid"] = grid_cls.fully_connected(DEFAULT_REGIONS, **dev)
        if name.startswith("placement"):
            kw["policy"] = pl.PlacementPolicy(pol.OraclePolicy(infra), caps)
        elif name.startswith("temporal"):
            kw["policy"] = tmp.TemporalPolicy(pol.OraclePolicy(infra), caps,
                                              max_defer_h=6)
        out.append(router.FleetRouter(cfg, **kw, **dev))
    return out


def _assert_decides_as(ref, ref_state, res, state):
    """The port's sharded result holds a reference result: decisions
    exactly, carbon within ``RTOL``."""
    for f in DECISIONS:
        np.testing.assert_array_equal(host(getattr(res, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("carbon_g", "routed_carbon_g", "total_carbon_g"):
        np.testing.assert_allclose(host(getattr(res, f)),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   atol=0, err_msg=f)
    assert (ref_state == ()) == (state == ())
    for f in STATE_DECISIONS:
        a = getattr(ref_state, f, None)
        assert (a is None) == (getattr(state, f, None) is None), f
        if a is not None:
            np.testing.assert_array_equal(host(getattr(state, f)),
                                          np.asarray(a), err_msg=f)


@pytest.fixture(scope="module")
def cfgs():
    return r_get_config(ARCH), t_get_config(ARCH)


class TestWorldOne:
    """The sharded program with its collectives live at world size 1."""

    @pytest.mark.parametrize("name", MATRIX)
    def test_matches_the_reference(self, cfgs, mesh1, name):
        r_fr, t_fr = _routers(name, *cfgs)
        cols, region, t = _stream(257, seed=3, slack=True)  # non-pow2 n
        r_batch = r_router.RequestBatch(**cols)
        ref = r_fr.route_stream_with_state(r_batch, region, t)
        ref_mesh = r_fr.route_stream_with_state(r_batch, region, t,
                                                mesh=r_dist.data_mesh(1))
        res, state = t_fr.route_stream_with_state(
            t_router.RequestBatch(**cols), region, t, mesh=mesh1)
        _assert_decides_as(*ref, res, state)
        _assert_decides_as(*ref_mesh, res, state)

    @pytest.mark.parametrize("name", MATRIX)
    def test_aggregates_are_the_single_rank_routes(self, cfgs, mesh1, name):
        """The sharded route sums the gathered rows with the single-rank
        route's own aggregation: every field of the result the same bits."""
        _, t_fr = _routers(name, *cfgs)
        cols, region, t = _stream(257, seed=3, slack=True)
        batch = t_router.RequestBatch(**cols)
        want = t_fr.route_stream(batch, region, t)
        got = t_fr.route_stream(batch, region, t, mesh=mesh1)
        for f in tdp.RESULT_FIELDS:
            a, b = host(getattr(got, f)), host(getattr(want, f))
            assert a.dtype == b.dtype, f
            assert a.tobytes() == b.tobytes(), f

    def test_router_mesh_field_is_the_default(self, cfgs, mesh1):
        _, t_cfg = cfgs
        cols, region, t = _stream(130, seed=7)
        batch = t_router.RequestBatch(**cols)
        infra = t_router.FleetRouter(t_cfg, device=CPU).infra
        caps = np.full((R, 3), 30.0)
        mk = lambda mesh: t_router.FleetRouter(
            t_cfg, device=CPU, mesh=mesh,
            policy=t_pl.PlacementPolicy(t_pol.OraclePolicy(infra), caps))
        via_field = mk(mesh1).route_stream(batch, region, t)
        via_call = mk(None).route_stream(batch, region, t, mesh=mesh1)
        for f in DECISIONS + ("carbon_g", "routed_carbon_g"):
            np.testing.assert_array_equal(host(getattr(via_field, f)),
                                          host(getattr(via_call, f)))

    def test_empty_stream_takes_the_single_rank_path(self, cfgs, mesh1,
                                                     monkeypatch):
        _, fr = _routers("placement-cross", *cfgs)
        cols, region, t = _stream(0)

        def refuse(*a, **k):
            raise AssertionError("an empty stream reached the sharded path")

        monkeypatch.setattr(t_dist, "route_arrays_sharded", refuse)
        res, state = fr.route_stream_with_state(
            t_router.RequestBatch(**cols), region, t, mesh=mesh1)
        assert tuple(res.target.shape) == (0,)
        assert int(res.shed_count) == 0 and float(res.routed_carbon_g) == 0

    def test_capacity_limiter_is_refused(self, cfgs, mesh1):
        r_cfg, t_cfg = cfgs
        cols, region, t = _stream(40)
        caps = np.full((R, 3), 5.0)
        r_fr = r_router.FleetRouter(r_cfg, policy=r_pol.CapacityLimiter(
            r_pol.OraclePolicy(r_router.FleetRouter(r_cfg).infra), caps))
        with pytest.raises(NotImplementedError) as r_err:
            r_fr.route_stream(r_router.RequestBatch(**cols), region, t,
                              mesh=r_dist.data_mesh(1))
        t_infra = t_router.FleetRouter(t_cfg, device=CPU).infra
        t_fr = t_router.FleetRouter(t_cfg, device=CPU,
                                    policy=t_pol.CapacityLimiter(
                                        t_pol.OraclePolicy(t_infra), caps))
        with pytest.raises(NotImplementedError) as t_err:
            t_fr.route_stream(t_router.RequestBatch(**cols), region, t,
                              mesh=mesh1)
        pointer = str(r_err.value).split("cannot reconcile")[1]
        assert str(t_err.value).endswith(pointer)
        # the policy itself refuses a process group, as the reference's does
        with pytest.raises(NotImplementedError, match="PlacementPolicy"):
            t_fr.policy.decide(None, None, None, None,
                               axis_name=mesh1.get_group())

    def test_mesh_shape_and_size_are_checked(self, cfgs, mesh1):
        from torch.distributed.device_mesh import init_device_mesh

        _, fr = _routers("placement-cross", *cfgs)
        cols, region, t = _stream(20)
        mesh2d = init_device_mesh("cpu", (1, 1), mesh_dim_names=("a", "b"))
        with pytest.raises(ValueError, match="ONE data axis"):
            fr.route_stream(t_router.RequestBatch(**cols), region, t,
                            mesh=mesh2d)
        for n in (0, 2):
            with pytest.raises(ValueError, match=r"\[1, 1\]"):
                t_dist.data_mesh(n, device=CPU)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                t_dist.data_mesh(1)
        assert t_dist.data_mesh(device=CPU).size() == 1
        assert t_dist.DATA_AXIS == r_dist.DATA_AXIS


class TestSeamsRideTheMesh:
    """Every caller of ``FleetRouter._route_arrays`` shards with the router
    and decides as without it."""

    def test_serve_stream(self, mesh1):
        want, got = tdp.served(), tdp.served(mesh1)
        for f in tdp.SERVED_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        assert [s.drafted for s in got.steps] == [s.drafted
                                                  for s in want.steps]
        assert got.shed_count > 0

    def test_rolling_replanner(self, cfgs, mesh1):
        _, t_cfg = cfgs
        batch, region, t, grid = t_streams.forecast_scenario(
            600, DEFAULT_REGIONS, sigma_h=0.03, seed=0, device=CPU)
        infra = t_router.FleetRouter(t_cfg, device=CPU).infra
        caps = np.full((R, 3), np.inf)
        caps[:, 1] = caps[:, 2] = 6.0

        def run(mesh):
            fr = t_router.FleetRouter(
                t_cfg, grid=grid, device=CPU, mesh=mesh,
                policy=t_tmp.TemporalPolicy(t_pol.OraclePolicy(infra), caps,
                                            max_defer_h=12,
                                            risk_lambda=1.0))
            return fr.route_stream_rolling(batch, region, t, step_h=6)

        want, got = run(None), run(mesh1)
        for f in ("target", "exec_region", "exec_hour", "defer_hours",
                  "shed", "carbon_g"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        assert [(s.planned, s.committed, s.held, s.shed) for s in got.steps
                ] == [(s.planned, s.committed, s.held, s.shed)
                      for s in want.steps]
        assert got.deferred_count > 0

    def test_scenario_cell(self, mesh1):
        scenario = t_sc.default_scenarios()["steady_diurnal"]
        factory = t_sc.default_policies()["temporal-defer"]
        want, _, _ = t_sc.route_scenario(scenario, factory, n=400,
                                         device=CPU)
        got, state, _ = t_sc.route_scenario(scenario, factory, n=400,
                                            mesh=mesh1, device=CPU)
        for f in DECISIONS + ("carbon_g",):
            np.testing.assert_array_equal(host(getattr(got, f)),
                                          host(getattr(want, f)), err_msg=f)
        assert state.exec_hour is not None
        cells = t_sc.run_matrix({"steady_diurnal": scenario},
                                {"temporal-defer": factory}, n=400,
                                mesh=mesh1, device=CPU)
        assert cells[0].routed_g == float(got.routed_carbon_g)


class TestSpawnedWorlds:
    """Worlds 2 and 4: placement-cross and temporal-joint, caps 25, the
    reference's n = 515 stream and an n = 3 stream."""

    @pytest.fixture(scope="class")
    def worlds(self, mesh1, tmp_path_factory):
        out = {}
        for name, n in tdp.WORLD_CASES:
            cols, region, t = tdp.invariance_stream(n)
            res, state = tdp.port_router(name).route_stream_with_state(
                tdp.port_batch(cols), region, t, mesh=mesh1)
            out.setdefault(1, [{}])[0].update(
                tdp.flatten(res, state, f"{name}@{n}"))
        for world in (2, 4):
            out[world] = tdp.run_world(
                world, str(tmp_path_factory.mktemp(f"world{world}")))
        return out

    @pytest.fixture(scope="class")
    def reference(self):
        """The reference's single-device program on the same streams."""
        cfg = r_get_config(ARCH, smoke=True)
        infra = r_router.FleetRouter(cfg).infra
        caps = np.full((R, 3), tdp.CAPS)
        grid = r_Grid.fully_connected(DEFAULT_REGIONS)
        routers = {
            "placement-cross": r_router.FleetRouter(
                cfg, grid=grid, policy=r_pl.PlacementPolicy(
                    r_pol.OraclePolicy(infra), caps)),
            "temporal-joint": r_router.FleetRouter(
                cfg, grid=grid, policy=r_tmp.TemporalPolicy(
                    r_pol.OraclePolicy(infra), caps, max_defer_h=6))}
        out = {}
        for name, n in tdp.WORLD_CASES:
            cols, region, t = tdp.invariance_stream(n)
            out[f"{name}@{n}"] = routers[name].route_stream_with_state(
                r_router.RequestBatch(**cols), region, t)
        return out

    @pytest.mark.parametrize("world", [2, 4])
    def test_every_rank_returns_the_same_result(self, worlds, world):
        ranks = worlds[world]
        assert len(ranks) == world
        for other in ranks[1:]:
            assert other.keys() == ranks[0].keys()
            for k, v in ranks[0].items():
                np.testing.assert_array_equal(other[k], v, err_msg=k)

    @pytest.mark.parametrize("world", [1, 2, 4])
    @pytest.mark.parametrize("case", [f"{c}@{n}" for c, n in
                                      tdp.WORLD_CASES])
    def test_decisions_are_the_references(self, worlds, reference, world,
                                          case):
        got = worlds[world][0]
        ref, ref_state = reference[case]
        fields = {f: f for f in DECISIONS} | {
            f"state.{f}": f for f in ("shed", "counts", "exec_hour",
                                      "defer_hours")
            if getattr(ref_state, f, None) is not None}
        for k, f in fields.items():
            src = ref if not k.startswith("state.") else ref_state
            np.testing.assert_array_equal(got[f"{case}/{k}"],
                                          np.asarray(getattr(src, f)),
                                          err_msg=k)
        np.testing.assert_allclose(got[f"{case}/carbon_g"],
                                   np.asarray(ref.carbon_g), rtol=RTOL,
                                   atol=0)
        np.testing.assert_allclose(got[f"{case}/routed_carbon_g"],
                                   float(ref.routed_carbon_g), rtol=RTOL)
        if case.endswith(f"@{tdp.N_INVARIANCE}"):
            assert int(ref.spilled_count) > 0  # the caps bind

    @pytest.mark.parametrize("case", [f"{c}@{n}" for c, n in
                                      tdp.WORLD_CASES])
    def test_routed_carbon_is_bit_identical_across_worlds(self, worlds,
                                                          case):
        name, n = case.split("@")
        cols, region, t = tdp.invariance_stream(int(n))
        one = tdp.flatten(*tdp.port_router(name).route_stream_with_state(
            tdp.port_batch(cols), region, t), case)  # the single-rank route
        for world in (1, 2, 4):
            for f in ("carbon_g", "routed_carbon_g", "total_carbon_g",
                      "mean_defer_hours"):
                got, want = worlds[world][0][f"{case}/{f}"], one[
                    f"{case}/{f}"]
                assert got.dtype == want.dtype
                assert got.tobytes() == want.tobytes(), (world, f)

    @pytest.mark.parametrize("world", [2, 4])
    def test_serve_stream_equals_the_meshless_run(self, worlds, world):
        want = tdp.served()
        for f in tdp.SERVED_FIELDS:
            np.testing.assert_array_equal(worlds[world][0][f"serve/{f}"],
                                          getattr(want, f), err_msg=f)


class TestBatchFormerMesh:
    """``tests/test_distributed.py::TestBatchFormerMesh`` for the port."""

    class FakeMesh:
        def size(self):
            return 4

    def test_meshless_padding_unchanged(self):
        bf = t_q.BatchFormer()
        for k in (1, 5, 16, 17, 100):
            assert bf._pad_to(k) == t_q.pad_pow2(k, bf.min_pad)

    def test_mesh_padding_is_device_multiple_pow2(self, mesh1):
        bf = t_q.BatchFormer(mesh=self.FakeMesh(), min_pad=16)
        assert bf._pad_to(1) == 64  # 4 * pad_pow2(1)
        assert bf._pad_to(64) == 64
        assert bf._pad_to(65) == 128  # 4 * pad_pow2(17)
        # a real one-rank mesh degenerates to the meshless buckets
        assert t_q.BatchFormer(mesh=mesh1)._pad_to(17) == 32

    def test_draft_shapes_divide_the_mesh(self):
        cols, region, t = _stream(37, seed=9)
        queue = t_q.RequestQueue.from_stream(t_router.RequestBatch(**cols),
                                             region,
                                             np.floor(t).astype(np.int32))
        former = t_q.BatchFormer(mesh=self.FakeMesh(), min_pad=16)
        drafts = former.draft(queue, queue.ready(24, 0), 0)
        assert drafts and all(fb.pad_to % 4 == 0 for fb in drafts)

    def test_serve_stream_drafts_with_the_routers_mesh(self, mesh1,
                                                       monkeypatch):
        seen = []
        real = t_q.BatchFormer.__post_init__

        def spy(self):
            seen.append(self.mesh)
            real(self)

        monkeypatch.setattr(t_q.BatchFormer, "__post_init__", spy)
        tdp.served(mesh1)
        assert seen == [mesh1]
