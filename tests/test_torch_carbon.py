"""Parity of the port's decide half (``repro_torch.core`` / ``serve.router``)
with the JAX reference: copied configs/constants/embodied numbers, grid
traces, the Table-1 evaluation, routing over requests x hours x
availability masks, and ``GreenScaleRouter``. Targets must match exactly;
carbon and latency within rtol 1e-5 (float32 reassociation between XLA and
torch)."""

import dataclasses
import enum
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.core import carbon_intensity as r_ci  # noqa: E402
from repro.core import carbon_model as r_cm  # noqa: E402
from repro.core import constants as r_const  # noqa: E402
from repro.core import embodied as r_emb  # noqa: E402
from repro.core import infrastructure as r_infra  # noqa: E402
from repro.core import workloads as r_wl  # noqa: E402
from repro.launch.serve import env_at_hour as r_env_at_hour  # noqa: E402
from repro.serve import router as r_router  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.core import carbon_model as t_cm  # noqa: E402
from repro_torch.core import constants as t_const  # noqa: E402
from repro_torch.core import embodied as t_emb  # noqa: E402
from repro_torch.core import infrastructure as t_infra  # noqa: E402
from repro_torch.core import workloads as t_wl  # noqa: E402
from repro_torch.launch.serve import env_at_hour as t_env_at_hour  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402

CPU = "cpu"
RTOL = 1e-5
WORKLOAD_FIELDS = [f.name for f in dataclasses.fields(r_wl.Workload)]
#: every availability mask, all-False included (-> MOBILE)
MASKS = np.array(list(itertools.product([False, True], repeat=3)))
_R_EVALUATE = jax.jit(jax.vmap(r_cm.evaluate, in_axes=(0, None, None)))
_R_ROUTE = jax.jit(r_cm.route_many)


def _plain(x):
    """Dataclasses/enums/tuples -> comparable plain Python values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    return x


def _np(t):
    return t.detach().cpu().numpy()


class TestCopies:
    @pytest.mark.parametrize("arch", r_configs.ARCH_IDS)
    def test_configs_equal(self, arch):
        for smoke in (False, True):
            r = r_configs.get_config(arch, smoke=smoke)
            t = t_configs.get_config(arch, smoke=smoke)
            assert _plain(t) == _plain(r)
            assert t.param_count() == r.param_count()
            assert t.active_param_count() == r.active_param_count()
        assert t_configs.ARCH_IDS == r_configs.ARCH_IDS
        assert _plain(t_configs.SHAPES) == _plain(r_configs.SHAPES)

    def test_constants_equal(self):
        names = [n for n in dir(r_const) if n.isupper()]
        assert names == [n for n in dir(t_const) if n.isupper()]
        for n in names:
            assert _plain(getattr(t_const, n)) == _plain(getattr(r_const, n)), n
        for enum_name in ("EnergySource", "Target", "Component"):
            r_enum, t_enum = getattr(r_const, enum_name), getattr(t_const, enum_name)
            assert [(m.name, m.value) for m in t_enum] == \
                [(m.name, m.value) for m in r_enum]

    def test_embodied_equal(self):
        assert t_emb.act_fleet_embodied_g() == r_emb.act_fleet_embodied_g()
        for bom in ("BOM_PIXEL3", "BOM_P3", "BOM_P4D"):
            assert _plain(getattr(t_emb, bom)) == _plain(getattr(r_emb, bom))
            assert (t_emb.act_embodied_g(getattr(t_emb, bom))
                    == r_emb.act_embodied_g(getattr(r_emb, bom)))
        assert (t_emb.amortized_g_per_hour(1e6, 35064.0, 0.5)
                == r_emb.amortized_g_per_hour(1e6, 35064.0, 0.5))


class TestTraces:
    @pytest.mark.parametrize("grid", list(r_ci.Grid))
    def test_grid_trace_and_mobile_ci(self, grid):
        r = r_ci.grid_trace(grid)
        t = t_ci.grid_trace(int(grid), device=CPU)
        np.testing.assert_array_equal(_np(t.mix), np.asarray(r.mix))
        np.testing.assert_allclose(_np(t.ci_hourly), np.asarray(r.ci_hourly),
                                   rtol=RTOL)
        for b in r_ci.ChargingBehavior:
            np.testing.assert_allclose(
                float(t_ci.mobile_carbon_intensity(int(b), t)),
                float(r_ci.mobile_carbon_intensity(b, r)), rtol=RTOL)

    @pytest.mark.parametrize("hour", range(24))
    def test_env_at_hour(self, hour):
        np.testing.assert_allclose(_np(t_env_at_hour(hour, device=CPU).ci),
                                   np.asarray(r_env_at_hour(hour).ci),
                                   rtol=RTOL)


def _workload_columns():
    """(N,) float columns: the paper's AI/game/AR-VR tables (streaming rows
    included) plus LM requests of the h2o-danube-1.8b router."""
    r_stack = r_wl.stack_workloads(r_wl.ALL_PAPER_WORKLOADS)
    cols = {f: np.asarray(getattr(r_stack, f), np.float64)
            for f in WORKLOAD_FIELDS}
    cfg = r_configs.get_config("h2o-danube-1.8b")
    rng = np.random.default_rng(0)
    n = 24
    batch = r_router.RequestBatch(
        prompt_tokens=rng.integers(1, 4096, n).astype(np.float64),
        max_new_tokens=rng.integers(0, 512, n).astype(np.float64),
        latency_budget_s=rng.choice([0.05, 0.5, 2.0, 30.0], n),
        bytes_per_token=np.full(n, 4.0),
        available=np.ones((n, 3), bool))
    lm = batch.workload(cfg)
    for f in WORKLOAD_FIELDS:
        cols[f] = np.concatenate([cols[f], np.asarray(getattr(lm, f),
                                                      np.float64)])
    return cols


FLEETS = {
    "tpu-act": (r_infra.tpu_fleet, t_infra.tpu_fleet, "act", "phone"),
    "paper-lca": (r_infra.paper_fleet, t_infra.paper_fleet, "lca", "phone"),
    "paper-jetson": (r_infra.paper_fleet, t_infra.paper_fleet, "act", "jetson"),
}


class TestCarbonModel:
    @pytest.fixture(scope="class")
    def columns(self):
        return _workload_columns()

    @pytest.mark.parametrize("fleet", list(FLEETS))
    def test_pack_infra(self, fleet):
        rf, tf, emb, kind = FLEETS[fleet]
        r = r_infra.pack_infra(rf(), emb, kind)
        t = t_infra.pack_infra(tf(), emb, kind, device=CPU)
        for f in dataclasses.fields(r):
            np.testing.assert_array_equal(_np(getattr(t, f.name)),
                                          np.asarray(getattr(r, f.name)),
                                          err_msg=f.name)
            assert getattr(t, f.name).dtype == torch.float32

    @pytest.mark.parametrize("fleet", list(FLEETS))
    def test_evaluate_and_route_grid(self, fleet, columns):
        """Requests x hours 0-23 x all 8 availability masks."""
        rf, tf, emb, kind = FLEETS[fleet]
        r_inf = r_infra.pack_infra(rf(), emb, kind)
        t_inf = t_infra.pack_infra(tf(), emb, kind, device=CPU)
        n = len(columns["flops"])
        reps = len(MASKS)
        cols = {f: np.repeat(v, reps) for f, v in columns.items()}
        avail = np.tile(MASKS, (n, 1))
        r_w = r_wl.Workload.make(**cols)
        t_w = t_wl.batch_workloads(**cols, device=CPU)
        for f in WORKLOAD_FIELDS:
            np.testing.assert_array_equal(_np(getattr(t_w, f)),
                                          np.asarray(getattr(r_w, f)))
        for hour in range(24):
            r_env, t_env = r_env_at_hour(hour), t_env_at_hour(hour, device=CPU)
            r_b = _R_EVALUATE(r_w, r_inf, r_env)
            t_b = t_cm.evaluate(t_w, t_inf, t_env)
            for f in ("op_cf", "emb_cf", "latency", "t_comp", "t_comm"):
                np.testing.assert_allclose(_np(getattr(t_b, f)),
                                           np.asarray(getattr(r_b, f)),
                                           rtol=RTOL, atol=0, err_msg=f)
            r_out = _R_ROUTE(r_w, r_inf, r_env, jnp.asarray(avail))
            t_out = t_cm.route_many(t_w, t_inf, t_env, torch.as_tensor(avail))
            for f in ("target", "target_latency", "target_energy", "ok"):
                np.testing.assert_array_equal(_np(getattr(t_out, f)),
                                              np.asarray(getattr(r_out, f)),
                                              err_msg=f"{f} hour {hour}")
            for f in ("total_cf", "latency"):
                np.testing.assert_allclose(_np(getattr(t_out, f)),
                                           np.asarray(getattr(r_out, f)),
                                           rtol=RTOL, err_msg=f)
            none = ~avail.any(axis=1)
            assert (_np(t_out.target)[none] == 0).all()

    def test_route_one_matches_batched_rows(self, columns):
        """The scalar entry point agrees with the batched one row by row."""
        t_inf = t_infra.pack_infra(t_infra.tpu_fleet(), device=CPU)
        env = t_env_at_hour(7, device=CPU)
        t_w = t_wl.batch_workloads(**columns, device=CPU)
        avail = torch.ones((len(columns["flops"]), 3), dtype=torch.bool)
        batched = t_cm.route_many(t_w, t_inf, env, avail)
        for i in range(0, len(columns["flops"]), 5):
            w_i = t_wl.Workload.make(**{f: v[i] for f, v in columns.items()},
                                     device=CPU)
            one = t_cm.route_one(w_i, t_inf, env, avail[i])
            assert int(one.target) == int(batched.target[i])
            torch.testing.assert_close(one.total_cf, batched.total_cf[i],
                                       rtol=0, atol=0)

    def test_pick_target_all_false_avail_is_mobile(self):
        """Pinned behaviour: an all-False mask resolves to MOBILE (index 0),
        as jnp.argmin's first-index rule gives the reference."""
        score = np.array([[3.0, 1.0, 2.0], [1.0, 1.0, 1.0], [5.0, 4.0, 4.0]],
                         np.float32)
        ok = np.array([[True, True, True], [False, False, False],
                       [False, True, True]])
        for avail in MASKS:
            av = np.broadcast_to(avail, ok.shape)
            r = jax.vmap(r_cm.pick_target)(jnp.asarray(score), jnp.asarray(ok),
                                           jnp.asarray(score), jnp.asarray(av))
            t = t_cm.pick_target(torch.as_tensor(score), torch.as_tensor(ok),
                                 torch.as_tensor(score), torch.as_tensor(av))
            np.testing.assert_array_equal(_np(t), np.asarray(r))
            if not avail.any():
                assert (_np(t) == 0).all()


def _requests():
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(40):
        reqs.append(r_router.Request(
            prompt_tokens=int(rng.integers(1, 8192)),
            max_new_tokens=int(rng.integers(0, 1024)),
            latency_budget_s=float(rng.choice([0.01, 0.1, 1.0, 2.0, 60.0])),
            bytes_per_token=float(rng.choice([2.0, 4.0])),
            available=tuple(bool(x) for x in MASKS[i % len(MASKS)])))
    return reqs


def _assert_decision(t, r):
    assert t.target == r.target
    assert t.feasible == r.feasible
    np.testing.assert_allclose(t.carbon_g, r.carbon_g, rtol=RTOL)
    np.testing.assert_allclose(t.latency_s, r.latency_s, rtol=RTOL)
    np.testing.assert_allclose(t.per_target_carbon, r.per_target_carbon,
                               rtol=RTOL)


class TestRouter:
    @pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen3-moe-30b-a3b"])
    def test_route_and_route_batch(self, arch):
        r_rt = r_router.GreenScaleRouter(r_configs.get_config(arch))
        t_rt = t_router.GreenScaleRouter(t_configs.get_config(arch),
                                         device=CPU)
        reqs = _requests()
        t_reqs = [t_router.Request(**dataclasses.asdict(q)) for q in reqs]
        for hour in (0, 12):
            r_env, t_env = r_env_at_hour(hour), t_env_at_hour(hour, device=CPU)
            r_dec = r_rt.route_batch(reqs, r_env)
            t_dec = t_rt.route_batch(t_reqs, t_env)
            assert len(t_dec) == len(r_dec)
            for t, r in zip(t_dec, r_dec):
                _assert_decision(t, r)
            for q, tq in list(zip(reqs, t_reqs))[::7]:
                _assert_decision(t_rt.route(tq, t_env), r_rt.route(q, r_env))
        assert t_rt.route_batch([], t_env) == []
