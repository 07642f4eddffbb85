"""Parity of the port's carbon grid, factorized evaluator, synthetic streams
and segment ranks with the JAX reference, on the CPU: ``CarbonGrid``
(tables, forecast, roll, repeat, scaled_days, from_sites and its sparse
neighbour lists), ``route_many_envs`` and the ``EnergyFactors`` scorers,
``repro_torch.serve.streams`` against ``repro.serve.streams``, and
``windowed_segment_ranks``. Tables within rtol 1e-6, integers exactly,
carbon within rtol 1e-5."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core import carbon_intensity as r_ci  # noqa: E402
from repro.core import carbon_model as r_cm  # noqa: E402
from repro.core.infrastructure import pack_infra as r_pack  # noqa: E402
from repro.core.infrastructure import tpu_fleet as r_tpu  # noqa: E402
from repro.serve import placement as r_pl  # noqa: E402
from repro.serve import streams as r_streams  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.core import carbon_model as t_cm  # noqa: E402
from repro_torch.core.infrastructure import pack_infra as t_pack  # noqa: E402
from repro_torch.core.infrastructure import tpu_fleet as t_tpu  # noqa: E402
from repro_torch.serve import placement as t_pl  # noqa: E402
from repro_torch.serve import streams as t_streams  # noqa: E402

from torch_fleet_parity import ARCH, CPU, RTOL, host, torch_batch  # noqa: E402

TABLE_RTOL = 1e-6
GRID_FIELDS = ("ci_hourly", "ci_mobile", "ci_core", "pue", "adjacency",
               "latency_penalty", "rtt_s", "ci_forecast", "nbr_idx",
               "nbr_rtt_s")
EXACT = ("adjacency", "nbr_idx")


def assert_grid_equal(t, r):
    assert t.forecast_sigma_h == r.forecast_sigma_h
    assert t.forecast_seed == r.forecast_seed
    for f in GRID_FIELDS:
        a, b = getattr(r, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        if f in EXACT:
            np.testing.assert_array_equal(host(b), np.asarray(a), err_msg=f)
        else:
            np.testing.assert_allclose(host(b), np.asarray(a),
                                       rtol=TABLE_RTOL, atol=0, err_msg=f)
    for view in ("table", "table_forecast"):
        np.testing.assert_allclose(host(getattr(t, view)),
                                   np.asarray(getattr(r, view)),
                                   rtol=TABLE_RTOL, atol=0, err_msg=view)


GRIDS = {
    "default": lambda m, **kw: m.CarbonGrid.from_regions(**kw),
    "fully_connected": lambda m, **kw: m.CarbonGrid.fully_connected(
        latency_penalty=1.05, **kw),
    "pue_rtt": lambda m, **kw: m.CarbonGrid.fully_connected(
        latency_penalty=1.2, pue=np.array([1.1, 1.3, 1.0, 1.5]), rtt_s=0.07,
        **kw),
    "pue_hourly": lambda m, **kw: m.CarbonGrid.from_regions(
        pue=np.linspace(1.0, 1.4, 24), **kw),
    "two_days_forecast": lambda m, **kw: m.CarbonGrid.fully_connected(
        n_days=2, forecast_sigma_h=0.05, forecast_seed=3, **kw),
    "charging_core_ci": lambda m, **kw: m.CarbonGrid.from_regions(
        (m.RegionSpec("a", m.Grid.CISO, m.ChargingBehavior.NIGHTTIME),
         m.RegionSpec("b", m.Grid.RURAL, m.ChargingBehavior.INTELLIGENT,
                      core_ci=321.0)), **kw),
}


class TestCarbonGrid:
    @pytest.mark.parametrize("name", list(GRIDS))
    def test_constructors(self, name):
        r = GRIDS[name](r_ci)
        t = GRIDS[name](t_ci, device=CPU)
        assert_grid_equal(t, r)
        assert t.horizon_h == r.horizon_h and t.n_days == r.n_days

    @pytest.mark.parametrize("now_h", [0, 5, 30])
    def test_forecast_and_roll(self, now_h):
        r = r_ci.CarbonGrid.fully_connected(n_days=2)
        t = t_ci.CarbonGrid.fully_connected(n_days=2, device=CPU)
        r2 = r.forecast_from_actual(0.08, seed=11, now_h=now_h)
        t2 = t.forecast_from_actual(0.08, seed=11, now_h=now_h)
        assert_grid_equal(t2, r2)
        assert_grid_equal(t2.roll(now_h + 7), r2.roll(now_h + 7))
        assert t.roll(3) is t  # perfect forecasts: roll is the identity
        fc = np.asarray(r2.ci_forecast) * 0.9
        assert_grid_equal(t.with_forecast(fc), r.with_forecast(fc))

    def test_repeat_and_scaled_days(self):
        r = r_ci.CarbonGrid.from_regions().forecast_from_actual(0.04, seed=2)
        t = t_ci.CarbonGrid.from_regions(device=CPU).forecast_from_actual(
            0.04, seed=2)
        assert_grid_equal(t.repeat(3), r.repeat(3))
        scale = np.array([1.0, 0.7, 1.3], np.float32)
        assert_grid_equal(t.repeat(3).scaled_days(scale),
                          r.repeat(3).scaled_days(scale))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert_grid_equal(t.repeat(2, day_scale=[1.0, 0.5]),
                              r.repeat(2, day_scale=[1.0, 0.5]))
        # every repeated day is bit for bit the original tables
        np.testing.assert_array_equal(host(t.repeat(2).table)[:, 24:],
                                      host(t.table))

    @pytest.mark.parametrize("n_sites,k,seed", [(16, 3, 0), (128, 8, 0),
                                                (40, 5, 7)])
    def test_from_sites(self, n_sites, k, seed):
        r = r_ci.CarbonGrid.from_sites(n_sites, k, seed=seed)
        t = t_ci.CarbonGrid.from_sites(n_sites, k, seed=seed, device=CPU)
        assert_grid_equal(t, r)
        assert t.k_neighbors == r.k_neighbors == k
        assert t.nbr_idx.dtype == torch.int32
        assert t_ci.site_regions(n_sites) == tuple(
            t_ci.RegionSpec(s.name, t_ci.Grid(int(s.grid)))
            for s in r_ci.site_regions(n_sites))

    def test_with_sparse_neighbors(self):
        r = r_ci.CarbonGrid.fully_connected(rtt_s=0.05)
        t = t_ci.CarbonGrid.fully_connected(rtt_s=0.05, device=CPU)
        assert_grid_equal(t.with_sparse_neighbors(),
                          r.with_sparse_neighbors())
        assert_grid_equal(t.with_sparse_neighbors(5),
                          r.with_sparse_neighbors(5))
        with pytest.raises(ValueError):
            t.with_sparse_neighbors(2)

    def test_validation_matches_reference(self):
        n = len(t_ci.DEFAULT_REGIONS)
        bad = [dict(adjacency=np.zeros((n, n), bool)),
               dict(adjacency=np.eye(n + 1, dtype=bool)),
               dict(latency_penalty=np.full((n, n), 2.0)),
               dict(rtt_s=np.full((n, n), 0.1)),
               dict(rtt_s=-np.ones((n, n)) + np.eye(n))]
        for kw in bad:
            with pytest.raises(ValueError):
                r_ci.CarbonGrid.from_regions(**kw)
            with pytest.raises(ValueError):
                t_ci.CarbonGrid.from_regions(device=CPU, **kw)
        with pytest.raises(ValueError):
            t_ci.CarbonGrid.from_sites(1, 1, device=CPU)
        with pytest.raises(ValueError):
            t_ci.CarbonGrid.from_sites(8, 8, device=CPU)

    def test_traces_budgets_and_device_move(self):
        r = r_ci.all_grid_traces()
        t = t_ci.all_grid_traces(device=CPU)
        np.testing.assert_array_equal(host(t.mix), np.asarray(r.mix))
        np.testing.assert_allclose(host(t.ci_hourly),
                                   np.asarray(r.ci_hourly), rtol=TABLE_RTOL)
        specs = (r_ci.RegionSpec("a", r_ci.Grid.CISO,
                                 power_budget_w=(1.0, 2.0, 3.0)),
                 r_ci.RegionSpec("b", r_ci.Grid.URBAN))
        t_specs = tuple(t_ci.RegionSpec(s.name, t_ci.Grid(int(s.grid)),
                                        power_budget_w=s.power_budget_w)
                        for s in specs)
        np.testing.assert_array_equal(t_ci.region_power_budgets(t_specs),
                                      r_ci.region_power_budgets(specs))
        g = t_ci.CarbonGrid.from_sites(8, 2, device=CPU)
        assert g.to(CPU).device.type == "cpu"
        assert_grid_equal(g.to(CPU), r_ci.CarbonGrid.from_sites(8, 2))


class TestStreams:
    """The port's numpy streams are the reference's, value for value."""

    @staticmethod
    def assert_stream_equal(t, r):
        for a, b in zip(t, r):
            if dataclasses.is_dataclass(b):
                for f in dataclasses.fields(b):
                    x, y = getattr(a, f.name), getattr(b, f.name)
                    assert (x is None) == (y is None), f.name
                    if y is not None:
                        np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("fn,args,kw", [
        ("diurnal_stream", (500, 4), dict(seed=3)),
        ("multi_region_stream", (700, 4), {}),
        ("multi_region_stream", (700, 128), dict(seed=1)),
        ("deferrable_stream", (600, 4), dict(batch_frac=0.3)),
        ("deferrable_stream_multiday", (600, 4), dict(n_days=3)),
        ("arrival_stream", (40.0, 24.0, 4), dict(
            seed=2, spike_at_h=12.0, spike_mult=3.0, batch_frac=0.2)),
    ])
    def test_stream_copy_equals_reference(self, fn, args, kw):
        self.assert_stream_equal(getattr(t_streams, fn)(*args, **kw),
                                 getattr(r_streams, fn)(*args, **kw))

    def test_grid_streams_equal_reference(self):
        r_g = r_ci.CarbonGrid.from_sites(12, 3, seed=1, n_days=2)
        t_g = t_ci.CarbonGrid.from_sites(12, 3, seed=1, n_days=2,
                                         device=CPU)
        kw = dict(seed=4, curtail_region=2, curtail_floor=0.1)
        r_out = r_streams.grid_event_stream(300, r_g, **kw)
        t_out = t_streams.grid_event_stream(300, t_g, **kw)
        self.assert_stream_equal(t_out[:3], r_out[:3])
        assert_grid_equal(t_out[3], r_out[3])
        np.testing.assert_array_equal(t_out[4], r_out[4])
        r_fs = r_streams.forecast_scenario(200, r_ci.DEFAULT_REGIONS)
        t_fs = t_streams.forecast_scenario(200, t_ci.DEFAULT_REGIONS,
                                           device=CPU)
        self.assert_stream_equal(t_fs[:3], r_fs[:3])
        assert_grid_equal(t_fs[3], r_fs[3])


class TestSegmentRanks:
    @pytest.mark.parametrize("n,n_seg,width,seed", [
        (1, 1, 3, 0), (257, 5, 3, 1), (3000, 24, 12, 2), (5000, 96, 7, 3),
        (2500, 24, 384, 4)])
    def test_windowed_segment_ranks(self, n, n_seg, width, seed):
        rng = np.random.default_rng(seed)
        seg = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
        choice = rng.integers(0, width, n).astype(np.int32)
        active = rng.random(n) < 0.7
        cell = seg * width + choice
        starts = np.searchsorted(seg, np.arange(n_seg)).astype(np.int32)
        ends = np.concatenate([starts[1:], [n]]).astype(np.int32)
        r_rank, r_tot = r_pl.windowed_segment_ranks(
            jnp.asarray(choice), jnp.asarray(active), jnp.asarray(cell),
            jnp.asarray(starts), jnp.asarray(ends), width)
        t_rank, t_tot = t_pl.windowed_segment_ranks(
            *(torch.as_tensor(a) for a in (choice, active, cell, starts,
                                           ends)), width)
        assert t_rank.dtype == torch.int32 and t_tot.dtype == torch.int32
        np.testing.assert_array_equal(host(t_rank), np.asarray(r_rank))
        np.testing.assert_array_equal(host(t_tot), np.asarray(r_tot))
        # against a direct count: rank = earlier active rows of the cell
        want = np.zeros(n, np.int64)
        seen = {}
        for i in range(n):
            want[i] = seen.get(cell[i], 0)
            if active[i]:
                seen[cell[i]] = want[i] + 1
        np.testing.assert_array_equal(host(t_rank)[active], want[active])
        np.testing.assert_array_equal(
            host(t_tot), np.bincount(cell[active], minlength=n_seg * width))

    def test_prefix_count_blocks_are_exact(self):
        from repro_torch.serve.policy import prefix_count
        rng = np.random.default_rng(5)
        x = torch.as_tensor(rng.integers(0, 3, (5000, 7)).astype(np.int32))
        got = prefix_count(x, block=64)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(host(got), np.cumsum(host(x), axis=0))


@pytest.fixture(scope="module")
def factor_inputs():
    cfg_r, cfg_t = r_get_config(ARCH), t_get_config(ARCH)
    batch, region, t_hours = r_streams.deferrable_stream(3000, 4, seed=5)
    hour = np.floor(t_hours).astype(np.int32) % 24
    r_grid = r_ci.CarbonGrid.fully_connected()
    t_grid = t_ci.CarbonGrid.fully_connected(device=CPU)
    r_inf, t_inf = r_pack(r_tpu()), t_pack(t_tpu(), device=CPU)
    return dict(
        r_w=batch.workload(cfg_r), t_w=torch_batch(batch).workload(
            cfg_t, device=CPU),
        r_ci=r_grid.table[region, hour],
        t_ci=t_grid.table[torch.as_tensor(region).long(),
                          torch.as_tensor(hour).long()],
        avail=batch.available, r_inf=r_inf, t_inf=t_inf,
        interference=(1.2, 1.0, 1.5), net_slowdown=(1.0, 2.0))


class TestFactorized:
    def test_route_many_envs(self, factor_inputs):
        d = factor_inputs
        env = lambda m, ci: m.Environment(
            ci=ci, interference=jnp.asarray(d["interference"], jnp.float32)
            if m is r_cm else torch.tensor(d["interference"]),
            net_slowdown=jnp.asarray(d["net_slowdown"], jnp.float32)
            if m is r_cm else torch.tensor(d["net_slowdown"]))
        r = jax.jit(r_cm.route_many_envs)(d["r_w"], d["r_inf"],
                                          env(r_cm, d["r_ci"]),
                                          jnp.asarray(d["avail"]))
        t = t_cm.route_many_envs(d["t_w"], d["t_inf"], env(t_cm, d["t_ci"]),
                                 torch.as_tensor(d["avail"]))
        for f in ("target", "target_latency", "target_energy", "ok"):
            np.testing.assert_array_equal(host(getattr(t, f)),
                                          np.asarray(getattr(r, f)))
        for f in ("total_cf", "latency"):
            np.testing.assert_allclose(host(getattr(t, f)),
                                       np.asarray(getattr(r, f)), rtol=RTOL)

    def test_energy_factors_and_scores(self, factor_inputs):
        d = factor_inputs
        rf = jax.jit(r_cm.energy_factors_batch)(
            d["r_w"], d["r_inf"], jnp.asarray(d["interference"]),
            jnp.asarray(d["net_slowdown"]))
        tf = t_cm.energy_factors_batch(d["t_w"], d["t_inf"],
                                       d["interference"], d["net_slowdown"])
        for f in ("op_unit", "emb_cf", "latency", "t_comm"):
            np.testing.assert_allclose(host(getattr(tf, f)),
                                       np.asarray(getattr(rf, f)), rtol=RTOL,
                                       err_msg=f)
        np.testing.assert_allclose(host(tf.energy_j), np.asarray(rf.energy_j),
                                   rtol=RTOL)
        np.testing.assert_allclose(
            host(t_cm.total_cf_from_factors(tf, d["t_ci"])),
            np.asarray(r_cm.total_cf_from_factors(rf, d["r_ci"])), rtol=RTOL)
        avail_r, avail_t = jnp.asarray(d["avail"]), torch.as_tensor(
            d["avail"])
        r = r_cm.route_many_from_factors(rf, d["r_w"], d["r_ci"], avail_r)
        t = t_cm.route_many_from_factors(tf, d["t_w"], d["t_ci"], avail_t)
        for f in ("target", "target_latency", "target_energy", "ok"):
            np.testing.assert_array_equal(host(getattr(t, f)),
                                          np.asarray(getattr(r, f)))
        hops = np.random.default_rng(0).uniform(0.0, 3.0, (4, 3000)).astype(
            np.float32)
        np.testing.assert_array_equal(
            host(t_cm.qos_feasible_from_factors(tf, d["t_w"],
                                                torch.as_tensor(hops[0]))),
            np.asarray(r_cm.qos_feasible_from_factors(rf, d["r_w"],
                                                      jnp.asarray(hops[0]))))
        np.testing.assert_array_equal(
            host(t_cm.pair_qos_feasible_from_factors(
                tf, d["t_w"], torch.as_tensor(hops))),
            np.asarray(r_cm.pair_qos_feasible_from_factors(
                rf, d["r_w"], jnp.asarray(hops))))

    def test_gate_hop_broken(self, factor_inputs):
        """The learned policies' WAN-hop gate (ported ahead of them)
        refuses exactly the reference's candidates."""
        from repro.serve.policy import _gate_hop_broken as r_gate
        from repro_torch.serve.policy import _gate_hop_broken as t_gate

        d = factor_inputs
        rf = r_cm.energy_factors_batch(d["r_w"], d["r_inf"], jnp.ones(3),
                                       jnp.ones(2))
        tf = t_cm.energy_factors_batch(d["t_w"], d["t_inf"], (1.0,) * 3,
                                       (1.0,) * 2)
        rng = np.random.default_rng(2)
        s2 = rng.standard_normal((3000, 3)).astype(np.float32)
        s3 = rng.standard_normal((4, 3000, 3)).astype(np.float32)
        hop1 = rng.uniform(0.0, 20.0, 3000).astype(np.float32)
        hop2 = rng.uniform(0.0, 20.0, (4, 3000)).astype(np.float32)
        for s, hop in ((s2, hop1), (s3, hop2), (s2, None), (s2, 0.0)):
            r = r_gate(jnp.asarray(s), rf, d["r_w"],
                       None if hop is None or np.ndim(hop) == 0
                       else jnp.asarray(hop))
            t = t_gate(torch.as_tensor(s), tf, d["t_w"],
                       hop if hop is None or np.ndim(hop) == 0
                       else torch.as_tensor(hop))
            np.testing.assert_array_equal(host(t), np.asarray(r))
        assert np.isinf(host(t_gate(torch.as_tensor(s3), tf, d["t_w"],
                                    torch.as_tensor(hop2)))).any()

    def test_forecast_risk_helpers(self):
        lead = np.arange(-1, 14, dtype=np.float32)
        r = r_cm.forecast_risk_scale(jnp.asarray(lead), 0.05, 1.5)
        t = t_cm.forecast_risk_scale(torch.as_tensor(lead), 0.05, 1.5)
        np.testing.assert_array_equal(host(t), np.asarray(r))
        rng = np.random.default_rng(1)
        home = rng.uniform(50, 500, (7, 5)).astype(np.float32)
        dc = rng.uniform(50, 500, (3, 7, 3)).astype(np.float32)
        rh, rd = r_cm.inflate_ci_risk(jnp.asarray(home), jnp.asarray(dc), 1.3)
        th, td = t_cm.inflate_ci_risk(torch.as_tensor(home),
                                      torch.as_tensor(dc), 1.3)
        np.testing.assert_array_equal(host(th), np.asarray(rh))
        np.testing.assert_array_equal(host(td), np.asarray(rd))

    def test_optimal_targets_all_metrics(self, factor_inputs):
        d = factor_inputs
        mk = lambda m, ci: m.Environment.make(
            *[float(x) for x in np.asarray(ci)[[0, 1, 3, 4]]],
            **({} if m is r_cm else dict(device=CPU)))
        for i in (0, 17, 999):
            row = lambda w, m: type(w)(*[getattr(w, f.name)[i] for f in
                                         dataclasses.fields(w)])
            r = r_cm.optimal_targets_all_metrics(
                row(d["r_w"], r_cm), d["r_inf"], mk(r_cm, d["r_ci"][i]),
                jnp.asarray(d["avail"][i]))
            t = t_cm.optimal_targets_all_metrics(
                row(d["t_w"], t_cm), d["t_inf"], mk(t_cm, host(d["t_ci"])[i]),
                torch.as_tensor(d["avail"][i]))
            for k in ("carbon", "energy", "latency", "feasible"):
                np.testing.assert_array_equal(host(t[k]), np.asarray(r[k]))
