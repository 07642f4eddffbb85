"""The port's paper workload tables, mix perturbation, runtime variance and
tier envelopes against the JAX reference, on the CPU: every table entry
field by field, ``perturb_mix`` and ``sample`` on the reference's own draws
(fed to the port as arguments), the scenario multipliers and the
envelopes' arithmetic. Floats within rtol 1e-5 unless they are data
(then bit for bit)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import carbon_intensity as r_ci  # noqa: E402
from repro.core import infrastructure as r_inf  # noqa: E402
from repro.core import runtime_variance as r_rv  # noqa: E402
from repro.core import workloads as r_wl  # noqa: E402

from repro_torch.core import carbon_intensity as t_ci  # noqa: E402
from repro_torch.core import infrastructure as t_inf  # noqa: E402
from repro_torch.core import runtime_variance as t_rv  # noqa: E402
from repro_torch.core import workloads as t_wl  # noqa: E402

CPU = "cpu"
RTOL = 1e-5
FIELDS = [f.name for f in dataclasses.fields(t_wl.Workload)]
TABLES = ("AI_WORKLOADS", "GAME_WORKLOADS", "ARVR_WORKLOADS",
          "ALL_PAPER_WORKLOADS")


def _assert_workload_equal(t_w, r_w):
    for f in FIELDS:
        got = getattr(t_w, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(r_w, f)),
                                      err_msg=f)


class TestTables:
    @pytest.mark.parametrize("table", TABLES)
    def test_every_entry_field_by_field(self, table):
        r_tab, t_tab = getattr(r_wl, table), getattr(t_wl, table)
        assert [i.name for i in t_tab] == [i.name for i in r_tab]
        for r_i, t_i in zip(r_tab, t_tab):
            assert type(t_i).__name__ == type(r_i).__name__
            assert int(t_i.category) == int(r_i.category)
            assert t_i.category.name == r_i.category.name
            assert t_i.available_targets == r_i.available_targets
            assert t_i.device == r_i.device
            np.testing.assert_array_equal(t_i.avail_mask.numpy(),
                                          np.asarray(r_i.avail_mask))
            _assert_workload_equal(t_i.workload, r_i.workload)
            assert t_i.workload.flops.device.type == "cpu"
            if isinstance(r_i, r_wl.ARVRInfo):
                assert t_i.stage_flops_frac == r_i.stage_flops_frac
                assert t_i.stage_bytes == r_i.stage_bytes

    def test_category_enum_and_helpers(self):
        assert {c.name: int(c) for c in t_wl.Category} == \
            {c.name: int(c) for c in r_wl.Category}
        assert t_wl._kb(540.47) == r_wl._kb(540.47)
        assert t_wl._mb(3.2) == r_wl._mb(3.2)

    @pytest.mark.parametrize("name", ["resnet50", "bert", "fortnite",
                                      "vr-3d-world-sponza", "ar-demo"])
    def test_by_name(self, name):
        assert t_wl.by_name(name).name == r_wl.by_name(name).name == name
        _assert_workload_equal(t_wl.by_name(name).workload,
                               r_wl.by_name(name).workload)

    def test_by_name_unknown_raises(self):
        with pytest.raises(KeyError):
            t_wl.by_name("no-such-workload")

    def test_stack_workloads_mixes_infos_and_bare(self):
        r_in = list(r_wl.ALL_PAPER_WORKLOADS[:3]) + [
            r_wl.ARVR_WORKLOADS[0].workload]
        t_in = list(t_wl.ALL_PAPER_WORKLOADS[:3]) + [
            t_wl.ARVR_WORKLOADS[0].workload]
        got = t_wl.stack_workloads(t_in, device=CPU)
        assert got.flops.shape == (4,)
        _assert_workload_equal(got, r_wl.stack_workloads(r_in))

    def test_stack_workloads_default_device_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device: the default is valid")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_wl.stack_workloads(t_wl.AI_WORKLOADS)

    def test_lm_workload(self):
        kw = dict(flops_per_token=2 * 1.8e9, params_bytes=3.6e9, seq_len=512,
                  new_tokens=64, latency_req=2.0)
        _assert_workload_equal(t_wl.lm_workload(**kw, device=CPU),
                               r_wl.lm_workload(**kw))


class TestMix:
    @pytest.mark.parametrize("grid", list(r_ci.Grid))
    def test_ci_of_mix(self, grid):
        mix = r_ci.grid_trace(grid).mix
        got = t_ci.ci_of_mix(torch.from_numpy(np.array(mix)))
        np.testing.assert_allclose(got.numpy(), np.asarray(r_ci.ci_of_mix(mix)),
                                   rtol=RTOL)

    @pytest.mark.parametrize("grid,n,scale", [(r_ci.Grid.CISO, 16, 0.168),
                                              (r_ci.Grid.RURAL, 8, 0.4)])
    def test_perturb_mix_on_the_reference_draws(self, grid, n, scale):
        """The reference's own Beta and uniform draws (same keys, same
        split) fed to the port give the reference's mixes."""
        mix = r_ci.grid_trace(grid).mix
        key = jax.random.PRNGKey(7)
        want = r_ci.perturb_mix(key, mix, n_samples=n, scale=scale)
        k_solar, k_wind = jax.random.split(key)
        shape = (n,) + mix.shape[:-1]
        beta = np.asarray(jax.random.beta(k_solar, 5.0, 5.0, shape))
        u = np.asarray(jax.random.uniform(k_wind, shape, minval=1e-6))
        got = t_ci.perturb_mix(torch.from_numpy(np.array(mix)),
                               torch.from_numpy(beta), torch.from_numpy(u),
                               scale)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-7)

    def test_perturb_mix_keeps_mixes_normalized(self):
        mix = t_ci.grid_trace(t_ci.Grid.NYISO, device=CPU).mix
        rng = np.random.default_rng(3)
        shape = (32,) + tuple(mix.shape[:-1])
        out = t_ci.perturb_mix(mix, torch.from_numpy(rng.beta(5, 5, shape)),
                               torch.from_numpy(rng.uniform(1e-6, 1, shape)))
        assert out.shape == (32,) + tuple(mix.shape)
        np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, rtol=1e-5)
        assert (out >= 0).all()
        assert not torch.allclose(out[0], out[1])  # the samples differ


class TestRuntimeVariance:
    def test_enum(self):
        assert {s.name: int(s) for s in t_rv.VarianceScenario} == \
            {s.name: int(s) for s in r_rv.VarianceScenario}

    @pytest.mark.parametrize("s", list(r_rv.VarianceScenario))
    def test_scenario_multipliers(self, s):
        ti, tn = t_rv.scenario_multipliers(int(s), device=CPU)
        ri, rn = r_rv.scenario_multipliers(s)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))

    def test_all_scenario_multipliers(self):
        ti, tn = t_rv.all_scenario_multipliers(device=CPU)
        ri, rn = r_rv.all_scenario_multipliers()
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))

    def test_stochastic_default(self):
        t, r = (t_rv.StochasticVariance.default(device=CPU),
                r_rv.StochasticVariance.default())
        for f in ("sigma_comp", "p_weak", "weak_scale", "sigma_core"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(r, f)))

    @pytest.mark.parametrize("seed", [0, 1, 5, 11])
    def test_sample_on_the_reference_draws(self, seed):
        sv_r = r_rv.StochasticVariance.default()
        key = jax.random.PRNGKey(seed)
        want_i, want_n = r_rv.sample(key, sv_r)
        k1, k2, k3 = jax.random.split(key, 3)
        z_comp = np.asarray(jax.random.normal(k1, (3,)))
        weak = np.asarray(jax.random.bernoulli(k2, sv_r.p_weak))
        z_core = np.asarray(jax.random.normal(k3, ()))
        got_i, got_n = t_rv.sample(t_rv.StochasticVariance.default(device=CPU),
                                   torch.from_numpy(z_comp),
                                   torch.as_tensor(weak),
                                   torch.as_tensor(z_core))
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i),
                                   rtol=RTOL)
        np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n),
                                   rtol=RTOL)
        assert (got_i >= 1).all() and (got_n >= 1).all()


class TestEnvelopes:
    @pytest.mark.parametrize("name", ["tpu_envelope", "paper_envelope"])
    def test_envelope_data(self, name):
        t, r = getattr(t_inf, name)(), getattr(r_inf, name)()
        assert (t.name, t.tdp_w, t.vram_bytes) == (r.name, r.tdp_w,
                                                   r.vram_bytes)

    @pytest.mark.parametrize("name", ["tpu_envelope", "paper_envelope"])
    def test_servers_for_power_and_kv_slots(self, name):
        t, r = getattr(t_inf, name)(), getattr(r_inf, name)()
        budgets = np.array([[np.inf, 5e3, 2e5], [10.0, np.inf, 1e9],
                            [0.0, 693.5, 7e3]])
        np.testing.assert_array_equal(t.servers_for_power(budgets),
                                      r.servers_for_power(budgets))
        for tier in range(3):
            for slot in (1e6, 2.5e8, 3e9, 1e12):
                assert t.kv_slots(tier, slot) == r.kv_slots(tier, slot)

    def test_validation_and_unbounded_vram(self):
        env = t_inf.TierEnvelope("x", (1.0, 0.0, 1.0),
                                 (np.inf, 1e9, 1e9))
        with pytest.raises(ValueError, match="tdp_w"):
            env.servers_for_power([1.0, 1.0, 1.0])
        assert env.kv_slots(0, 1e6) is None
        with pytest.raises(ValueError, match="slot_bytes"):
            env.kv_slots(1, 0.0)
        assert env.kv_slots(1, 1e12) == 1  # a server that exists serves
