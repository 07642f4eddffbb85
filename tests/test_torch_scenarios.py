"""The port's scenario matrix (``serve/scenarios.py``) and its entry point
(``launch/scenario_matrix.py``) against the JAX reference, on the CPU:
every one of the 21 (scenario, policy) cells of ``run_matrix`` at a small
stream (integers and rates exactly, carbon within rtol 1e-5), each
scenario's build bit for bit (stream, grid, caps), the watt caps never
exceeded, the three gates, ``mesh=`` refused, and the README's scenario
table (n = 2000) from the port alone."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import scenarios as r_sc  # noqa: E402

from repro_torch.launch import scenario_matrix as t_launch  # noqa: E402
from repro_torch.serve import scenarios as t_sc  # noqa: E402

from torch_fleet_parity import CPU, RTOL, one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

SMALL = 160  # the reference's small-but-nondegenerate stream
CELLS = [(s, p) for s in r_sc.default_scenarios()
         for p in r_sc.default_policies()]
INT_FIELDS = ("scenario", "policy", "n", "shed_rate", "spill_rate",
              "defer_rate")
FLOAT_FIELDS = ("total_g", "routed_g", "latency_opt_g", "mean_defer_h")


@pytest.fixture(scope="module")
def matrices():
    """Both packages' whole matrix at ``SMALL``, once per module."""
    r_cells = r_sc.run_matrix(n=SMALL)
    t_cells = t_sc.run_matrix(n=SMALL, device=CPU)
    key = lambda c: (c.scenario, c.policy)
    return ({key(c): c for c in r_cells}, {key(c): c for c in t_cells},
            r_cells, t_cells)


@pytest.mark.parametrize("scenario,policy", CELLS,
                         ids=[f"{s}/{p}" for s, p in CELLS])
def test_matrix_cell_matches_reference(matrices, scenario, policy):
    r_by, t_by, _, _ = matrices
    want, got = r_by[(scenario, policy)], t_by[(scenario, policy)]
    for f in INT_FIELDS:  # rates are ratios of equal integer counts
        assert getattr(got, f) == getattr(want, f), f
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=0, err_msg=f)


def test_matrix_order_and_csv(matrices):
    _, _, r_cells, t_cells = matrices
    assert [(c.scenario, c.policy) for c in t_cells] == CELLS
    assert t_sc.matrix_csv(t_cells) == r_sc.matrix_csv(r_cells)


def test_registries_match_reference():
    r_s, t_s = r_sc.default_scenarios(), t_sc.default_scenarios()
    assert list(t_s) == list(r_s)
    for name in r_s:
        a, b = dataclasses.asdict(r_s[name]), dataclasses.asdict(t_s[name])
        assert repr(a) == repr(b), name
    assert list(t_sc.default_policies()) == list(r_sc.default_policies())


@pytest.mark.parametrize("name", list(r_sc.default_scenarios()))
def test_scenario_build_bit_identical(name):
    """Stream, grid (actuals and forecast) and caps equal the reference's
    bit for bit; the port builds its grid on the CPU."""
    want = r_sc.default_scenarios()[name].build(SMALL)
    got = t_sc.default_scenarios()[name].build(SMALL)
    for f in dataclasses.fields(want.batch):
        a, b = getattr(want.batch, f.name), getattr(got.batch, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=f.name)
    np.testing.assert_array_equal(got.region, want.region)
    np.testing.assert_array_equal(got.t_hours, want.t_hours)
    assert got.grid.device == torch.device(CPU)
    for f in ("ci_hourly", "ci_forecast", "ci_mobile", "ci_core", "pue",
              "adjacency", "latency_penalty", "rtt_s"):
        a, b = getattr(want.grid, f), getattr(got.grid, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f)
    assert got.caps.dtype == want.caps.dtype
    np.testing.assert_array_equal(got.caps, want.caps)
    assert [dataclasses.astuple(r) for r in got.regions] == [
        dataclasses.astuple(r) for r in want.regions]
    assert dataclasses.asdict(got.fleet) == dataclasses.asdict(want.fleet)


def test_scenario_build_is_seeded():
    s = t_sc.default_scenarios()["flash_crowd_10x"]
    r1, r2 = s.build(SMALL), s.build(SMALL)
    np.testing.assert_array_equal(r1.t_hours, r2.t_hours)
    assert torch.equal(r1.grid.ci_hourly, r2.grid.ci_hourly)
    r3 = dataclasses.replace(s, seed=9).build(SMALL)
    assert len(r3.t_hours) != len(r1.t_hours) or not np.array_equal(
        r3.t_hours, r1.t_hours)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["oracle-immediate", "temporal-defer"])
def test_watt_caps_never_exceeded(seed, policy):
    scenario = dataclasses.replace(
        t_sc.default_scenarios()["hetero_fleet_watt"], seed=seed)
    res, state, run = t_sc.route_scenario(
        scenario, t_sc.default_policies()[policy], n=SMALL, device=CPU)
    v = t_sc.caps_violation(res, state, run.t_hours, run.caps,
                            run.grid.horizon_h)
    assert v <= 0.0
    # the same count from host copies of the tensors
    host = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x
    h_res = dataclasses.replace(res, target=host(res.target),
                                exec_region=host(res.exec_region))
    h_state = dataclasses.replace(state, **{
        f.name: host(getattr(state, f.name))
        for f in dataclasses.fields(state)})
    assert t_sc.caps_violation(h_res, h_state, run.t_hours, run.caps,
                               run.grid.horizon_h) == v


@pytest.mark.parametrize("policy", ["oracle-immediate", "temporal-defer"])
def test_zero_ci_scenario_scores_finite(policy):
    res, _, _ = t_sc.route_scenario(
        t_sc.default_scenarios()["curtailment_zero_ci"],
        t_sc.default_policies()[policy], n=SMALL, device=CPU)
    carbon = res.carbon_g.numpy()
    assert np.isfinite(carbon).all() and (carbon >= 0.0).all()
    assert np.isfinite(float(res.total_carbon_g))


class TestGates:
    """The entry point's three gates pass at a small stream, as the
    reference's benchmark gates do."""

    def test_curtailment_chase(self, matrices):
        _, _, _, t_cells = matrices
        out = t_launch.curtailment_gate(t_cells, SMALL, device=CPU)
        assert out["landed_in_window"] > 0
        assert out["defer_g"] < out["immediate_g"]

    def test_spike_aware(self):
        out = t_launch.spike_aware_gate(600, device=CPU)
        assert out["aware_shed"] < out["blind_shed"]
        assert out["aware_g"] <= out["static_g"]
        assert out["ledger_prestage_scale"] < 1.0

    def test_watt_caps(self):
        out = t_launch.watt_caps_gate(SMALL, device=CPU)
        assert out["seeds"] == 3 and out["worst_excess"] <= 0.0

    def test_gate_raises_when_it_fails(self, matrices):
        _, _, _, t_cells = matrices
        flipped = [dataclasses.replace(c, total_g=-c.total_g)
                   if c.policy == "oracle-immediate" else c for c in t_cells]
        with pytest.raises(AssertionError, match="must beat"):
            t_launch.curtailment_gate(flipped, SMALL, device=CPU)


def test_entry_point_runs_and_writes_the_csv(tmp_path):
    path = tmp_path / "matrix.csv"
    run = t_launch.main(["--device", "cpu", "--n", str(SMALL), "--csv",
                         str(path)])
    assert len(run.cells) == len(CELLS) and len(run.walls_s) == len(CELLS)
    assert set(run.gates) == {"curtailment_chase", "spike_aware",
                              "watt_caps"}
    assert path.read_text() == t_sc.matrix_csv(run.cells) + "\n"
    # the README's mesoscale table: provisioned, slo_0.02, static, oracle
    assert [p.server_hours for p in run.mesoscale["plans"]] == [
        5788, 5257, 6144, 5788]
    serve = run.mesoscale["serve"]
    assert len(serve.shed) == run.mesoscale["n"] == t_launch.MESO_N


def test_mesoscale_plans_take_any_stream_size():
    """``mesoscale_plans`` builds the four plans at any n (the chip run
    uses 1M); above the pin's 20k, demand-shaped provisioning still beats
    static over-provisioning."""
    m = t_launch.mesoscale_plans(30_000, device=CPU)
    assert len(m.stream[1]) == 30_000 and m.router.device.type == "cpu"
    assert m.provisioned.server_hours <= m.static.server_hours
    assert m.provisioned.total_carbon_g < m.static.total_carbon_g
    assert m.slo.total_carbon_g <= m.oracle.total_carbon_g


def test_mesh_is_item_9():
    scenario = t_sc.default_scenarios()["steady_diurnal"]
    factory = t_sc.default_policies()["oracle-immediate"]
    with pytest.raises(NotImplementedError, match="item 9"):
        t_sc.route_scenario(scenario, factory, n=SMALL, mesh=object(),
                            device=CPU)
    with pytest.raises(NotImplementedError, match="item 9"):
        t_sc.run_matrix({"steady_diurnal": scenario}, n=SMALL,
                        mesh=object(), device=CPU)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("the host has a CUDA device: the default does not raise")
    scenario = t_sc.default_scenarios()["steady_diurnal"]
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sc.route_scenario(scenario,
                            t_sc.default_policies()["oracle-immediate"],
                            n=SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_launch.main(["--n", str(SMALL)])


#: README "Scenario matrix": total gCO2 per policy at n ~ 2000 requests
#: per scenario (oracle-immediate, temporal-defer, latency-greedy), to the
#: digits it prints
README_TABLE = {
    "steady_diurnal": ("34.07", "35.78", "35.66"),
    "flash_crowd_10x": ("182.98", "186.93", "183.46"),
    "curtailment_midday": ("0.433", "0.373", "0.578"),
    "curtailment_zero_ci": ("0.429", "0.369", "0.577"),
    "ci_step_evening": ("41.08", "36.51", "42.72"),
    "hetero_fleet_watt": ("0.477", "0.451", "0.634"),
    "multiday_forecast": ("34.05", "25.31", "34.16"),
}


@pytest.fixture(scope="module")
def readme_matrix():
    return t_sc.run_matrix(n=2000, device=CPU)


@pytest.mark.parametrize("name", list(README_TABLE))
def test_readme_scenario_table(readme_matrix, name):
    got = tuple(f"{c.total_g:.2f}" if c.total_g >= 1 else f"{c.total_g:.3f}"
                for c in readme_matrix if c.scenario == name)
    assert got == README_TABLE[name]
    if name == "flash_crowd_10x":
        assert {c.n for c in readme_matrix if c.scenario == name} == {4728}
