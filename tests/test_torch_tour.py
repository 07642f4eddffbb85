"""The port's ten-act serving tour (``repro_torch.launch.tour``) on the
CPU: it runs to the end at 4,000 requests, and its headlines of act 1 (the
per-hour tier histograms of three request classes), act 2 (the
fleet-routed diurnal stream) and act 10 (the scenario matrix) equal the
reference's ``GreenScaleRouter``, ``FleetRouter`` and ``run_matrix`` at the
same n: counts and rates exactly, carbon within rtol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.core import ChargingBehavior, Grid  # noqa: E402
from repro.core import grid_trace, mobile_carbon_intensity  # noqa: E402
from repro.core.carbon_model import Environment  # noqa: E402
from repro.serve import router as r_router  # noqa: E402
from repro.serve import scenarios as r_sc  # noqa: E402
from repro.serve import streams as r_streams  # noqa: E402

from repro_torch.launch import tour as t_tour  # noqa: E402

from torch_fleet_parity import ARCH, RTOL, one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

N = 4000


@pytest.fixture(scope="module")
def tour():
    return t_tour.main(["--device", "cpu", "--requests", str(N)])


def test_every_act_ran(tour):
    assert tour.requests == N and tour.device == "cpu"
    assert sorted(tour.acts) == list(range(1, 11))
    assert all(sum(h.values()) == 24 for h in tour.acts[1].values())
    assert tour.acts[3]["tokens"].shape == (4, 8)
    assert tour.acts[8]["spent_h"] <= tour.acts[8]["earned_h"] + 1e-9
    assert tour.acts[9]["static_g"] >= tour.acts[9]["oracle_g"]


def test_act1_tier_shifts_match_reference(tour):
    """The reference tour's act 1, line for line: each class's 24 hourly
    decisions under CISO's hour and mean CI land in the same tiers."""
    router = r_router.GreenScaleRouter(r_get_config(ARCH))
    ciso, rural = grid_trace(Grid.CISO), grid_trace(Grid.RURAL)
    ci_mob = float(mobile_carbon_intensity(ChargingBehavior.AVERAGE, ciso))
    requests = [
        r_router.Request(prompt_tokens=64, max_new_tokens=32,
                         latency_budget_s=1.0),
        r_router.Request(prompt_tokens=2048, max_new_tokens=512,
                         latency_budget_s=20.0),
        r_router.Request(prompt_tokens=16384, max_new_tokens=64,
                         latency_budget_s=30.0),
    ]
    day = {ri: [] for ri in range(len(requests))}
    for hour in range(24):
        env = Environment.make(
            ci_mob, float(rural.ci_hourly[hour]),
            float(ciso.ci_hourly.mean()), float(ciso.ci_hourly[hour]))
        for ri, d in enumerate(router.route_batch(requests, env)):
            day[ri].append(d.target)
    want = {ri: {t_tour.TARGETS[t]: day[ri].count(t) for t in range(3)}
            for ri in day}
    assert tour.acts[1] == want


def test_act2_fleet_route_matches_reference(tour):
    fr = r_router.FleetRouter(r_get_config(ARCH))
    batch, region, t_hours = r_streams.diurnal_stream(N, len(fr.regions),
                                                      seed=0)
    res = fr.route_stream(batch, region, t_hours)
    got = tour.acts[2]
    np.testing.assert_array_equal(got["counts"], np.asarray(res.counts))
    for k in ("total_carbon_g", "latency_opt_carbon_g",
              "energy_opt_carbon_g"):
        np.testing.assert_allclose(got[k], float(getattr(res, k)),
                                   rtol=RTOL, err_msg=k)
    # the savings are differences of the sums above: hold them to the
    # sums' own tolerance
    for k, base in (("saved_vs_latency_g", "latency_opt_carbon_g"),
                    ("saved_vs_energy_g", "energy_opt_carbon_g")):
        np.testing.assert_allclose(got[k], float(getattr(res, k)), rtol=0,
                                   atol=2 * RTOL * float(getattr(res, base)),
                                   err_msg=k)
    # act 3 admits the edge-DC slice of the same routed stream
    target = np.asarray(res.target)
    assert tour.acts[3]["admitted"] == int((target == 1).sum())


def test_act10_matrix_matches_reference(tour):
    got = tour.acts[10]
    names = ("curtailment_midday", "flash_crowd_10x", "hetero_fleet_watt")
    want = r_sc.run_matrix(
        {k: v for k, v in r_sc.default_scenarios().items() if k in names},
        r_sc.default_policies(), n=got["n"])
    assert got["n"] == 200
    assert len(got["cells"]) == len(want) == 9
    for a, b in zip(got["cells"], want):
        for f in ("scenario", "policy", "n", "shed_rate", "spill_rate",
                  "defer_rate"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("total_g", "routed_g", "latency_opt_g", "mean_defer_h"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, atol=0, err_msg=f)
    best = {}
    for c in want:
        if c.scenario not in best or c.total_g < best[c.scenario].total_g:
            best[c.scenario] = c
    assert got["winners"] == {k: c.policy for k, c in best.items()}


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("the host has a CUDA device: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_tour.main(["--requests", "10"])
