"""Shared helpers of the decide-half and serving-loop parity tests
(``test_torch_grid.py``, ``test_torch_fleet.py``, ``test_torch_temporal.py``,
``test_torch_learned.py``, ``test_torch_forecast.py``,
``test_torch_queue.py``, ``test_torch_online.py``): the same numpy stream
through a reference ``repro`` router and a port ``repro_torch`` router on
the CPU. Integer outputs must match exactly and carbon within
rtol 1e-5 (ROADMAP.md's parity bar)."""

import dataclasses

import numpy as np

from repro_torch.serve import router as t_router

RTOL = 1e-5
CPU = "cpu"
ARCH = "h2o-danube-1.8b"


def host(x):
    """A port tensor (or None) as a numpy array."""
    return None if x is None else x.detach().cpu().numpy()


def torch_batch(batch) -> t_router.RequestBatch:
    """A reference (or port) ``RequestBatch`` as the port's."""
    return t_router.RequestBatch(**{
        f.name: getattr(batch, f.name)
        for f in dataclasses.fields(t_router.RequestBatch)})


def dc_caps(n: int, n_regions: int, frac: float) -> np.ndarray:
    """Both DC tiers capped at ``frac * n / (R * 24)`` per cell (the
    benchmark's overload caps); mobile uncapped."""
    caps = np.full((n_regions, 3), np.inf)
    caps[:, 1] = caps[:, 2] = max(1.0, frac * n / (n_regions * 24))
    return caps


INT_FIELDS = ("target", "exec_region", "counts", "feasible", "shed_count",
              "spilled_count", "deferred_count", "infeasible_count")
CARBON_FIELDS = ("carbon_g", "total_carbon_g", "routed_carbon_g",
                 "oracle_carbon_g", "latency_opt_carbon_g",
                 "energy_opt_carbon_g", "mean_defer_hours")
STATE_FIELDS = ("counts", "shed", "exec_region", "shed_pair", "exec_hour",
                "defer_hours")


def assert_results_equal(r_res, t_res, r_state=None, t_state=None):
    """Fleet results (and policy states) of the two packages agree:
    integers exactly, carbon within ``RTOL``."""
    for f in INT_FIELDS:
        np.testing.assert_array_equal(host(getattr(t_res, f)),
                                      np.asarray(getattr(r_res, f)),
                                      err_msg=f)
    for f in CARBON_FIELDS:
        np.testing.assert_allclose(host(getattr(t_res, f)),
                                   np.asarray(getattr(r_res, f)),
                                   rtol=RTOL, atol=0, err_msg=f)
    if r_state is None:
        return
    for f in STATE_FIELDS:
        if not hasattr(r_state, f):
            continue
        a, b = getattr(r_state, f), getattr(t_state, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(host(b), np.asarray(a), err_msg=f)


def route_both(r_fr, t_fr, stream):
    """Route one numpy stream through both routers; returns
    ``(r_res, r_state, t_res, t_state)``."""
    batch, region, t_hours = stream
    r_res, r_state = r_fr.route_stream_with_state(batch, region, t_hours)
    t_res, t_state = t_fr.route_stream_with_state(torch_batch(batch), region,
                                                  t_hours)
    return r_res, r_state, t_res, t_state


SERVE_FIELDS = ("target", "exec_region", "exec_hour", "defer_hours", "shed",
                "step")
STEP_FIELDS = ("now", "drafted", "n_batches", "routed", "shed", "held",
               "queued_after", "refit")


def serve_routers(env, kind, caps, grids=None, inner=None, **kw):
    """A reference and a port ``FleetRouter`` with the same placement
    (``kind="placement"``) or temporal policy over ``inner`` (default: the
    oracle of each package); ``env`` holds both packages' configs, infras
    and grids (``r_cfg``, ``t_cfg``, ``r_inf``, ``t_inf``, ``grids``)."""
    from repro.serve import placement as r_pl
    from repro.serve import policy as r_pol
    from repro.serve import router as r_router
    from repro.serve import temporal as r_tmp

    from repro_torch.serve import placement as t_pl
    from repro_torch.serve import policy as t_pol
    from repro_torch.serve import temporal as t_tmp

    grids = env["grids"] if grids is None else grids
    inner = inner or (r_pol.OraclePolicy(env["r_inf"]),
                      t_pol.OraclePolicy(env["t_inf"]))
    mods = ((r_pl, r_tmp), (t_pl, t_tmp))
    out = []
    for (pl, tmp), cfg, grid, inn, dev in zip(
            mods, (env["r_cfg"], env["t_cfg"]), grids, inner,
            ({}, {"device": CPU})):
        pol = (pl.PlacementPolicy(inn, caps) if kind == "placement"
               else tmp.TemporalPolicy(inn, caps, **kw))
        router = r_router if pl is r_pl else t_router
        out.append(router.FleetRouter(cfg, grid=grid, policy=pol, **dev))
    return out


def assert_served_equal(r_res, t_res):
    """Two ``QueueServeResult``s agree: every commitment and step record
    exactly, carbon within ``RTOL``."""
    for f in SERVE_FIELDS:
        got, want = getattr(t_res, f), getattr(r_res, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_allclose(t_res.carbon_g, r_res.carbon_g, rtol=RTOL,
                               atol=0)
    for f in ("total_carbon_g", "routed_carbon_g"):
        np.testing.assert_allclose(getattr(t_res, f), getattr(r_res, f),
                                   rtol=RTOL, err_msg=f)
    assert (t_res.shed_count, t_res.deferred_count, t_res.refits) == (
        r_res.shed_count, r_res.deferred_count, r_res.refits)
    assert len(t_res.steps) == len(r_res.steps)
    for ts, rs in zip(t_res.steps, r_res.steps):
        for f in STEP_FIELDS:
            assert getattr(ts, f) == getattr(rs, f), f
        np.testing.assert_array_equal(ts.slots, rs.slots)
