"""Shared helpers of the decide-half parity tests (``test_torch_grid.py``,
``test_torch_fleet.py``, ``test_torch_temporal.py``): the same numpy
stream through a reference ``repro`` router and a port ``repro_torch``
router on the CPU. Integer outputs must match exactly and carbon within
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
