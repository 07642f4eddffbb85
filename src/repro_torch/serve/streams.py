"""Synthetic request streams — the canonical diurnal LM serving trace.

A numpy-only copy of the reference ``src/repro/serve/streams.py``: the same
chat/summarize/agent request mix, arrival curves and seeded draws, so both
packages route identical streams (a test holds the copy against the
reference). ``bake_ci_events``, ``grid_event_stream`` and
``forecast_scenario`` act on the port's ``CarbonGrid``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serve.router import RequestBatch


def diurnal_hours(rng: np.random.Generator, n: int,
                  peak: float = 20.0) -> np.ndarray:
    """Arrival times (hours): sinusoidal daily load peaking at ``peak``."""
    hours = np.arange(24)
    rate = 1.0 + 0.8 * np.cos((hours - peak) / 24.0 * 2 * np.pi)
    p = rate / rate.sum()
    return rng.choice(24, n, p=p) + rng.uniform(0.0, 1.0, n)


def synthetic_stream(rng: np.random.Generator, n: int) -> RequestBatch:
    """Mix of chat (short), summarize (long-prefill), and agent (long-decode)
    request classes; prompts >= 2048 tokens never fit on-device."""
    cls = rng.choice(3, n, p=[0.7, 0.2, 0.1])
    prompt = np.select(
        [cls == 0, cls == 1, cls == 2],
        [rng.integers(16, 512, n), rng.integers(2048, 16384, n),
         rng.integers(256, 2048, n)]).astype(np.float64)
    new = np.select(
        [cls == 0, cls == 1, cls == 2],
        [rng.integers(16, 256, n), rng.integers(32, 128, n),
         rng.integers(256, 1024, n)]).astype(np.float64)
    budget = np.select([cls == 0, cls == 1, cls == 2],
                       [np.full(n, 2.0), np.full(n, 20.0), np.full(n, 30.0)])
    avail = np.ones((n, 3), bool)
    avail[:, 0] = prompt < 2048
    return RequestBatch(prompt_tokens=prompt, max_new_tokens=new,
                        latency_budget_s=budget,
                        bytes_per_token=np.full(n, 4.0), available=avail)


def arrival_stream(
    rate_per_h: float, duration_h: float = 24.0, n_regions: int = 1,
    seed: int = 0, *, diurnal: bool = True, peak: float = 20.0,
    spike_at_h: float | None = None, spike_mult: float = 1.0,
    spike_width_h: float = 1.0,
    batch_frac: float = 0.0, slack_range_h: tuple[int, int] = (6, 16),
) -> tuple[RequestBatch, np.ndarray, np.ndarray]:
    """Continuous-time Poisson arrival process — REAL arrival timestamps,
    not an hourly histogram: ``(batch, region, t_hours)`` with ``t_hours``
    sorted event times of an (inhomogeneous) Poisson process over
    ``[0, duration_h)`` at base intensity ``rate_per_h`` requests/hour.

    ``diurnal=True`` modulates the intensity by the canonical sinusoidal
    daily curve (same shape as ``diurnal_hours``, peaking at ``peak``);
    ``spike_at_h`` adds a flash-crowd burst: intensity multiplied by
    ``spike_mult`` inside a ``spike_width_h``-wide window centred there
    (the k8s-carbonrouter demand-spike scenario). Sampling is by thinning
    against the peak intensity, so the process is exact, and the request
    mix reuses ``synthetic_stream``. A non-zero ``batch_frac`` tags that
    share of arrivals deferrable with slack from ``slack_range_h`` (and a
    relaxed latency budget), matching ``deferrable_stream``'s convention.
    """
    if rate_per_h <= 0 or duration_h <= 0:
        raise ValueError("rate_per_h and duration_h must be positive")
    rng = np.random.default_rng(seed)
    lam_max = rate_per_h
    if diurnal:
        lam_max *= 1.8  # the sinusoid's peak factor
    if spike_at_h is not None and spike_mult > 1.0:
        lam_max *= spike_mult
    n_cand = rng.poisson(lam_max * duration_h)
    t = np.sort(rng.uniform(0.0, duration_h, n_cand))
    lam = np.full(n_cand, rate_per_h)
    if diurnal:
        lam *= 1.0 + 0.8 * np.cos((t - peak) / 24.0 * 2 * np.pi)
    if spike_at_h is not None and spike_mult > 1.0:
        in_spike = np.abs(t - spike_at_h) < 0.5 * spike_width_h
        lam = np.where(in_spike, lam * spike_mult, lam)
    keep = rng.uniform(0.0, lam_max, n_cand) < lam  # thinning
    t_hours = t[keep]
    n = len(t_hours)
    batch = synthetic_stream(rng, n)
    if batch_frac > 0.0:
        is_batch = rng.random(n) < batch_frac
        slack = np.where(
            is_batch,
            rng.integers(slack_range_h[0], slack_range_h[1] + 1, n),
            0).astype(np.float64)
        batch = dataclasses.replace(
            batch, slack_hours=slack,
            latency_budget_s=np.where(is_batch, 120.0,
                                      batch.latency_budget_s))
    return batch, rng.integers(0, n_regions, n), t_hours


def diurnal_stream(n: int, n_regions: int, seed: int = 0
                   ) -> tuple[RequestBatch, np.ndarray, np.ndarray]:
    """(batch, region, t_hours) — the full fleet-stream triple."""
    rng = np.random.default_rng(seed)
    batch = synthetic_stream(rng, n)
    return batch, rng.integers(0, n_regions, n), diurnal_hours(rng, n)


def multi_region_stream(
    n: int, n_regions: int, seed: int = 0,
    region_weights: np.ndarray | None = None,
    peak_hours: np.ndarray | None = None,
) -> tuple[RequestBatch, np.ndarray, np.ndarray]:
    """Fleet stream with per-region arrival skew — the cross-region spill
    scenario: regions carry unequal load shares and peak at staggered local
    evenings, so a loaded region hits its caps while a neighbour (possibly
    greener at that hour) still has headroom.

    ``region_weights`` defaults to a linear ramp (the busiest region carries
    ~3x the quietest); ``peak_hours`` defaults to evenly staggered peaks
    (timezone-like offsets of 24 / n_regions hours).
    """
    rng = np.random.default_rng(seed)
    batch = synthetic_stream(rng, n)
    if region_weights is None:
        region_weights = np.linspace(3.0, 1.0, n_regions)
    w = np.asarray(region_weights, np.float64)
    if peak_hours is None:
        peak_hours = (20.0 + np.arange(n_regions) * 24.0 / n_regions) % 24.0
    region = rng.choice(n_regions, n, p=w / w.sum())
    t_hours = np.empty(n)
    for r in range(n_regions):
        idx = region == r
        t_hours[idx] = diurnal_hours(rng, int(idx.sum()),
                                     peak=float(peak_hours[r]))
    return batch, region, t_hours


def deferrable_stream(
    n: int, n_regions: int, seed: int = 0,
    batch_frac: float = 0.5,
    slack_range_h: tuple[int, int] = (6, 16),
) -> tuple[RequestBatch, np.ndarray, np.ndarray]:
    """The multi-region skewed stream with a deadline-tagged batch-class
    slice — the temporal-deferral scenario: a ``batch_frac`` share of the
    requests (embedding backfills, offline summarization, eval sweeps) may
    execute in any hour of ``[arrival, arrival + slack]`` with slack drawn
    uniformly from ``slack_range_h``, and carries a relaxed latency budget
    (batch work tolerates any tier). Interactive requests keep slack 0, so
    a zero-``batch_frac`` stream reproduces ``multi_region_stream`` exactly.

    Most arrivals peak in the local evening — exactly when solar-heavy grids
    are at their dirtiest — so the batch slice's slack window reaches the
    next midday dip: the joint (region, tier, hour) decision space is where
    the deferral carbon win lives (CASPER's temporal axis).
    """
    batch, region, t_hours = multi_region_stream(n, n_regions, seed=seed)
    rng = np.random.default_rng(seed + 101)
    is_batch = rng.random(n) < batch_frac
    slack = np.where(
        is_batch, rng.integers(slack_range_h[0], slack_range_h[1] + 1, n),
        0).astype(np.float64)
    return (dataclasses.replace(
        batch,
        slack_hours=slack,
        latency_budget_s=np.where(is_batch, 120.0, batch.latency_budget_s)),
        region, t_hours)


def deferrable_stream_multiday(
    n: int, n_regions: int, n_days: int = 2, seed: int = 0,
    batch_frac: float = 0.5,
    slack_range_h: tuple[int, int] = (6, 16),
) -> tuple[RequestBatch, np.ndarray, np.ndarray]:
    """``deferrable_stream`` spread over a rolling ``n_days`` horizon:
    every request keeps the per-region staggered diurnal arrival pattern
    but lands on a uniformly drawn day, so arrival times are ABSOLUTE
    hours in ``[0, n_days * 24)`` and the evening batch slice's deadline
    windows cross midnight into the NEXT day's capacity budgets — the
    scenario the multi-day ``CarbonGrid`` horizon exists for (a modulo-24
    wrap would alias those windows into already-spent day-one cells).
    The horizon tail is NON-WRAPPING: deadline windows reaching past the
    grid's last hour simply lose those candidate hours (the work executes
    earlier or sheds), so a grid with ``n_days`` matching the stream is
    sufficient — no guard-day padding convention, tail arrivals just see a
    shorter menu.
    """
    batch, region, t_hours = deferrable_stream(
        n, n_regions, seed=seed, batch_frac=batch_frac,
        slack_range_h=slack_range_h)
    rng = np.random.default_rng(seed + 202)
    day = rng.integers(0, n_days, n)
    return batch, region, t_hours + 24.0 * day


def bake_ci_events(
    grid, *,
    ci_step_region: int | None = None,
    ci_step_window: tuple[int, int] = (6, 18),
    ci_step_mult: float = 2.5,
    curtail_region: int | None = None,
    curtail_window: tuple[int, int] = (11, 15),
    curtail_floor: float = 0.0,
):
    """Bake a CI step change (``ci_step_region``'s CI times
    ``ci_step_mult`` inside ``ci_step_window``) and a renewable-curtailment
    window (``curtail_region``'s CI times ``curtail_floor`` >= 0 inside
    ``curtail_window``) into a grid's actuals AND forecast. Windows index
    absolute horizon hours; with both regions None the grid is returned
    unchanged."""
    if ci_step_region is None and curtail_region is None:
        return grid
    ci = grid.ci_hourly.cpu().numpy().copy()
    fc = (None if grid.ci_forecast is None
          else grid.ci_forecast.cpu().numpy().copy())

    def scale_window(region: int, window: tuple[int, int],
                     mult: float) -> None:
        a, b = window
        ci[region, a:b] *= mult
        if fc is not None:
            fc[region, a:b] *= mult

    if ci_step_region is not None:
        scale_window(ci_step_region, ci_step_window, ci_step_mult)
    if curtail_region is not None:
        if curtail_floor < 0.0:
            raise ValueError(
                f"curtail_floor must be >= 0, got {curtail_floor}")
        scale_window(curtail_region, curtail_window, curtail_floor)
    changes = {"ci_hourly": torch.as_tensor(ci, device=grid.device)}
    if fc is not None:
        changes["ci_forecast"] = torch.as_tensor(fc, device=grid.device)
    return dataclasses.replace(grid, **changes)


def grid_event_stream(
    n: int, grid, *, seed: int = 0,
    ci_step_region: int | None = 0,
    ci_step_window: tuple[int, int] = (6, 18),
    ci_step_mult: float = 2.5,
    outage_site: int | None = 1,
    outage_window: tuple[int, int] = (8, 12),
    curtail_region: int | None = None,
    curtail_window: tuple[int, int] = (11, 15),
    curtail_floor: float = 0.0,
):
    """Grid-event scenario against an existing grid: ``(batch, region,
    t_hours, grid2, outage)`` with a CI step change and an optional
    curtailment window baked into ``grid2`` (see ``bake_ci_events``) and an
    (R, H) bool ``outage`` mask, True where ``outage_site`` is dark."""
    rng = np.random.default_rng(seed)
    batch = synthetic_stream(rng, n)
    r_count = grid.n_regions
    h_count = int(grid.ci_hourly.shape[1])
    region = rng.integers(0, r_count, n)
    days = max(h_count // 24, 1)
    t_hours = np.clip(diurnal_hours(rng, n) + 24.0 * rng.integers(0, days, n),
                      0.0, h_count - 1e-6)

    grid = bake_ci_events(
        grid, ci_step_region=ci_step_region, ci_step_window=ci_step_window,
        ci_step_mult=ci_step_mult, curtail_region=curtail_region,
        curtail_window=curtail_window, curtail_floor=curtail_floor)

    outage = np.zeros((r_count, h_count), bool)
    if outage_site is not None:
        a, b = outage_window
        outage[outage_site, a:b] = True
    return batch, region, t_hours, grid, outage


def forecast_scenario(
    n: int, regions, *, n_days: int = 2, sigma_h: float = 0.03,
    seed: int = 0, latency_penalty: float = 1.05,
    batch_frac: float = 0.5, device: str | torch.device = "cuda",
):
    """A multi-day deferrable stream plus a fully-connected multi-day grid
    carrying a rolling forecast with per-hour-ahead relative error scale
    ``sigma_h``: ``(batch, region, t_hours, grid)``."""
    from repro_torch.core.carbon_intensity import CarbonGrid

    batch, region, t_hours = deferrable_stream_multiday(
        n, len(regions), n_days=n_days, seed=seed, batch_frac=batch_frac)
    grid = CarbonGrid.fully_connected(
        regions, latency_penalty=latency_penalty, n_days=n_days,
        device=device)
    if sigma_h:
        grid = grid.forecast_from_actual(sigma_h, seed=seed)
    return batch, region, t_hours, grid
