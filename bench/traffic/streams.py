"""A frozen copy of the port's request-stream generator
(``src/repro_torch/serve/streams.py``: ``diurnal_hours``,
``synthetic_stream``, ``multi_region_stream``), numpy only and
independent of the program: the same seeded draws in the same order, so
it yields the port's arrays bit for bit (``tests/test_bench_frozen.py``).
Columns come back as a dict instead of the port's ``RequestBatch``.
Kept for the route cells under PERF.md's open questions; no cell of
``BENCHMARK.json`` reads it yet.
"""

from __future__ import annotations

import numpy as np


def diurnal_hours(rng: np.random.Generator, n: int,
                  peak: float = 20.0) -> np.ndarray:
    """Arrival times (hours): sinusoidal daily load peaking at ``peak``."""
    hours = np.arange(24)
    rate = 1.0 + 0.8 * np.cos((hours - peak) / 24.0 * 2 * np.pi)
    p = rate / rate.sum()
    return rng.choice(24, n, p=p) + rng.uniform(0.0, 1.0, n)


def synthetic_stream(rng: np.random.Generator, n: int) -> dict:
    """Chat (short), summarize (long prefill) and agent (long decode)
    requests, 70 / 20 / 10 %; prompts of 2048 tokens or more never fit a
    device."""
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
    return {"prompt_tokens": prompt, "max_new_tokens": new,
            "latency_budget_s": budget, "bytes_per_token": np.full(n, 4.0),
            "available": avail}


def multi_region_stream(n: int, n_regions: int, seed: int = 0,
                        region_weights=None, peak_hours=None
                        ) -> tuple[dict, np.ndarray, np.ndarray]:
    """(columns, region, t_hours): regions loaded on a linear ramp (the
    busiest ~3x the quietest) with evenly staggered evening peaks."""
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
