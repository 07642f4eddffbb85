"""What one run measured, handed to the metric readers, and the result
line built from it."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import resource
import sys
import time

import numpy as np


@dataclasses.dataclass
class Run:
    cell: object  # harness.cell.Cell
    seed: int
    seconds: float
    traced: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    samples: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    #: name -> (value, limit); the run is correct when every value is at
    #: most its limit (a missing limit fails)
    checks: dict = dataclasses.field(default_factory=dict)
    device: dict = dataclasses.field(default_factory=dict)
    trace: object = None  # harness.trace.Summary of a traced run
    #: what the judge compared (for the control readings of calibrate.py)
    judged: dict = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def workload(self) -> dict:
        return self.cell.workload

    @property
    def family(self):
        """The configuration's model family (``bench/families/``)."""
        return self.cell.family

    def hold(self, numbers: dict, limits: dict) -> None:
        """Compare the numbers the cell's ``limits`` name."""
        for name, limit in limits.items():
            self.checks[name] = (numbers[name], limit)

    @property
    def correct(self) -> bool:
        return within(self.checks)


def within(checks: dict) -> bool:
    """The rule that decides ``correct``: there is a check, and every
    number is finite and at most its limit (a missing limit fails)."""
    return bool(checks) and all(
        lim is not None and math.isfinite(v) and v <= lim
        for v, lim in checks.values())


def host_probe_ms() -> float:
    """The host's speed now: the best of three timings of a fixed loop of
    Python bytecode, the kind of work an eager step's dispatch is."""
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        x = 0
        for i in range(200_000):
            x += i & 7
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


@contextlib.contextmanager
def window(run: Run):
    """The measured window. Python's collector leaves the set-up's objects
    alone inside it (``gc.freeze``): a full collection then traverses only
    what the window allocated, not every object the set-up left. The run's
    counts get what says how fast the host was: the probe before, the
    process's CPU time over the window's wall, and the context switches
    the kernel forced on it (another process taking its core)."""
    probe = host_probe_ms()
    gc.collect()
    gc.freeze()
    r0, c0, t0 = (resource.getrusage(resource.RUSAGE_SELF),
                  time.process_time(), time.perf_counter())
    try:
        yield
    finally:
        wall = time.perf_counter() - t0
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        gc.unfreeze()
        run.counts.update(
            host_probe_ms=round(probe, 3),
            host_cpu_share=round((time.process_time() - c0) / wall, 4),
            host_switches_forced=r1.ru_nivcsw - r0.ru_nivcsw,
            host_switches_waited=r1.ru_nvcsw - r0.ru_nvcsw)


def p95(values) -> float | None:
    """The 95th percentile (linear) of all the samples, None without any."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95))


def result(run: Run) -> dict:
    """The result line: the cell's end-to-end metrics, or with a trace its
    per-layer ones (a reader that finds nothing leaves its metric out)."""
    kind = "per_layer" if run.traced else "end_to_end"
    metrics = {}
    for m in run.cell.metrics:
        if m.kind != kind:
            continue
        v = m.read(run)
        if v is None:
            if kind == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m.name} read nothing")
            continue
        metrics[m.name] = {"value": float(v), "unit": m.unit}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics,
           "device": dict(run.device)}
    if run.traced and run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def emit(run: Run) -> dict:
    """Print the counts, then each compared number beside its limit as
    the last lines of stderr, then the result as the last stdout line."""
    line = result(run)
    for k, v in run.counts.items():
        print(f"[bench] {k}: {v}", file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"[check] {k} = {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line
