"""Phases of a run as named ranges, and in a traced run the device trace
read back into per-phase numbers.

The drivers wrap each call into a layer in ``tracer.phase(name)``, which
in a traced run is a ``torch.profiler.record_function`` range
``bench.<name>`` and records the phase's shapes (``meta``) in order. A
phase range ends with the host holding the phase's result (a sync), so its
length is the phase's wall time. After the traced window the Chrome trace
is read: device operations (kernels, copies, sets) are clipped to the
window and to each phase's ranges; the rest is idle. The trace file goes
to the run's temporary directory and is deleted after reading.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def base_name(kernel: str) -> str:
    """``void (anonymous namespace)::gmm_bf16_tc<4, 2>(Params)`` ->
    ``gmm_bf16_tc``."""
    name = re.sub(r"\(anonymous namespace\)::", "", kernel)
    name = name[5:] if name.startswith("void ") else name
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1]


def _merge(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(merged, a: float, b: float) -> float:
    """Length of [a, b] covered by the merged intervals."""
    i = max(bisect.bisect_right(merged, (a, float("inf"))) - 1, 0)
    tot = 0.0
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(merged[i][0], a), min(merged[i][1], b)
        tot += max(0.0, hi - lo)
        i += 1
    return tot


@dataclasses.dataclass
class Phase:
    name: str
    spans: list  # [(start_us, end_us)] host ranges, in order
    metas: list  # the window loop's shapes, one per span
    wall_s: float
    busy_s: float
    kernel_s: dict  # kernel name -> device seconds inside the spans
    kernel_n: dict  # kernel name -> launches inside the spans

    def kernels(self, prefix: str) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose function name (the
        trace's name without return type, namespaces and template
        arguments) starts with ``prefix``."""
        keys = [k for k in self.kernel_s if base_name(k).startswith(prefix)]
        return (sum(self.kernel_s[k] for k in keys),
                sum(self.kernel_n[k] for k in keys))

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.wall_s)


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    phases: dict
    device_ops: list
    idle_gaps: list

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def summarize(events: list, metas: dict) -> Summary:
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    ann: dict = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith("bench.")):
            ann[e["name"][6:]].append((e["ts"], e["ts"] + e["dur"]))
    (w0, w1), = ann.pop("window")
    merged = _merge([(a, b) for a, b, _ in dev])
    busy = _covered(merged, w0, w1)

    phases = {}
    for name, spans in ann.items():
        spans.sort()
        got = metas.get(name, [])
        if len(got) != len(spans):
            raise RuntimeError(f"phase {name}: {len(spans)} ranges in the "
                               f"trace, {len(got)} recorded")
        ks: dict = defaultdict(float)
        kn: dict = defaultdict(int)
        starts = [s[0] for s in spans]
        for a, b, kname in dev:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < spans[i][1]:
                ks[kname] += (b - a) * 1e-6
                kn[kname] += 1
        phases[name] = Phase(
            name, spans, got, sum(b - a for a, b in spans) * 1e-6,
            sum(_covered(merged, a, b) for a, b in spans) * 1e-6,
            dict(ks), dict(kn))

    by_op: dict = defaultdict(float)
    for a, b, kname in dev:
        if w0 <= a < w1:
            by_op[kname] += (min(b, w1) - a) * 1e-6
    device_ops = sorted(([k[:120], v] for k, v in by_op.items()),
                        key=lambda r: -r[1])[:10]

    # idle gaps, named by the phase and the outermost host op open at
    # the gap's start
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    top: list = []
    for a, b, n in ops:
        if not top or a >= top[-1][1]:
            top.append((a, b, n))
    top_starts = [t[0] for t in top]
    phase_spans = sorted((a, b, n) for n, p in phases.items()
                         for a, b in p.spans)
    ph_starts = [s[0] for s in phase_spans]
    gaps: dict = defaultdict(float)
    inside = [(max(a, w0), min(b, w1)) for a, b in merged if b > w0 and a < w1]
    edges = [w0] + [x for iv in inside for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        j = bisect.bisect_right(ph_starts, g0) - 1
        ph = (phase_spans[j][2] if j >= 0 and g0 < phase_spans[j][1]
              else "between phases")
        k = bisect.bisect_right(top_starts, g0) - 1
        op = top[k][2] if k >= 0 and g0 < top[k][1] else "python"
        gaps[f"{ph}: {op}"[:120]] += (g1 - g0) * 1e-6
    idle_gaps = sorted(([k, v] for k, v in gaps.items()),
                       key=lambda r: -r[1])[:10]
    return Summary((w1 - w0) * 1e-6, busy * 1e-6, phases, device_ops,
                   idle_gaps)


class Tracer:
    """``phase`` ranges always cost nothing when the run is not traced."""

    def __init__(self, traced: bool, seconds: float = 0.0,
                 cuda: bool = True):
        self.traced = traced
        self.cuda = cuda
        self.seconds = seconds
        self.active = False
        self.summary: Summary | None = None
        self._metas: dict = defaultdict(list)

    def start(self) -> None:
        if not self.traced:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = record_function("bench.window")
        self._window.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
        self.active = True
        self._t_stop = time.perf_counter() + self.seconds

    def should_stop(self) -> bool:
        return self.active and time.perf_counter() >= self._t_stop

    @property
    def done(self) -> bool:
        return self.summary is not None

    def stop(self) -> None:
        if not self.active:
            return
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        del self._prof
        self.summary = summarize(events, dict(self._metas))

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        """A phase range; the caller may add to ``meta`` inside it."""
        if not self.active:
            yield meta
            return
        from torch.profiler import record_function

        with record_function(f"bench.{name}"):
            yield meta
        self._metas[name].append(meta)
