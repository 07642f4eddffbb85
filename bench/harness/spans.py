"""The port's spans read from a traced run's Chrome trace.

The port opens ``torch.profiler.record_function`` ranges ``gs.<name>``
(``repro_torch.obs``) where its work happens: ``prefill`` and ``decode``
around a served step, ``attn`` / ``mamba`` / ``ff`` / ``moe`` per layer
and ``head`` inside them, ``train.forward`` / ``.backward`` /
``.optimizer`` in a training step. They land in the trace the harness
already takes, on the clock of the device's operations.

Attribution: a device operation (kernel, copy, set) carries a
``correlation`` id; the runtime or driver call with that id launched it
(``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaLaunchKernelExC``, a
memcpy or memset call). The call's start gives the innermost span open
then on the call's thread; a thread that opens no span (autograd's device
thread) takes the innermost span of the main thread, the one that opens
the most spans. An operation counts in its span and in every span around
it. A host wait is a runtime call that blocks the host on the device
(``WAITS``), given to a span the same way.

``summarize`` returns None for a trace without a span (a program that
has none); every reader then returns None, as it does without a trace or
without device activity (a CPU run).
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
from collections import Counter, defaultdict

from bench.harness.trace import DEVICE_CATS

PREFIX = "gs."
CALL_CATS = ("cuda_runtime", "cuda_driver")
#: runtime calls that hold the host until the device has reached them;
#: ``cudaFree`` is the caching allocator's release on a retry
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaFree")
SLOW_LAUNCH_US = 50.0


@dataclasses.dataclass
class Span:
    name: str  # without the prefix
    ts: float  # us
    end: float
    tid: object
    parent: int | None
    device_us: float = 0.0  # device time it launched, nested spans included
    ops: int = 0  # device operations it launched, nested spans included
    waits: int = 0  # host waits inside it, nested spans included
    wait_us: float = 0.0

    @property
    def host_ms(self) -> float:
        return (self.end - self.ts) * 1e-3


@dataclasses.dataclass
class Spans:
    spans: list  # [Span], by thread, then start
    main: object  # the thread that opens the most spans
    ops: list  # [(start_us, dur_us, name, span index or None)] device ops
    launches: list  # [(start_us, dur_us, name, span index or None)]
    waits: list  # [(start_us, dur_us, name, span index or None)]
    timelines: dict  # thread -> [(start_us, end_us, span index)]

    def top(self, name: str) -> list:
        """The spans of ``name`` that no other span encloses."""
        return [s for s in self.spans if s.name == name and s.parent is None]

    def within(self, i: int) -> int | None:
        """The outermost span around span ``i`` (itself at the top)."""
        while self.spans[i].parent is not None:
            i = self.spans[i].parent
        return i

    def children(self, name: str, kind: str) -> dict:
        """{index of a top span ``name``: host ms of its ``kind`` spans}."""
        out = {i: 0.0 for i, s in enumerate(self.spans)
               if s.name == name and s.parent is None}
        for s in self.spans:
            if s.name == kind and s.parent is not None:
                top = self.within(s.parent)
                if top in out:
                    out[top] += s.host_ms
        return out

    def has(self, name: str) -> bool:
        return any(s.name == name for s in self.spans)

    def names_at(self, times) -> list:
        """The innermost span's name open on the main thread at each time
        (None where none is)."""
        return [None if i is None else self.spans[i].name
                for i in _innermost(self.timelines[self.main], times)]

    def phase_report(self, ranges) -> dict:
        """What one of the harness's phases (host ranges ``ranges``)
        holds: the share of its device time whose launch found a span,
        the operations that found none, the launch calls over
        ``SLOW_LAUNCH_US``, and the host waits by innermost span."""
        ranges = sorted(ranges)
        starts = [a for a, _ in ranges]

        def inside(t):
            j = bisect.bisect_right(starts, t) - 1
            return j >= 0 and t < ranges[j][1]

        dev = [o for o in self.ops if inside(o[0])]
        total = sum(o[1] for o in dev)
        lost: Counter = Counter()
        for _, dur, name, i in dev:
            if i is None:
                lost[name[:80]] += dur * 1e-3

        def by_span(calls) -> dict:
            """{"<call> in <span>": [count, ms]} of the calls inside."""
            out: dict = defaultdict(lambda: [0, 0.0])
            for t, dur, name, i in calls:
                if inside(t):
                    where = self.spans[i].name if i is not None else None
                    key = (f"{name} in {where}" if where is not None
                           else f"{name} outside spans")
                    out[key][0] += 1
                    out[key][1] += dur * 1e-3
            return {k: [n, ms] for k, (n, ms) in out.items()}

        return {"device_ms": total * 1e-3,
                "found_pct": 100.0 * (1 - sum(lost.values()) * 1e3 / total)
                if total else None,
                "not_found_ms": dict(lost.most_common(5)),
                "slow_launches": by_span(c for c in self.launches
                                         if c[1] > SLOW_LAUNCH_US),
                "waits": by_span(self.waits)}


def _innermost(timeline, times) -> list:
    """For each time (any order), the index of the innermost span of one
    thread's properly nested ``timeline`` [(start, end, index)] sorted by
    start (outer first) that is open at it: start <= t < end."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [None] * len(times)
    stack: list = []
    k = 0
    for q in order:
        t = times[q]
        while k < len(timeline) and timeline[k][0] <= t:
            while stack and stack[-1][1] <= timeline[k][0]:
                stack.pop()
            stack.append(timeline[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def summarize(events: list) -> Spans | None:
    """The trace's spans with the device time, operations and host waits
    each launched or holds; None where the trace holds no span."""
    raw = sorted(((e["tid"], e["ts"], -e["dur"], e["name"][len(PREFIX):])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(PREFIX)),
                 key=lambda r: (str(r[0]), r[1], r[2]))
    if not raw:
        return None
    spans: list = []
    timelines: dict = defaultdict(list)
    stack: list = []
    for tid, ts, neg, name in raw:
        end = ts - neg
        while stack and (spans[stack[-1]].tid != tid
                         or spans[stack[-1]].end <= ts):
            stack.pop()
        spans.append(Span(name, ts, end, tid, stack[-1] if stack else None))
        timelines[tid].append((ts, end, len(spans) - 1))
        stack.append(len(spans) - 1)
    main = Counter(s.tid for s in spans).most_common(1)[0][0]

    calls = [e for e in events
             if e.get("ph") == "X" and e.get("cat") in CALL_CATS]
    by_corr = {e["args"]["correlation"]: e for e in calls
               if "correlation" in e.get("args", {})}
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    launched = [by_corr.get(e.get("args", {}).get("correlation"))
                for e in dev]
    waits = [e for e in calls if e["name"] in WAITS]

    def owner(host_events) -> list:
        """Innermost span of each host event (None for a missing one)."""
        out = [None] * len(host_events)
        by_tid: dict = defaultdict(list)
        for j, e in enumerate(host_events):
            if e is not None:
                by_tid[e["tid"] if e["tid"] in timelines else main].append(j)
        for tid, js in by_tid.items():
            got = _innermost(timelines[tid], [host_events[j]["ts"]
                                              for j in js])
            for j, i in zip(js, got):
                out[j] = i
        return out

    op_span = owner(launched)
    for e, i in zip(dev, op_span):
        while i is not None:
            spans[i].device_us += e["dur"]
            spans[i].ops += 1
            i = spans[i].parent
    wait_span = owner(waits)
    for e, i in zip(waits, wait_span):
        while i is not None:
            spans[i].waits += 1
            spans[i].wait_us += e["dur"]
            i = spans[i].parent
    launch_calls = {id(c): (c["ts"], c["dur"], c["name"], i)
                    for c, i in zip(launched, op_span) if c is not None}
    return Spans(
        spans, main,
        [(e["ts"], e["dur"], e["name"], i) for e, i in zip(dev, op_span)],
        list(launch_calls.values()),
        [(e["ts"], e["dur"], e["name"], i) for e, i in zip(waits, wait_span)],
        dict(timelines))


# --- the readers' arithmetic --------------------------------------------------


def of(run) -> Spans | None:
    """The run's spans: None without a trace, without device activity (a
    CPU run), or where its summary holds none (a trace without spans, or a
    harness that does not read them)."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return getattr(t, "spans", None)


def _median(run, name: str, value) -> float | None:
    s = of(run)
    top = s.top(name) if s is not None else []
    return float(statistics.median(value(x) for x in top)) if top else None


def dispatch_ms(run, name: str) -> float | None:
    """Median host duration of a ``gs.<name>`` span."""
    return _median(run, name, lambda x: x.host_ms)


def device_ms(run, name: str) -> float | None:
    """Median device time of the operations a ``gs.<name>`` span launched."""
    return _median(run, name, lambda x: x.device_us * 1e-3)


def launches(run, name: str) -> float | None:
    """Median device operations a ``gs.<name>`` span launched."""
    return _median(run, name, lambda x: x.ops)


def host_waits(run, name: str) -> float | None:
    """Mean host waits inside a ``gs.<name>`` span."""
    s = of(run)
    top = s.top(name) if s is not None else []
    return sum(x.waits for x in top) / len(top) if top else None


def kind_ms(run, name: str, kind: str) -> float | None:
    """Median, over ``gs.<name>`` spans, of the host time of the
    ``gs.<kind>`` spans inside each; None where none is."""
    s = of(run)
    if s is None or not s.has(kind):
        return None
    per = s.children(name, kind)
    return float(statistics.median(per.values())) if per else None


TRAIN_PARTS = ("forward", "backward", "optimizer")


def _train(run, value) -> float | None:
    """Per training step (one ``gs.train.optimizer`` span each), the sum
    of ``value`` over the step's spans of each part."""
    s = of(run)
    steps = len(s.top("train.optimizer")) if s is not None else 0
    if not steps:
        return None
    return {part: sum(value(x) for x in s.top(f"train.{part}")) / steps
            for part in TRAIN_PARTS}


def train_device_ms(run, part: str) -> float | None:
    """Device time launched in ``gs.train.<part>`` per training step."""
    per = _train(run, lambda x: x.device_us * 1e-3)
    return None if per is None else per[part]


def train_host_waits(run) -> float | None:
    """Host waits inside the training step's spans per step."""
    per = _train(run, lambda x: x.waits)
    return None if per is None else sum(per.values())
