"""``harness/spans.py`` on hand-built Chrome traces: the port's ``gs.``
spans, launch calls with correlation ids, kernels, copies and sets, host
waits, a launch from a second thread and idle gaps. Every span reader
returns its exact value; a trace without spans leaves the harness's own
summary as it was and every span reader returns None."""

import copy
import dataclasses
from types import SimpleNamespace

import pytest

from bench.harness import spans
from bench.harness.cell import BENCH, _reader
from bench.harness.trace import summarize

MAIN, AUTOGRAD = 101, 202
_corr = iter(range(1, 10_000))


def rng(name, ts, end, tid=MAIN, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": end - ts}


def launch(at, dev_ts, dev_dur, *, dur=2.0, tid=MAIN, call="cudaLaunchKernel",
           cat="kernel", name="k"):
    """A launch call at ``at`` on ``tid`` and the device operation it
    starts at ``dev_ts``."""
    c = next(_corr)
    host = {"ph": "X", "cat": "cuda_runtime", "name": call, "pid": 1,
            "tid": tid, "ts": at, "dur": dur, "args": {"correlation": c}}
    dev = {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
           "ts": dev_ts, "dur": dev_dur,
           "args": {"correlation": c, "device": 0, "stream": 7}}
    return [host, dev]


def wait(at, dur, call="cudaStreamSynchronize", tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": call, "pid": 1,
            "tid": tid, "ts": at, "dur": dur,
            "args": {"correlation": next(_corr)}}


def serve_trace():
    """A prefill (attn, moe, head), two decode steps (attn, ff, head) with
    an argmax launched between spans, a launch from a second thread and a
    host wait in each phase."""
    ev = [rng("bench.window", 0, 1000), rng("bench.prefill", 90, 240),
          rng("bench.decode", 290, 600),
          rng("gs.prefill", 100, 200), rng("gs.attn", 110, 140),
          rng("gs.moe", 140, 180), rng("gs.head", 180, 195),
          rng("gs.decode", 300, 400), rng("gs.attn", 305, 330),
          rng("gs.ff", 330, 390), rng("gs.head", 390, 398),
          rng("gs.decode", 450, 520), rng("gs.attn", 455, 470),
          rng("gs.ff", 470, 510), rng("gs.head", 510, 518),
          rng("aten::einsum", 456, 468, cat="cpu_op"),
          rng("aten::mm", 472, 490, cat="cpu_op")]
    ev += launch(112, 150, 20, name="flash")
    ev.append(wait(130, 10))
    ev += launch(145, 175, 30, name="gmm")
    ev += launch(182, 206, 4, call="cudaMemcpyAsync", cat="gpu_memcpy",
                 name="Memcpy DtoD")
    ev += launch(306, 320, 10, name="gemv")
    ev += launch(331, 390, 20, dur=55.0, name="gemm")
    ev.append(wait(387, 2))
    ev += launch(391, 412, 6, name="gemv")
    ev += launch(405, 420, 2, name="argmax")  # outside every span
    ev += launch(456, 470, 8, name="gemv")
    ev += launch(472, 480, 12, name="gemm")
    ev += launch(511, 520, 1, call="cudaMemsetAsync", cat="gpu_memset",
                 name="Memset")
    ev += launch(460, 530, 5, tid=AUTOGRAD, name="other_thread")
    return ev


SERVE_METAS = {"prefill": [{"batch": 1, "prompt": 4}],
               "decode": [{"batch": 1, "prompt": 4, "start": 0,
                           "steps": 2}]}


def train_trace():
    """Two training steps; backward launches from autograd's thread; a
    ``cudaFree`` in the first update, a sync in the second."""
    ev = [rng("bench.window", 0, 1000), rng("bench.train", 50, 700)]
    for base, (f, b1, b2, o) in ((100, (40, 60, 30, 10)),
                                 (400, (44, 70, None, 12))):
        ev += [rng("gs.train.forward", base, base + 100),
               rng("gs.train.backward", base + 100, base + 200),
               rng("gs.train.optimizer", base + 200, base + 250)]
        ev += launch(base + 10, base + 20, f)
        ev += launch(base + 120, base + 130, b1, tid=AUTOGRAD)
        if b2:
            ev += launch(base + 150, base + 195, b2, tid=AUTOGRAD)
        ev += launch(base + 210, base + 215, o)
    ev.append(wait(320, 5, call="cudaFree"))
    ev.append(wait(640, 3))
    return ev


TRAIN_METAS = {"train": [{"batch": 1, "seq": 4, "steps": 2}]}


def without_spans(ev):
    return [e for e in ev if not e["name"].startswith(spans.PREFIX)]


def run_of(events, metas):
    summary = summarize(copy.deepcopy(events), metas)
    summary.spans = spans.summarize(events)
    return SimpleNamespace(trace=summary)


SERVE_READS = {
    "dispatch_ms.decode": (100 + 70) / 2 * 1e-3,
    "device_ms.decode": ((10 + 20 + 6) + (8 + 12 + 1 + 5)) / 2 * 1e-3,
    "launches.decode": 3.5,
    "host_waits.decode": 0.5,
    "host_waits.prefill": 1.0,
    "dispatch_ms.decode.attn": (25 + 15) / 2 * 1e-3,
    "dispatch_ms.decode.ff": (60 + 40) / 2 * 1e-3,
    "dispatch_ms.decode.mamba": None,  # no Mamba layer
    "dispatch_ms.decode.moe": 0.0,  # MoE only in prefill
}
TRAIN_READS = {
    "device_ms.train.forward": (40 + 44) / 2 * 1e-3,
    "device_ms.train.backward": (60 + 30 + 70) / 2 * 1e-3,
    "device_ms.train.optimizer": (10 + 12) / 2 * 1e-3,
    "host_waits.train": 1.0,
}
READS = {**SERVE_READS, **TRAIN_READS}


@pytest.mark.parametrize("name", list(READS))
def test_each_reader_reads_its_exact_value(name):
    run = (run_of(serve_trace(), SERVE_METAS) if name in SERVE_READS
           else run_of(train_trace(), TRAIN_METAS))
    got = _reader(BENCH, name)(run)
    if READS[name] is None:
        assert got is None
    else:
        assert got == pytest.approx(READS[name], rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("name", list(READS))
def test_without_spans_every_reader_reads_nothing(name):
    read = _reader(BENCH, name)
    for ev, metas in ((serve_trace(), SERVE_METAS),
                      (train_trace(), TRAIN_METAS)):
        assert spans.summarize(without_spans(ev)) is None
        run = run_of(without_spans(ev), metas)
        assert read(run) is None
        # a summary that carries no span statistics (the harness as it is)
        assert read(SimpleNamespace(trace=summarize(ev, metas))) is None
    assert read(SimpleNamespace(trace=None)) is None


def test_no_device_activity_reads_nothing():
    ev = [e for e in serve_trace()
          if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")]
    run = run_of(ev, SERVE_METAS)
    assert run.trace.busy_s == 0 and run.trace.spans is not None
    for name in SERVE_READS:
        assert _reader(BENCH, name)(run) is None


@pytest.mark.parametrize("make,metas", [(serve_trace, SERVE_METAS),
                                        (train_trace, TRAIN_METAS)])
def test_spans_leave_the_harness_summary_as_it_was(make, metas):
    """The harness's phases, busy time, device ops and idle gaps (and so
    every existing metric and the breakdown) read the same with and
    without the port's spans in the trace."""
    ev = make()
    a, b = summarize(ev, metas), summarize(without_spans(ev), metas)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.breakdown() == b.breakdown()


def test_nesting_and_attribution():
    s = spans.summarize(serve_trace())
    names = [(x.name, None if x.parent is None else s.spans[x.parent].name)
             for x in s.spans]
    assert names.count(("attn", "decode")) == 2
    assert names.count(("head", "prefill")) == 1
    pre, = s.top("prefill")
    assert (pre.ops, pre.device_us, pre.waits, pre.wait_us) == (3, 54, 1, 10)
    attn = [x for x in s.spans if x.name == "attn"]
    assert [(x.ops, x.device_us) for x in attn] == [(1, 20), (1, 10),
                                                    (2, 13)]
    assert s.main == MAIN
    assert s.names_at([460, 250, 335, 100]) == ["attn", None, "ff",
                                                 "prefill"]


def test_phase_report():
    ev = serve_trace()
    s = spans.summarize(ev)
    phases = summarize(ev, SERVE_METAS).phases
    dec = s.phase_report(phases["decode"].spans)
    assert dec["device_ms"] == pytest.approx(64e-3)
    assert dec["found_pct"] == pytest.approx(100 * 62 / 64)
    assert dec["not_found_ms"] == {"argmax": pytest.approx(2e-3)}
    assert dec["slow_launches"] == {"cudaLaunchKernel in ff":
                                    [1, pytest.approx(55e-3)]}
    assert dec["waits"] == {"cudaStreamSynchronize in ff":
                            [1, pytest.approx(2e-3)]}
    pre = s.phase_report(phases["prefill"].spans)
    assert pre["found_pct"] == 100.0 and pre["slow_launches"] == {}
    assert pre["waits"] == {"cudaStreamSynchronize in attn":
                            [1, pytest.approx(10e-3)]}
    tr = spans.summarize(train_trace())
    report = tr.phase_report(summarize(train_trace(),
                                       TRAIN_METAS).phases["train"].spans)
    assert report["found_pct"] == 100.0
    assert report["waits"] == {
        "cudaFree in train.optimizer": [1, pytest.approx(5e-3)],
        "cudaStreamSynchronize in train.optimizer": [1, pytest.approx(3e-3)]}
