"""The serve driver: closed-loop static batches through ``ServeEngine``.

Set-up builds the engine on the seed's weights and warms every (prompt,
new) shape of the cycle. The window issues batches while its time lasts;
a batch started in it runs to its end. Per batch: ``prefill_batch`` and
the argmax of its logits, the first token copied to the host (streamed to
the client), then ``serve_step`` and its argmax for each further token,
all tokens copied to the host at the end. CUDA events after each argmax
time the first token (from an event recorded as the host issues the
prefill) and every gap between tokens on the device's clock.

Afterwards the peak memory is read, the engine freed, and a sample of the
finished batches, drawn from the seed and holding the longest, is judged
against the family's plain reference (its ``served_logits``) by
``reference.judge``: the cell's ``limits`` name the numbers it holds.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench.harness import port
from bench.harness.record import Run, window
from bench.harness.trace import Tracer
from bench.harness.weights import group_seed
from bench.reference import judge
from bench.traffic.serve import ServeTraffic

WARM_STEPS = 2  # decode steps warmed per shape


class Clock:
    """Stamps on the device's timeline (CUDA events) on a card; on the CPU,
    where every op is synchronous, the host's clock."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _serve_batch(engine, batch, tracer: Tracer, clock: Clock) -> dict:
    B, S = batch.tokens.shape
    e0 = clock.stamp()
    with tracer.phase("prefill", batch=B, prompt=S):
        logits, state = engine.prefill_batch(batch.tokens)
        tok = logits.argmax(-1, keepdim=True)
        e1 = clock.stamp()
        tok.cpu()
    toks, evs = [tok], [e1]
    i, steps = 0, batch.new - 1
    while i < steps:
        with tracer.phase("decode", batch=B, prompt=S, start=i) as meta:
            while i < steps:
                logits, state = engine.serve_step(state, tok)
                tok = logits.argmax(-1, keepdim=True)
                evs.append(clock.stamp())
                toks.append(tok)
                i += 1
                if tracer.should_stop():
                    break
            meta["steps"] = i - meta["start"]
            if clock.cuda:
                torch.cuda.synchronize()
        if tracer.should_stop():
            tracer.stop()
    out = torch.cat(toks, dim=1).cpu()
    return {"tokens": out, "ttft_ms": clock.ms(e0, e1),
            "gaps_ms": [clock.ms(a, b) for a, b in zip(evs, evs[1:])]}


def run(run: Run, device, t_start: float) -> None:
    from repro_torch.serve import ServeEngine

    cfg, wl = run.config, run.workload
    cuda = device.type == "cuda"
    port.set_precision(cfg)
    pc, model = port.build_model(cfg, run.family, run.seed, device)
    traffic = ServeTraffic(wl["traffic"], run.seed, pc.vocab_size, device)
    engine = ServeEngine(pc, model, max_seq=traffic.max_len, device=device)

    # warm every shape this cell's traffic uses
    g = torch.Generator(device=device)
    g.manual_seed(group_seed(run.seed, "warmup"))
    for prompt, new in traffic.shapes:
        toks = torch.randint(0, pc.vocab_size, (traffic.batch, prompt),
                             generator=g, device=device)
        logits, state = engine.prefill_batch(toks)
        tok = logits.argmax(-1, keepdim=True)
        for _ in range(min(WARM_STEPS, new - 1)):
            logits, state = engine.serve_step(state, tok)
            tok = logits.argmax(-1, keepdim=True)
        tok.cpu()
        del logits, state
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.time() - t_start

    tracer = Tracer(run.traced, float(wl.get("trace_seconds", 5.0)), cuda)
    clock = Clock(cuda)
    done = []
    with window(run):
        tracer.start()
        t0 = time.perf_counter()
        t_end = t0 + run.seconds
        while not done or time.perf_counter() < t_end:
            b = traffic.next()
            done.append((b, _serve_batch(engine, b, tracer, clock)))
            if tracer.done:  # a traced run ends with its trace
                break
        tracer.stop()
        run.window_s = time.perf_counter() - t0
    run.trace = tracer.summary

    B = traffic.batch
    run.attempted = B * len(done)
    run.failed = B * sum(
        int(not bool(((r["tokens"] >= 0) & (r["tokens"] < pc.vocab_size))
                     .all())) for _, r in done)
    run.samples["ttft_ms"] = [r["ttft_ms"] for _, r in done
                              for _ in range(B)]
    run.samples["itl_ms"] = [x for _, r in done for x in r["gaps_ms"]
                             for _ in range(B)]
    itl = np.asarray(run.samples["itl_ms"] or [0.0])
    run.counts.update(batches=len(done), requests=run.attempted,
                      gaps=len(run.samples["itl_ms"]),
                      itl_p50_p99_max_ms=[round(float(x), 3) for x in (
                          np.median(itl), np.percentile(itl, 99), itl.max())],
                      served_tokens=B * sum(b.new for b, _ in done))
    if cuda:
        run.device["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    del engine, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the judge: a sample of finished batches, the longest among them
    rng = np.random.default_rng(group_seed(run.seed, "judge"))
    longest = max(range(len(done)),
                  key=lambda j: done[j][0].prompt + done[j][0].new)
    rest = [j for j in range(len(done)) if j != longest]
    k = min(int(wl["judge"]["batches"]), len(done)) - 1
    picks = [longest] + sorted(rng.choice(rest, k, replace=False).tolist())
    t_judge = time.perf_counter()
    batches, served = [], []
    for j in picks:
        b, r = done[j]
        toks = r["tokens"].to(device)
        batches.append((torch.cat([b.tokens, toks[:, :-1]], dim=1), b.prompt))
        served.append(toks)
    refs = run.family.served_logits(
        cfg, port.draw_fn(cfg, run.family, run.seed, device), batches)
    nums = judge.gap_numbers(refs, served)
    run.counts.update(judged_batches=[done[j][0].index for j in picks],
                      judged_tokens=nums.pop("judged_tokens"),
                      judge_s=round(time.perf_counter() - t_judge, 3))
    run.judged = {"numbers": nums, "batches": batches, "refs": refs,
                  "served": served}
    run.hold(nums, wl["limits"])
