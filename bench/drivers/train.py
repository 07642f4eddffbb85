"""The train driver: AdamW steps through ``make_train_step``.

Set-up builds one training state on the seed's weights and drives it
through its first ``judged_steps`` steps with the window's own call, on
batches that all differ; it keeps each step's loss, the per-leaf norms of
the first clipped gradient as the optimizer holds it (its first moment
after step 1 over 1 - b1) and the per-leaf norms of the weights' change
after the last judged step. The window then runs more steps on the same
state while its time lasts and ends with a sync. Afterwards the peak
memory is read, the state freed, and the plain reference trains the same
steps from the seed's weights (``reference.train`` with the family's
loss).
"""

from __future__ import annotations

import gc
import time

import torch

from bench.harness import port
from bench.harness.record import Run, window
from bench.harness.trace import Tracer
from bench.harness.weights import group_seed
from bench.reference import train as ref_train


def batch(run: Run, vocab: int, step: int, device) -> dict:
    t = run.workload["traffic"]
    g = torch.Generator(device=device)
    g.manual_seed(group_seed(run.seed, f"batch.{step}"))
    toks = torch.randint(0, vocab, (t["batch"], t["seq"] + 1), generator=g,
                         device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def run(run: Run, device, t_start: float) -> None:
    from repro_torch.train import adamw, init_train_state, make_train_step

    cfg, wl = run.config, run.workload
    rec, t = wl["recipe"], wl["traffic"]
    cuda = device.type == "cuda"
    port.set_precision(cfg)
    pc, model = port.build_model(cfg, run.family, run.seed, device)
    opt = adamw(rec["lr"], b1=rec["b1"], b2=rec["b2"], eps=rec["eps"],
                weight_decay=rec["weight_decay"],
                max_grad_norm=rec["max_grad_norm"])
    state = init_train_state(dict(model.named_parameters()), opt)
    step_fn = make_train_step(model, opt, remat=rec["remat"])

    n_judged = int(wl["judged_steps"])
    losses, grad_norm = [], None
    for i in range(n_judged):
        state, metrics = step_fn(state, batch(run, pc.vocab_size, i, device))
        losses.append(metrics["loss"])
        if i == 0:
            grad_norm = {k: (v / (1 - rec["b1"])).norm()
                         for k, v in state.opt.mu.items()}
    prog = {"loss": [float(x) for x in losses],
            "grad": {k: float(v) for k, v in grad_norm.items()},
            "change": {}}
    with torch.no_grad():
        draw = port.draw_fn(cfg, run.family, run.seed, device)
        for g in run.family.groups(cfg["model"]):
            for n, t0 in draw(g).items():
                prog["change"][n] = float(
                    (state.params[n].float() - t0.float()).norm())
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.time() - t_start

    tracer = Tracer(run.traced, float(wl.get("trace_seconds", 5.0)), cuda)
    tokens_per_step = t["batch"] * t["seq"]
    steps, metrics = 0, {"loss": losses[-1]}
    with window(run):
        tracer.start()
        t0 = time.perf_counter()
        t_end = t0 + run.seconds
        with tracer.phase("train", batch=t["batch"], seq=t["seq"]) as meta:
            while time.perf_counter() < t_end and not tracer.should_stop():
                state, metrics = step_fn(
                    state, batch(run, pc.vocab_size, n_judged + steps, device))
                steps += 1
            meta["steps"] = steps
            last_loss = float(metrics["loss"])  # syncs: the window's work is done
        tracer.stop()
        run.window_s = time.perf_counter() - t0
    run.trace = tracer.summary
    run.attempted = steps
    run.failed = 0 if last_loss == last_loss else steps
    run.counts.update(steps=steps, train_tokens=steps * tokens_per_step,
                      last_loss=last_loss)
    if cuda:
        run.device["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, model, step_fn, opt, metrics
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    data = [batch(run, pc.vocab_size, i, device) for i in range(n_judged)]
    ref = ref_train.steps(cfg, run.family,
                          port.draw_fn(cfg, run.family, run.seed, device),
                          [(b["tokens"], b["labels"]) for b in data], rec)
    nums = ref_train.numbers(prog, ref)
    run.counts.update(losses=prog["loss"], ref_losses=ref["loss"],
                      worst_grad_leaf=nums.pop("worst_grad_leaf"),
                      worst_change_leaf=nums.pop("worst_change_leaf"),
                      judge_s=round(time.perf_counter() - t_judge, 3))
    run.judged = {"numbers": nums, "ref": ref, "data": data}
    run.hold(nums, wl["limits"])
