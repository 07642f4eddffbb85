"""Carbon-aware training on the port: ``python -m
repro_torch.launch.carbon_aware_training [--steps 300] [--ckpt DIR]
[--device cuda]``.

The counterpart of the reference's ``examples/carbon_aware_training.py``,
printing the same lines. The control plane (``CarbonAwareTrainer``:
hourly temporal, spatial and elastic decisions and the carbon ledger)
drives real training steps through its step hook: an h2o-danube-family
model of ~100M parameters (``CFG_100M``) in float32 on the synthetic
Markov language, remat ``dots``, across the CISO and rural pods, with an
atomic checkpoint after every hook so the run resumes from ``--ckpt``
(default ``<tmp>/ca_ckpt``). A hook that ran no step leaves the latest
checkpoint as it is (it holds the same state), and only the newest
``KEEP_CHECKPOINTS`` stay on disk: the reference keeps one for every
hook, ~1 GB each at this size.

Weights come from a generator seeded with 0, or from ``params``
({name: tensor}). ``main`` returns a ``CarbonAwareRun``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import Family, ModelConfig, ShapeConfig, ShapeKind
from repro_torch.core import Grid, grid_trace
from repro_torch.data import batch_for
from repro_torch.device import resolve_device
from repro_torch.models import Transformer
from repro_torch.train.carbon_aware import (
    CarbonAwareTrainer,
    CarbonSchedule,
    PodSpec,
)
from repro_torch.train.optimizer import adamw, warmup_cosine
from repro_torch.train.train_step import (
    TrainState,
    init_train_state,
    make_train_step,
)

#: ~100M params: 12L d=512 ff=2048 vocab=32000 -> 0.10B
CFG_100M = ModelConfig(
    name="danube-100m", family=Family.DENSE, n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=32000, head_dim=64,
    rope_theta=1e4, sliding_window=512)
KEEP_CHECKPOINTS = 2


@dataclasses.dataclass
class CarbonAwareRun:
    """The ledger, its carbon against the always-on baseline, the losses
    of the steps run and the final state."""

    ledger: list
    aware_g: float
    base_g: float
    losses: list
    resumed_from: int | None
    state: TrainState


def pods(device) -> list[PodSpec]:
    return [PodSpec(name="ciso", trace=grid_trace(Grid.CISO, device=device),
                    chips=8, embodied_g=8 * 0.9e6),
            PodSpec(name="rural", trace=grid_trace(Grid.RURAL, device=device),
                    chips=8, embodied_g=8 * 0.9e6)]


def trainer(steps: int, device) -> CarbonAwareTrainer:
    return CarbonAwareTrainer(
        pods=pods(device), schedule=CarbonSchedule(deadline_h=48),
        steps_per_hour_full=max(steps // 12, 1))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, params: dict | None = None) -> CarbonAwareRun:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt or os.path.join(tempfile.gettempdir(), "ca_ckpt")

    cfg = CFG_100M
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.0f}M params")
    shape = ShapeConfig("train", ShapeKind.TRAIN, args.seq_len, args.batch)

    model = (Transformer(cfg, device=dev, generator=torch.Generator(
        dev).manual_seed(0)) if params is None
             else Transformer.from_params(cfg, params, device=dev))
    opt = adamw(warmup_cosine(1e-3, 30, args.steps))
    state = init_train_state(dict(model.named_parameters()), opt)
    step_fn = make_train_step(model, opt, remat="dots")

    # resume if a checkpoint exists (the pause/restart substrate)
    latest = ckpt.latest_step(ckpt_dir)
    if latest:
        state = ckpt.restore(ckpt_dir, latest, state, device=dev)
        print(f"resumed from checkpoint step {latest}")

    losses = []

    def step_hook(pod_idx: int, n_steps: int, dp_frac: float) -> int:
        nonlocal state
        for _ in range(n_steps):
            i = int(state.step)
            state, metrics = step_fn(state, batch_for(cfg, shape, step=i,
                                                      device=dev))
            losses.append(float(metrics["loss"]))
        step = int(state.step)
        if ckpt.latest_step(ckpt_dir) != step:
            ckpt.save(ckpt_dir, step, state)  # atomic, resumable
            ckpt.prune(ckpt_dir, KEEP_CHECKPOINTS)
        return n_steps

    tr = trainer(args.steps, dev)
    ledger = tr.run(total_steps=args.steps - int(state.step),
                    start_hour=6, step_hook=step_hook)

    print(f"\nhourly ledger ({len(ledger)} simulated hours):")
    for r in ledger[:12]:
        print(f"  h{r.hour:03d} {r.pod:6s} {r.action:14s} dp={r.dp_frac:.2f} "
              f"steps={r.steps:4d} op={r.op_g:8.1f}g ci={r.ci:5.1f}")
    aware = tr.total_carbon(ledger)
    base, _ = tr.baseline_carbon(args.steps)
    print(f"\ncarbon: {aware / 1e3:.2f} kgCO2e vs always-on "
          f"{base / 1e3:.2f} kgCO2e -> saving {(1 - aware / base) * 100:.1f}%")
    if losses:
        print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(log-vocab {math.log(cfg.vocab_size):.3f})")
    return CarbonAwareRun(ledger=ledger, aware_g=aware, base_g=base,
                          losses=losses, resumed_from=latest, state=state)


if __name__ == "__main__":
    main()
