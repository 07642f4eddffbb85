"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(port of ``src/repro/launch/train.py``).

Drives real training steps: the synthetic data pipeline, AdamW with a
warm-up cosine schedule, remat, microbatching, atomic checkpoints with
resume from ``--ckpt-dir``. The reference's flags, plus ``--device``
(default ``cuda``) and ``--dtype`` of the weights (``float32`` by
default, as the reference's launcher makes them). Weights are drawn from a
generator seeded by ``--seed``; ``--full`` takes the published config
instead of the smoke one. The state trains the model's own parameters (a
resumed run copies the checkpoint into them). ``main(argv)`` returns what
the run produced.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, ShapeKind
from repro_torch.data import batch_for
from repro_torch.device import resolve_device
from repro_torch.models import Transformer
from repro_torch.train.optimizer import adamw, warmup_cosine
from repro_torch.train.train_step import (
    TrainState,
    init_train_state,
    make_train_step,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainRun:
    """What one launcher run produced, for callers that check it."""

    cfg: ModelConfig
    model: Transformer
    state: TrainState
    history: list  # per step: {"loss", "ce", "moe_aux", "grad_norm", "step"}
    step_seconds: list  # per step: wall time of the step, device synced
    tokens_per_step: int


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    return ap.parse_args(argv)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    dtype = DTYPES[args.dtype]
    shape = ShapeConfig("cli", ShapeKind.TRAIN, args.seq_len, args.batch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Transformer(cfg, device=device, dtype=dtype, generator=gen,
                        max_positions=max(args.seq_len, 64))
    opt = adamw(warmup_cosine(args.lr, args.warmup, args.steps))
    state = init_train_state(dict(model.named_parameters()), opt)
    step_fn = make_train_step(model, opt, remat=args.remat,
                              microbatches=args.microbatches)

    start = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            back = ckpt.restore(args.ckpt_dir, latest, state, device=device)
            with torch.no_grad():  # into the model's own parameters
                for name, p in state.params.items():
                    p.copy_(back.params[name])
            state = TrainState(state.params, back.opt, back.ef)
            start = latest
            print(f"resumed from step {latest}")

    history, seconds = [], []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = batch_for(cfg, shape, step=i, dtype=dtype, device=device)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t_step)
        history.append({k: float(v) for k, v in metrics.items()})
        if (i + 1) % args.log_every == 0 or i == start:
            dt = time.perf_counter() - t0
            print(f"step {i + 1:5d}  loss={history[-1]['loss']:.4f}  "
                  f"gnorm={history[-1]['grad_norm']:.3f}  "
                  f"({dt / max(i + 1 - start, 1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.save_every == 0:
            ckpt.save(args.ckpt_dir, i + 1, state)
    if history:
        print(f"done: {args.steps} steps, final loss "
              f"{history[-1]['loss']:.4f}")
    return TrainRun(cfg=cfg, model=model, state=state, history=history,
                    step_seconds=seconds,
                    tokens_per_step=args.batch * args.seq_len)


if __name__ == "__main__":
    main()
