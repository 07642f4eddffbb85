"""Fault-tolerant training on the port: stragglers, node loss, elastic
restart. ``python -m repro_torch.launch.fault_tolerant_training
[--device cuda]``.

The counterpart of the reference's ``examples/fault_tolerant_training.py``,
printing the same lines: a 4-way data-parallel run of the deepseek-7b
smoke config in float32 at a global batch of 8 sequences of 64 tokens,
where (a) rank 2 misses its deadline at steps 5-7 (its gradient is masked
out, the step proceeds) and (b) a node dies at step 12: training restores
the latest atomic checkpoint onto a 2-way data-parallel width and goes on
for 8 more steps (the data pipeline is (step, shard)-deterministic, the
checkpoint mesh-independent). A checkpoint is written after every step.

Weights come from a generator seeded with 0, or from ``params``
({name: tensor}, e.g. the reference's converted by
``models.jax_tree_names``). ``main`` returns a ``FaultRun``.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, ShapeKind
from repro_torch.data import batch_for
from repro_torch.device import resolve_device
from repro_torch.models import Transformer
from repro_torch.train.fault import make_straggler_train_step
from repro_torch.train.optimizer import adamw, warmup_cosine
from repro_torch.train.train_step import TrainState, init_train_state

CFG = get_config("deepseek-7b", smoke=True)
SHAPE = ShapeConfig("t", ShapeKind.TRAIN, 64, 8)
STRAGGLER, STRAGGLE_AT = 2, (5, 6, 7)
FAIL_AT, RESUMED_STEPS = 12, 8


@dataclasses.dataclass
class FaultRun:
    """Per-step metrics of both phases, the restored step and the final
    state."""

    phase1: list  # {"loss", "n_alive", ...} per step, 4-way
    restored: int
    phase2: list  # per step, 2-way
    state: TrainState


def sharded_batch(step: int, n_shards: int, device) -> dict:
    parts = [batch_for(CFG, SHAPE, step=step, shard=s, n_shards=n_shards,
                       device=device) for s in range(n_shards)]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    return ap.parse_args(argv)


def main(argv=None, params: dict | None = None) -> FaultRun:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    root = args.ckpt_dir or tempfile.mkdtemp(prefix="ft_ckpt_")
    model = (Transformer(CFG, device=dev, generator=torch.Generator(
        dev).manual_seed(0)) if params is None
             else Transformer.from_params(CFG, params, device=dev))
    opt = adamw(warmup_cosine(2e-3, 10, 60))
    state = init_train_state(dict(model.named_parameters()), opt)

    step4 = make_straggler_train_step(model, opt, n_shards=4)
    step2 = make_straggler_train_step(model, opt, n_shards=2)

    def metrics_of(m):
        return {k: float(v) for k, v in m.items()}

    print("phase 1: 4-way DP, rank 2 straggles at steps 5-7")
    phase1 = []
    for i in range(FAIL_AT):
        alive = torch.tensor([r != STRAGGLER or i not in STRAGGLE_AT
                              for r in range(4)], device=dev)
        state, m = step4(state, sharded_batch(i, 4, dev), alive)
        phase1.append(metrics_of(m))
        if int(m["n_alive"]) < 4:
            print(f"  step {i:2d}: straggler masked, n_alive="
                  f"{int(m['n_alive'])}, loss={float(m['loss']):.4f}")
        ckpt.save(root, i + 1, state)

    print("phase 2: node failure at step 12 -> elastic restart on 2-way DP")
    latest = ckpt.latest_step(root)
    state = ckpt.restore(root, latest, state, device=dev)
    print(f"  restored step {latest} from {root}")
    phase2 = []
    for i in range(latest, latest + RESUMED_STEPS):
        state, m = step2(state, sharded_batch(i, 2, dev),
                         torch.ones(2, dtype=torch.bool, device=dev))
        phase2.append(metrics_of(m))
    print(f"  continued to step {int(state.step)} on half the fleet, "
          f"loss={float(m['loss']):.4f}")
    print("done: masked-gradient math and restart path both exercised")
    return FaultRun(phase1=phase1, restored=latest, phase2=phase2,
                    state=state)


if __name__ == "__main__":
    main()
