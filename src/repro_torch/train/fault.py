"""Fault tolerance: straggler masking and elastic restart (port of
``src/repro/train/fault.py``).

* **Straggler mitigation**: ranks that miss a step's deadline are masked
  out of the gradient mean, which is rescaled by the surviving count; if
  fewer than ``min_quorum`` of the ranks survive, the step is a no-op and
  reports ``aborted = 1``. Here the mask is an input, as in the reference.
* **Elastic restart**: on a failure the runner restores the latest atomic
  checkpoint (``repro_torch.checkpoint``) and continues at its step; the
  data pipeline is (step, shard)-deterministic, so the run equals an
  uninterrupted one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.transformer import Transformer
from repro_torch.train.optimizer import Optimizer, global_norm
from repro_torch.train.train_step import TrainState, grads_over_microbatches


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """``deadline_factor``: multiple of the median step time after which a
    rank is declared straggling (a real deployment); ``min_quorum``: below
    this surviving fraction the step aborts."""

    deadline_factor: float = 2.0
    min_quorum: float = 0.5


def make_straggler_train_step(model: Transformer, optimizer: Optimizer, *,
                              n_shards: int, remat: str = "dots",
                              policy: StragglerPolicy = StragglerPolicy()
                              ) -> Callable:
    """``train_step(state, sharded_batch, alive_mask)``: ``sharded_batch``
    leaves are (n_shards, B/n, ...), one slice a rank; ``alive_mask``
    (n_shards,) bool. The gradient is the mean over the alive ranks, the
    loss their alive-weighted mean; if the quorum fails, the state passes
    through unchanged."""

    def train_step(state: TrainState, sharded_batch: dict,
                   alive_mask: torch.Tensor):
        alive = torch.as_tensor(alive_mask).float()
        n_alive = float(alive.sum())
        quorum_ok = n_alive >= policy.min_quorum * n_shards
        acc, losses = None, []
        for i in range(n_shards):
            g, m = grads_over_microbatches(
                model, state.params, {k: v[i] for k, v in
                                      sharded_batch.items()}, remat=remat)
            w = float(alive[i])
            if acc is None:
                acc = {k: w * gi.float() for k, gi in g.items()}
            else:
                for k, gi in g.items():
                    acc[k] += w * gi.float()
            losses.append(m["loss"] * w)
        denom = max(n_alive, 1.0)
        grads = {k: g / denom for k, g in acc.items()}
        loss = torch.stack(losses).sum() / denom
        if quorum_ok:
            params, opt, gnorm = optimizer.update(grads, state.opt,
                                                  state.params)
            state = TrainState(params, opt, state.ef)
        else:
            gnorm = global_norm(grads)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "n_alive": torch.tensor(n_alive),
                   "aborted": torch.tensor(0.0 if quorum_ok else 1.0)}
        return state, metrics

    return train_step


@dataclasses.dataclass
class ElasticRunner:
    """Checkpoint-driven training loop: every ``save_every`` steps it saves
    the state under ``ckpt_root``; ``failures`` {step: handler(state) ->
    (state, step_fn)} stand for failure events, whose handler restores
    and rebuilds, and the loop continues at the restored step."""

    ckpt_root: str
    save_every: int = 10

    def run(self, state: TrainState, steps: int, *,
            make_batch: Callable[[int], Any],
            step_fn: Callable,
            failures: dict[int, Callable] | None = None,
            save_fn: Callable | None = None) -> tuple[TrainState, list]:
        from repro_torch import checkpoint as ckpt

        failures = dict(failures or {})
        save_fn = save_fn or (lambda s, n: ckpt.save(self.ckpt_root, n, s))
        history = []
        i = int(state.step)
        while i < steps:
            if i in failures:
                state, step_fn = failures.pop(i)(state)
                i = int(state.step)
                continue
            state, metrics = step_fn(state, make_batch(i))
            i = int(state.step)
            history.append({k: float(v) for k, v in metrics.items()})
            if i % self.save_every == 0:
                save_fn(state, i)
        return state, history
