"""AdamW and learning-rate schedules (port of
``src/repro/train/optimizer.py``).

The reference's arithmetic, in its order: clip by the global norm first
(``max(norm, 1e-9)``), ``count + 1`` drives both the bias correction and
the learning rate, the moments are float32 whatever the parameter dtype,
decoupled weight decay only on tensors of two or more dimensions, the
update in float32 cast back to the parameter dtype. ``torch.optim.AdamW``
and ``clip_grad_norm_`` order these operations and reduce the norm
differently, so they are not used.

Trees are dicts {name: tensor}. ``update`` writes the new parameters and
moments into the tensors it is given and returns them: the reference's
jitted update returns new arrays, but two copies of a model's weights and
moments do not fit one card at the sizes it trains. ``count`` stays a
0-d int32 tensor on the parameters' device, so nothing syncs the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor  # () int32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state, grad norm)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of each leaf's float32 sum of squares."""
    sums = [leaf.float().square().sum() for leaf in tree.values()]
    return torch.stack(sums).sum().sqrt()


def clip_by_global_norm(tree: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """(each leaf in float32 times min(1, max_norm / max(norm, 1e-9)),
    norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return {k: g.float() * scale for k, g in tree.items()}, norm


def adamw(lr: Callable[[torch.Tensor], torch.Tensor] | float, *,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_lr(lr)

    def init(params: dict) -> AdamState:
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        count = torch.zeros((), dtype=torch.int32,
                            device=next(iter(params.values())).device)
        return AdamState(mu=zeros, nu={k: z.clone() for k, z in zeros.items()},
                         count=count)

    @torch.no_grad()
    def update(grads: dict, state: AdamState, params: dict):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        count = state.count + 1
        t = count.float()
        step_lr = lr_fn(count)
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        for k, p in params.items():
            g, m, v = grads.pop(k), state.mu[k], state.nu[k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            step = (m / c1) / ((v / c2).sqrt() + eps)
            p32 = p.float()
            wd = weight_decay if p.ndim >= 2 else 0.0
            p.copy_((p32 - step_lr * (step + wd * p32)).to(p.dtype))
        return params, AdamState(state.mu, state.nu, count), gnorm

    return Optimizer(init=init, update=update)


# --- schedules -----------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr``, then a cosine to ``final_frac`` of
    it at ``total_steps``; float32, as the reference."""
    def lr(count: torch.Tensor) -> torch.Tensor:
        t = count.float()
        warm = peak_lr * t / max(warmup_steps, 1)
        prog = torch.clamp((t - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(t < warmup_steps, warm, cos)

    return lr


def constant_lr(value: float) -> Callable:
    return lambda count: torch.tensor(value, dtype=torch.float32,
                                      device=count.device)
