"""Plain float32 reference of a training step: the family's loss
(``loss_fn``: its served model's forward over the whole sequence, mean
next-token cross-entropy), autograd, clipping by the global norm, AdamW.
It starts from the seed's weights drawn afresh and takes the same token
batches as the program.

AdamW as the configuration's recipe states it: gradients clipped to
``max_grad_norm`` by their global norm (floored at 1e-9), moments in
float32 with bias correction from step 1, ``eps`` added to the root of
the second moment, decoupled weight decay on tensors of two or more
dimensions, a constant learning rate.
"""

from __future__ import annotations

from types import ModuleType
from typing import Callable

import torch

from bench.reference.precision import Arith


def steps(cfg: dict, family: ModuleType,
          seed_weights: Callable[[str], dict], batches: list, recipe: dict,
          precision: str = "float32") -> dict:
    """Train the family's model (its ``groups`` and ``loss_fn``) from the
    seed's weights on ``batches`` [(tokens, labels)]:
    {"loss": [per step], "grad": {leaf: norm of step 1's clipped
    gradient}, "change": {leaf: norm of the weights' change after the
    last step}}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ar = Arith(precision)
    m = cfg["model"]
    p = {}
    for g in family.groups(m):
        p.update({n: t.float() for n, t in seed_weights(g).items()})
    for t in p.values():
        t.requires_grad_(True)
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = recipe["b1"], recipe["b2"], recipe["eps"]
    lr, wd = recipe["lr"], recipe["weight_decay"]
    out: dict = {"loss": []}
    for step, (tokens, labels) in enumerate(batches, start=1):
        loss = family.loss_fn(cfg, p, tokens, labels, ar)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(recipe["max_grad_norm"] / norm.clamp_min(1e-9),
                                max=1.0)
            if step == 1:
                out["grad"] = {k: float(g.norm() * scale)
                               for k, g in grads.items()}
            for k, v in p.items():
                g = grads.pop(k) * scale
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).add_(g.square(), alpha=1 - b2)
                upd = (mu[k] / (1 - b1 ** step)) / (
                    (nu[k] / (1 - b2 ** step)).sqrt() + eps)
                if v.ndim >= 2:
                    upd = upd + wd * v
                v.sub_(lr * upd)
    del mu, nu
    with torch.no_grad():
        out["change"] = {}
        for g in family.groups(m):
            for n, t0 in seed_weights(g).items():
                out["change"][n] = float((p[n] - t0.float()).norm())
    return out


def worst_leaf_gap(prog: dict, ref: dict, floor_share: float = 1e-3
                   ) -> tuple[float, str]:
    """max over leaves of |prog - ref| / max(ref, median ref), leaving out
    leaves whose reference reads under ``floor_share`` x the median."""
    vals = sorted(ref.values())
    med = vals[len(vals) // 2]
    worst, name = 0.0, ""
    for k, r in ref.items():
        if r < floor_share * med:
            continue
        gap = abs(prog[k] - r) / max(r, med)
        if gap > worst:
            worst, name = gap, k
    return worst, name


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def numbers(got: dict, ref: dict) -> dict:
    """The numbers a training cell may compare, from two ``steps``-shaped
    readings: the widest relative loss gap over the steps, and the worst
    leaf of the first clipped gradient's and of the change's norms."""
    grad, grad_leaf = worst_leaf_gap(got["grad"], ref["grad"])
    change, change_leaf = worst_leaf_gap(got["change"], ref["change"])
    return {"loss_gap": loss_gap(got["loss"], ref["loss"]),
            "grad_norm_gap": grad, "change_norm_gap": change,
            "worst_grad_leaf": grad_leaf, "worst_change_leaf": change_leaf}
