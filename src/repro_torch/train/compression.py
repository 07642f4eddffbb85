"""Gradient compression for the data-parallel all-reduce (port of
``src/repro/train/compression.py``), over ``torch.distributed``.

Modes:

  * ``none``  — the float32 gradients all-reduced and divided by the rank
    count (``mean_over_ranks``).
  * ``bf16``  — the error-compensated gradient cast to bfloat16 and
    all-reduced in bfloat16; the rounding residual feeds the next step.
  * ``int8``  — per-tensor scale: an all-reduce MAX of each tensor's
    ``amax``, then an int32 SUM of the rounded, clipped values (exact);
    the quantization residual feeds the next step.

The reference runs ``compress_and_reduce`` inside ``shard_map`` and keeps
the residuals with a leading (n_dp, ...) axis; here each rank is a
process and keeps its own residual. The tensors of one kind go through
one collective a step (all ``amax`` in one MAX, all int32 values in one
SUM, all bf16 values in one SUM): each element's reduction is what it
would be alone. NCCL reduces on the card; ranks that share a card use
gloo, which reduces host copies.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

MODES = ("none", "bf16", "int8")


def dp_group(mesh):
    """The process group of a 1-D ``DeviceMesh``, or ``mesh`` itself when
    it is a process group."""
    return mesh.get_group(0) if hasattr(mesh, "get_group") else mesh


def dp_size(mesh) -> int:
    """Ranks of a process group, or of a 1-D ``DeviceMesh``."""
    return dist.get_world_size(dp_group(mesh))


def init_error_feedback(params: dict) -> dict:
    """This rank's float32 residual for each parameter, zero."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: dict) -> dict:
    out, i = {}, 0
    for k, t in like.items():
        out[k] = flat[i:i + t.numel()].view(t.shape)
        i += t.numel()
    return out


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A fresh tensor ``x`` reduced over the ranks, on x's device."""
    buf = x.cpu() if dist.get_backend(group) == "gloo" else x
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def mean_over_ranks(grads: dict, group, n_dp: int) -> dict:
    """The float32 gradients summed over the ranks, divided by n_dp."""
    flat = _flat([g.float() for g in grads.values()])
    flat = _all_reduce(flat, dist.ReduceOp.SUM, group)
    return _unflat(flat / n_dp, grads)


def mean_metrics(metrics: dict, group, n_dp: int) -> dict:
    """Each scalar metric averaged over the ranks."""
    flat = torch.stack([m.float() for m in metrics.values()])
    flat = _all_reduce(flat, dist.ReduceOp.SUM, group)
    return dict(zip(metrics, flat / n_dp))


def compress_and_reduce(grads: dict, ef: dict, *, mode: str, group,
                        n_dp: int) -> tuple[dict, dict]:
    """Compress this rank's gradient (plus its residual), reduce over the
    ranks, and return (mean gradient float32, new residual)."""
    comp = {k: g.float() + ef[k] for k, g in grads.items()}
    if mode == "bf16":
        sent = _flat([c.to(torch.bfloat16) for c in comp.values()])
        summed = _all_reduce(sent.clone(), dist.ReduceOp.SUM, group)
        summed, sent = _unflat(summed.float(), comp), _unflat(sent.float(),
                                                              comp)
    elif mode == "int8":
        amax = torch.stack([c.abs().max() for c in comp.values()])
        amax = _all_reduce(amax, dist.ReduceOp.MAX, group)
        scales = amax.clamp_min(1e-12) / 127.0
        q = {k: torch.clamp(torch.round(c / s), -127, 127)
             for (k, c), s in zip(comp.items(), scales)}
        total = _flat([v.to(torch.int32) for v in q.values()])
        total = _all_reduce(total, dist.ReduceOp.SUM, group)
        total = _unflat(total.float(), comp)
        summed = {k: total[k] * s for k, s in zip(comp, scales)}
        sent = {k: q[k] * s for k, s in zip(comp, scales)}
    else:
        raise ValueError(f"compress_and_reduce: mode {mode!r} is not one of "
                         f"{MODES[1:]}")
    mean = {k: summed[k] / n_dp for k in comp}
    new_ef = {k: comp[k] - sent[k] for k in comp}
    return mean, new_ef
