"""The training step: loss -> gradients -> AdamW, with microbatch
accumulation, remat policies and compressed data parallelism (port of
``src/repro/train/train_step.py``).

A ``TrainState`` holds the parameters as a dict {name: tensor}; the step
binds them into the model for the forward and the backward (the model's
own parameters are put back after), differentiates the loss with respect
to them and hands the gradients to the optimizer, which updates them in
place. ``init_train_state(dict(model.named_parameters()), opt)`` therefore
trains the model itself; a restored checkpoint's tensors train as well.

Microbatching splits (B, ...) into k slices (``positions`` (3, B, S) on
dim 1) and accumulates float32 gradients divided by k; the metrics are
the microbatches' mean.

Data parallelism (``mesh=`` a ``DeviceMesh`` or a process group, every
rank calling the step with its own shard of the batch): ``compression=
"none"`` all-reduces the float32 gradients and divides by the rank count,
the mean over the global batch that the reference's pjit computes;
``"bf16"`` and ``"int8"`` go through ``compression.compress_and_reduce``
with each rank's own error-feedback residual. The metrics are averaged
over the ranks, and every rank applies the same update to the same
parameters.

The kernels have no backward (``use_kernels=True`` raises, as the
reference's Pallas kernels have none): the step runs the model through
``train_paths(cfg)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import AdamState, Optimizer


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: AdamState
    ef: Optional[dict]  # error-feedback residuals (compressed modes only)

    @property
    def step(self) -> torch.Tensor:
        return self.opt.count


def init_train_state(params: dict, optimizer: Optimizer, *,
                     compression: str = "none") -> TrainState:
    if compression not in comp.MODES:
        raise ValueError(f"unknown compression {compression!r}; known: "
                         f"{comp.MODES}")
    ef = (comp.init_error_feedback(params) if compression != "none"
          else None)
    return TrainState(params=params, opt=optimizer.init(params), ef=ef)


@contextlib.contextmanager
def bound(model: torch.nn.Module, params: dict):
    """The model computes with ``params`` ({name: tensor}) in place of its
    own parameters inside the block, its backward and remat recompute
    included; its parameters are put back on exit."""
    saved = []
    try:
        for name, t in params.items():
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            saved.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = t
        yield
    finally:
        for mod, attr, p in saved:
            mod._parameters[attr] = p


def _split(batch: dict, k: int) -> list[dict]:
    """k microbatches: (B, ...) leaves split on dim 0, ``positions`` on
    dim 1."""
    def parts(name, x):
        dim = 1 if name == "positions" else 0
        if x.shape[dim] % k:
            raise ValueError(f"{name}: batch {x.shape[dim]} does not split "
                             f"into {k} microbatches")
        return x.chunk(k, dim=dim)

    split = {name: parts(name, x) for name, x in batch.items()}
    return [{name: split[name][i] for name in batch} for i in range(k)]


def grads_over_microbatches(model: Transformer, params: dict, batch: dict, *,
                            microbatches: int = 1, remat: str = "dots"
                            ) -> tuple[dict, dict]:
    """Mean-over-batch loss gradient (float32 when accumulated over k > 1
    microbatches) and the metrics."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    chunks = [batch] if microbatches <= 1 else _split(batch, microbatches)
    acc, metrics = None, []
    with bound(model, leaves):
        for b in chunks:
            with obs.span("train.forward"):
                loss, m = loss_fn(model, b, remat=remat)
            with obs.span("train.backward"):
                g = torch.autograd.grad(loss, list(leaves.values()))
            metrics.append({k: v.detach() for k, v in m.items()})
            if microbatches <= 1:
                acc = dict(zip(leaves, g))
            elif acc is None:
                acc = {k: gi.float() / microbatches for k, gi in zip(leaves, g)}
            else:
                for k, gi in zip(leaves, g):
                    acc[k] += gi.float() / microbatches
    mean = {k: torch.stack([m[k] for m in metrics]).mean()
            for k in metrics[0]}
    return acc, mean


def make_train_step(model: Transformer, optimizer: Optimizer, *,
                    mesh=None, remat: str = "dots", microbatches: int = 1,
                    compression: str = "none", use_kernels: bool = False,
                    grad_dtype: torch.dtype | None = None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``grad_dtype`` casts the gradients before the optimizer (the
    reference pins the gradient dtype there). ``mesh``: a 1-D
    ``DeviceMesh`` (``repro_torch.serve.distributed.data_mesh``) or a
    process group to average over; compressed modes need one."""
    if use_kernels:
        raise NotImplementedError(
            "the CUDA kernels have no backward (neither have the "
            "reference's Pallas kernels); training runs the plain paths "
            "(models.train_paths), use_kernels=False")
    if compression not in comp.MODES:
        raise ValueError(f"unknown compression {compression!r}; known: "
                         f"{comp.MODES}")
    if compression != "none" and mesh is None:
        raise ValueError(f"compression {compression!r} needs a mesh")
    group = None if mesh is None else comp.dp_group(mesh)
    n_dp = 1 if group is None else comp.dp_size(group)

    def train_step(state: TrainState, batch: dict):
        grads, metrics = grads_over_microbatches(
            model, state.params, batch, microbatches=microbatches,
            remat=remat)
        ef = state.ef
        if group is not None:
            if compression == "none":
                grads = comp.mean_over_ranks(grads, group, n_dp)
            else:
                grads, ef = comp.compress_and_reduce(
                    grads, ef, mode=compression, group=group, n_dp=n_dp)
            metrics = comp.mean_metrics(metrics, group, n_dp)
        if grad_dtype is not None:
            grads = {k: g.to(grad_dtype) for k, g in grads.items()}
        with obs.span("train.optimizer"):
            params, opt, gnorm = optimizer.update(grads, state.opt,
                                                  state.params)
        metrics = dict(metrics, grad_norm=gnorm, step=opt.count.float())
        return TrainState(params, opt, ef), metrics

    return train_step
