"""Activation-checkpoint (remat) policies (port of
``src/repro/train/remat.py``; ``repro_torch.train.remat`` re-exports them).

Applied per super-block in ``Transformer.forward_train``: the backward
pass recomputes what the policy does not save.

Policies:
  ``none``     save everything (no recompute, most activation memory)
  ``dots``     save the outputs of matrix products with no batch
               dimension (``aten.mm``, ``aten.addmm``: the projections),
               recompute the rest, batched products (``aten.bmm``: the
               attention scores) included; JAX's
               ``dots_with_no_batch_dims_saveable``
  ``minimal``  save nothing inside the super-block (most recompute, least
               memory)

``minimal`` is ``torch.utils.checkpoint.checkpoint`` (non-reentrant);
``dots`` the same with a selective-checkpoint policy, which needs
``torch.utils.checkpoint.create_selective_checkpoint_contexts`` (torch 2.4
and later): without it ``dots`` raises rather than fall back.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

POLICIES = ("none", "dots", "minimal")


def _save_unbatched_dots(ctx, op, *args, **kwargs):
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    if not hasattr(ckpt, "create_selective_checkpoint_contexts"):
        raise RuntimeError(
            f"remat policy 'dots' needs torch.utils.checkpoint."
            f"create_selective_checkpoint_contexts, which torch "
            f"{torch.__version__} lacks")
    return ckpt.create_selective_checkpoint_contexts(_save_unbatched_dots)


def wrap_remat(fn, policy: str):
    """``fn`` under the named remat policy."""
    if policy == "none":
        return fn
    if policy == "dots":
        _dots_context()  # raise now, not in the middle of a step
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=_dots_context)
    if policy == "minimal":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat policy {policy!r}; known: {POLICIES}")
