"""Mixture-of-Experts FF layer: top-k routing, GShard-style grouped
dispatch (port of ``src/repro/models/moe.py``).

Used by ``qwen3-moe-30b-a3b`` (128 experts, top-8). Tokens are split into
groups of at most ``moe_group_size``; each group builds a one-hot
(S_g, E, C) dispatch tensor with per-group capacity C, tokens over a
group's capacity are dropped (the residual carries them), and the expert
FF runs as three grouped matmuls (gate, up, down) on the (E, G*C, d)
capacity layout through the kernel set it is given: the CUDA kernel on
the card, in prefill and in decode alike. As in the reference, every
expert's slots are computed, empty or not.

Nemotron-H's options (``configs.pattern``): a ``sigmoid_bias`` router
(sigmoid scores, the top-k of score + ``e_score_correction_bias``, the
chosen scores renormalised and scaled by ``moe_routed_scale``; no
auxiliary loss, the bias balances the load), ``relu2`` experts (two
grouped matmuls, up then down on relu(h)^2, no gate weight) and a
``shared`` relu^2 expert over every token, added to the routed output.
The spans ``moe.route``, ``moe.experts`` and ``moe.shared`` split the
layer (``repro_torch.obs``).

The integer dispatch equals the reference's exactly: one-hots are built by
comparison (an index past the end gives a zero row, as ``jax.nn.one_hot``
does) and the running positions are int32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.pattern import option
from repro_torch.kernels.ops import KERNELS, KernelSet
from repro_torch.models.layers import Relu2MLP, truncated_normal_


class MoE(nn.Module):
    """Router (float32) and stacked expert weights, reference leaf names;
    a sigmoid router's float32 ``e_score_correction_bias``, relu^2
    experts without ``w_gate``, and the ``shared`` expert where the
    config has them."""

    def __init__(self, cfg: ModelConfig, *, device,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_ff
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.router = truncated_normal_((d, e), d ** -0.5, **kw)
        if option(cfg, "moe_router") == "sigmoid_bias":
            self.e_score_correction_bias = nn.Parameter(
                torch.zeros((e,), device=device, dtype=torch.float32))
        if option(cfg, "moe_act") == "swiglu":
            self.w_gate = truncated_normal_((e, d, ff), d ** -0.5,
                                            dtype=dtype, **kw)
        self.w_up = truncated_normal_((e, d, ff), d ** -0.5, dtype=dtype, **kw)
        self.w_down = truncated_normal_((e, ff, d), ff ** -0.5, dtype=dtype,
                                        **kw)
        if option(cfg, "shared_expert_ff"):
            self.shared = Relu2MLP(d, option(cfg, "shared_expert_ff"),
                                   dtype=dtype, **kw)

    def forward(self, x: torch.Tensor, kernels: KernelSet = KERNELS
                ) -> tuple[torch.Tensor, torch.Tensor | float]:
        return moe_forward(self, self.cfg, x, kernels=kernels)


def router_probs(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """Top-k routing: renormalized softmax gates, or (``sigmoid_bias``)
    the sigmoid scores of the experts chosen by score + correction bias,
    renormalized and scaled by ``moe_routed_scale``.

    x (..., d) -> gates (..., k), expert ids (..., k), full probs (..., E)
    (the sigmoid scores for ``sigmoid_bias``).
    """
    logits = x.float() @ p.router
    k = cfg.experts_per_token
    if option(cfg, "moe_router") == "sigmoid_bias":
        scores = torch.sigmoid(logits)
        ids = torch.topk(scores + p.e_score_correction_bias, k, dim=-1).indices
        gates = scores.gather(-1, ids)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
        return gates * option(cfg, "moe_routed_scale"), ids, scores
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, ids, probs


def group_capacity(cfg: ModelConfig, group_tokens: int) -> int:
    cap = int(cfg.moe_capacity_factor * group_tokens * cfg.experts_per_token
              / cfg.n_experts)
    return max(8, (cap + 7) // 8 * 8)  # a multiple of 8, at least 8


def group_size(cfg: ModelConfig, tokens: int) -> int:
    """The reference's search: the largest power-of-two fraction of
    ``moe_group_size`` (capped at ``tokens``) that divides ``tokens``."""
    Sg = min(cfg.moe_group_size, tokens)
    while tokens % Sg:  # groups must tile the token stream
        Sg //= 2
    return max(Sg, 1)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot over a new last axis; indices outside [0, n) give zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def dispatch_positions(ids: torch.Tensor, n_experts: int, capacity: int):
    """ids (G,Sg,k) -> (onehot_e (G,Sg,k,E) int32, pos (G,Sg,k) int32, keep):
    each (token, choice)'s slot in its expert's per-group buffer, in token
    order, and whether it fits the capacity."""
    G, Sg, k = ids.shape
    onehot_e = _one_hot(ids, n_experts, torch.int32)
    flat = onehot_e.reshape(G, Sg * k, n_experts)
    pos_in_e = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = (pos_in_e * flat).sum(-1, dtype=torch.int32).reshape(G, Sg, k)
    return onehot_e, pos, pos < capacity


def moe_forward(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                kernels: KernelSet = KERNELS
                ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """MoE FF over x (B, S, d). Returns (out (B,S,d), aux_loss (); 0.0
    for ``sigmoid_bias``)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    Sg = group_size(cfg, T)
    G = T // Sg
    C = group_capacity(cfg, Sg)

    with obs.span("moe.route"):
        xt = x.reshape(G, Sg, d)
        gates, ids, probs = router_probs(p, cfg, xt)  # (G,Sg,k) / (G,Sg,E)
        onehot_e, pos, keep = dispatch_positions(ids, E, C)

    with obs.span("moe.experts"):
        # dispatch/combine tensors: (G, Sg, E, C)
        dt = xt.dtype
        disp = (onehot_e.to(dt)[..., None]
                * _one_hot(pos, C, dt)[..., None, :]
                * keep[..., None, None].to(dt))  # (G,Sg,k,E,C)
        dispatch = disp.sum(2)
        combine = (disp * gates[..., None, None].to(dt)).sum(2)
        del disp

        # expert inputs (G, E, C, d), laid out (E, G*C, d) for the kernel
        xe = torch.einsum("gsd,gsec->gecd", xt, dispatch)
        xe2 = xe.transpose(0, 1).reshape(E, G * C, d)
        if option(cfg, "moe_act") == "relu2":
            h = kernels.grouped_matmul(xe2, p.w_up)
            ye2 = kernels.grouped_matmul(F.relu(h).square(), p.w_down)
        else:
            h = kernels.grouped_matmul(xe2, p.w_gate)
            u = kernels.grouped_matmul(xe2, p.w_up)
            ye2 = kernels.grouped_matmul(F.silu(h) * u, p.w_down)
        ye = ye2.reshape(E, G, C, d).transpose(0, 1)
        out = torch.einsum("gecd,gsec->gsd", ye, combine).reshape(B, S, d)

    if hasattr(p, "shared"):
        with obs.span("moe.shared"):
            out = out + p.shared(x)

    if option(cfg, "moe_router") == "sigmoid_bias":
        return out, 0.0
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    f = onehot_e.sum(2).float().mean((0, 1))  # routed fraction per expert
    pm = probs.mean((0, 1))
    aux = E * torch.sum(f * pm) * (1.0 / k)
    return out, aux
