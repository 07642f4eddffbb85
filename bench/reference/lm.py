"""Plain float32 building blocks of the served models, from the
configuration's sizes alone: RMSNorm, rotary embedding, causal (windowed)
GQA attention, the Mamba-2 mixer and its SSD scan, SwiGLU, MoE with GShard
capacity, and the teacher-forced forward and training loss that stack a
family's layers. A family (``bench/families/``) composes its layers from
these and hands its weight groups and layer function to ``served_logits``
and ``loss``; the ``lm`` family builds dense GQA transformers
(h2o-danube) and the Mamba-2 / attention / MoE hybrid (jamba as the port
configures it) from them.

No kernel, no cache, no batching tricks: a teacher-forced forward over
prompt + served tokens, layer by layer (each layer's weights drawn afresh
from the seed, then freed), that returns the logits at the positions that
produced served tokens. Two things the configuration states are modelled
because they define the served model:

- ``cache_dtype``: a decode step reads keys and values from a cache of
  that dtype, so queries past the prompt attend over keys and values
  rounded to it; the prompt's own queries (the prefill) see them unrounded.
- MoE capacity (GShard): tokens are grouped, each expert takes at most C
  assignments a group in token order and choice order, the rest are
  dropped (the residual carries them). The prompt is one block of
  batch x prompt tokens; each later position is a block of batch tokens.

Departures from the published models are those of the configuration file
(jamba's Mamba-2 mixers). This module imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from bench.reference.precision import Arith

Q_BLOCK = 256  # query rows of one attention block
SSD_CHUNK = 64  # the reference's own chunk of the SSD scan


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x (B, L, H, D) at positions (L,),
    angles in float32 as the published models compute them."""
    D = x.shape[-1]
    inv = (1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D)).float()
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, w, m, S, cache_dtype, ar: Arith):
    """Causal (windowed) GQA attention over x (B, L, d); queries at
    positions >= S read keys/values rounded to ``cache_dtype``."""
    B, L, _ = x.shape
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = ar.mm(x, w["attn.wq"]).view(B, L, H, D)
    k = ar.mm(x, w["attn.wk"]).view(B, L, Hkv, D)
    v = ar.mm(x, w["attn.wv"]).view(B, L, Hkv, D)
    out = attend(q, k, v, m, S, cache_dtype, ar)
    return ar.mm(out.view(B, L, H * D), w["attn.wo"])


def attend(q, k, v, m, S, cache_dtype, ar: Arith):
    """Rotary positions (where ``rope_theta``), then causal (windowed)
    attention of q (B, L, H, D) over k, v (B, L, Hkv, D): queries at
    positions >= S read k, v rounded to ``cache_dtype``. -> (B, L, Hkv,
    H // Hkv, D)."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    if m["rope_theta"]:
        pos = torch.arange(L, device=q.device)
        q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    kc = k.to(cache_dtype).float()
    vc = v.to(cache_dtype).float()
    win = m.get("sliding_window")
    qg = q.view(B, L, Hkv, H // Hkv, D)
    out = torch.empty(B, L, Hkv, H // Hkv, D, device=q.device)
    starts = [(a, min(a + Q_BLOCK, end), kk, vv)
              for lo, end, kk, vv in ((0, S, k, v), (S, L, kc, vc))
              for a in range(lo, end, Q_BLOCK)]
    for q0, q1, kk, vv in starts:
        k0 = 0 if win is None else max(0, q0 - win + 1)
        s = ar.einsum("bqhgd,bkhd->bhgqk", qg[:, q0:q1], kk[:, k0:q1])
        s = s / math.sqrt(D)
        qp = torch.arange(q0, q1, device=q.device)[:, None]
        kp = torch.arange(k0, q1, device=q.device)[None, :]
        keep = kp <= qp
        if win is not None:
            keep &= kp > qp - win
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        out[:, q0:q1] = ar.einsum("bhgqk,bkhd->bqhgd", p, vv[:, k0:q1])
    return out


def ssd(x, dt, A, Bm, Cm):
    """The Mamba-2 recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, in chunks of SSD_CHUNK by its matrix (dual) form.
    x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, N) -> y (B, L, H, P)."""
    Bsz, L, H, P = x.shape
    N, Q = Bm.shape[-1], SSD_CHUNK
    pad = (-L) % Q
    if pad:  # dt = 0 on the padding: identity steps
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    c = x.shape[1] // Q
    xd = (x * dt[..., None]).view(Bsz, c, Q, H, P)
    a = torch.cumsum((dt * A).view(Bsz, c, Q, H), dim=2)
    Bc, Cc = Bm.view(Bsz, c, Q, N), Cm.view(Bsz, c, Q, N)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = a[:, :, :, None, :] - a[:, :, None, :, :]
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = torch.einsum("bcijh,bcjhp->bcihp", decay * cb[..., None], xd)
    to_end = torch.exp(a[:, :, -1:, :] - a)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc,
                          xd * to_end[..., None])
    h = torch.zeros(Bsz, H, P, N, device=x.device)
    entering = []
    for i in range(c):
        entering.append(h)
        h = h * torch.exp(a[:, i, -1])[:, :, None, None] + states[:, i]
    hin = torch.stack(entering, dim=1)
    y = y + torch.einsum("bcin,bchpn->bcihp", Cc, hin) * \
        torch.exp(a)[..., None]
    return y.reshape(Bsz, c * Q, H, P)[:, :L]


def causal_conv(x, w, b):
    """Depthwise causal conv of x (B, L, C) with taps w (K, C), then SiLU."""
    K = w.shape[0]
    y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)),
                 w.t().unsqueeze(1), groups=x.shape[-1])
    return F.silu(y.transpose(1, 2) + b)


def mamba(x, w, m, ar: Arith):
    B, L, d = x.shape
    di, N = m["ssm_expand"] * d, m["ssm_state"]
    P = m["ssm_head_dim"]
    H = di // P
    z = ar.mm(x, w["mamba.z_proj"])
    xs = causal_conv(ar.mm(x, w["mamba.x_proj"]), w["mamba.conv_x_w"],
                     w["mamba.conv_x_b"])
    bc = causal_conv(ar.mm(x, w["mamba.bc_proj"]), w["mamba.conv_bc_w"],
                     w["mamba.conv_bc_b"])
    dt = F.softplus(ar.mm(x, w["mamba.dt_proj"]) + w["mamba.dt_bias"])
    A = -torch.exp(w["mamba.A_log"])
    y = ssd(xs.view(B, L, H, P), dt, A, bc[..., :N], bc[..., N:])
    y = y + xs.view(B, L, H, P) * w["mamba.D"][:, None]
    y = rmsnorm(y.reshape(B, L, di) * F.silu(z), w["mamba.norm_scale"],
                m["norm_eps"])
    return ar.mm(y, w["mamba.out_proj"])


def swiglu(x, wg, wu, wd, ar: Arith):
    return ar.mm(F.silu(ar.mm(x, wg)) * ar.mm(x, wu), wd)


def capacity_group(m: dict, tokens: int) -> tuple[int, int]:
    """(group size, capacity) of a block of ``tokens`` tokens."""
    Sg = min(m["moe_group_size"], tokens)
    while tokens % Sg:
        Sg //= 2
    Sg = max(Sg, 1)
    cap = int(m["moe_capacity_factor"] * Sg * m["experts_per_token"]
              / m["n_experts"])
    return Sg, max(8, (cap + 7) // 8 * 8)


def moe_block(x, w, m, ar: Arith):
    """Top-k capacity-routed experts over one block of tokens x (T, d)."""
    T, d = x.shape
    E, k = m["n_experts"], m["experts_per_token"]
    probs = torch.softmax(x @ w["moe.router"], dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    Sg, C = capacity_group(m, T)
    # rank of each (token, choice) within its expert, per group, in token
    # order then choice order
    flat = idx.view(T // Sg, Sg * k)
    onehot = F.one_hot(flat, E)
    rank = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    keep = (rank < C).view(T, k)
    out = torch.zeros_like(x)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, k)
    for e in range(E):
        sel = (idx == e) & keep
        if not bool(sel.any()):
            continue
        rows, g = tok[sel], gate[sel]
        y = swiglu(x[rows], w["moe.w_gate"][e], w["moe.w_up"][e],
                   w["moe.w_down"][e], ar)
        out.index_add_(0, rows, y * g[:, None])
    return out


def moe(x, w, m, S, ar: Arith):
    """The prompt (B, S) is one block; each later position one block."""
    B, L, d = x.shape
    out = torch.empty_like(x)
    out[:, :S] = moe_block(x[:, :S].reshape(B * S, d), w, m, ar).view(
        B, S, d)
    for t in range(S, L):
        out[:, t] = moe_block(x[:, t], w, m, ar)
    return out


def local(group_weights: dict) -> dict:
    """A layer's weights under their names inside the layer."""
    return {n.split(".", 2)[-1] if n.startswith("layers.") else n: t
            for n, t in group_weights.items()}


#: a family's layer: (x (B, L, d), its weights by local name, the model's
#: sizes, layer index, prompt length S, cache dtype, Arith) -> x
Layer = Callable[..., torch.Tensor]


def served_logits(cfg: dict, groups: list[str], layer: Layer,
                  seed_weights: Callable[[str], dict],
                  batches: list[tuple[torch.Tensor, int]],
                  precision: str = "float32") -> list[torch.Tensor]:
    """For each (tokens (B, L), prompt length S): the float32 logits
    (B, L - S + 1, V) at positions S-1 .. L-1, the positions whose
    argmax a greedy server emits. ``groups`` are the family's weight
    groups in order ("embed", "layers.<i>", ..., "head"), ``layer`` its
    layer, ``seed_weights(group)`` a group's weights in their served
    dtype."""
    m = cfg["model"]
    cache_dtype = getattr(torch, cfg["cache_dtype"])
    ar = Arith(precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hs: list = [None] * len(batches)
    for gname in groups:
        w = {n: t.float() for n, t in local(seed_weights(gname)).items()}
        for j, (tokens, S) in enumerate(batches):
            if gname == "embed":
                hs[j] = w["embed"][tokens]
            elif gname == "head":
                x = rmsnorm(hs[j][:, S - 1:], w["final_norm.scale"],
                            m["norm_eps"])
                hs[j] = ar.mm(x, w["lm_head"])
            else:
                hs[j] = layer(hs[j], w, m, int(gname.split(".")[1]), S,
                              cache_dtype, ar)
        del w
    return hs


def loss(cfg: dict, layer: Layer, p: dict, tokens: torch.Tensor,
         labels: torch.Tensor, ar: Arith) -> torch.Tensor:
    """Mean next-token cross-entropy of the whole sequence through the
    family's ``layer``, from the float32 weights ``p`` by their names."""
    m = cfg["model"]
    L = tokens.shape[1]
    cache_dtype = getattr(torch, cfg["cache_dtype"])
    x = p["embed"][tokens]
    for i in range(m["n_layers"]):
        pre = f"layers.{i}."
        w = {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}
        x = layer(x, w, m, i, L, cache_dtype, ar)
    x = rmsnorm(x, p["final_norm.scale"], m["norm_eps"])
    logits = ar.mm(x, p["lm_head"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
