"""The ``nemotron_h`` family: NVIDIA Nemotron-H hybrids of single-kind
blocks (Nemotron-3-Nano-30B-A3B), as the benchmark's contract of a family
names them (``harness.cell.FAMILY``). ``model["layer_pattern"]`` spells the
blocks, one letter each, every block ``x + f(rmsnorm(x))``:

- ``M``: the Mamba-2 mixer. One input projection split into z (d_inner),
  x (d_inner), B and C (``ssm_groups`` x state each) and dt (one a head);
  a depthwise causal conv of width ``ssm_conv`` with bias over x, B and C,
  then SiLU; dt = softplus(dt + dt_bias); the SSD recurrence with A =
  -exp(A_log), head h reading B/C group h // (heads / groups); + D x; the
  gated RMSNorm of y * silu(z) over each group's d_inner / groups channels
  (``MambaRMSNormGated(group_size=...)``); the output projection. d_inner
  is ``ssm_n_heads`` x ``ssm_head_dim``.
- ``*``: causal GQA attention with no positional encoding (Nemotron-H's
  attention applies none), keys and values read from a cache of
  ``cache_dtype`` past the prompt.
- ``E``: the MoE FF. The float32 router gives s = sigmoid(x W); the top-k
  of s + e_score_correction_bias choose the experts; their s, divided by
  their sum + 1e-20 and multiplied by ``moe_routed_scale``, weigh them.
  Each expert is relu^2, down(relu(up x)^2); one shared relu^2 expert of
  ``shared_expert_ff`` over every token is added.

Departures from the published model, each stated in the configuration's
``assumed``: GShard capacity routing (the port's dispatch: groups of
``moe_group_size`` tokens, capacity from ``moe_capacity_factor``,
assignments over capacity dropped) where the published model is dropless;
random weights from the seed, the correction bias drawn N(0, 0.01^2)
(small: it moves near-ties, where a random bias of 0.1 would pile most
tokens onto a few experts).

- ``groups``, ``group_specs``: the weight list under the port's parameter
  names, in drawing order;
- ``served_logits``, ``loss_fn``: the plain float32 reference, built of
  ``reference.lm``'s ``rmsnorm``, ``attend``, ``causal_conv``, ``ssd``
  (called per B/C group) and ``capacity_group``. Its MoE mirrors the
  capacity drops: the prompt is one block of batch x prompt tokens; each
  later position is a block of batch tokens, and all of them route in one
  pass, position-major, each position its own capacity groups;
- ``prefill_flops``, ``decode_flops``, ``train_flops``: model FLOPs as the
  ``lm`` family counts them (2 a multiply-add with the weights, causal
  attention pairs, 5 P N a token and head for the SSD recurrence, the
  top-k experts, the shared expert, the router; no capacity padding, no
  elementwise work);
- ``layer_calls``: the operations and bytes of every kernel call: flash
  and the SSD scan (B and C in groups) at prefill, two grouped matmuls
  (up, down) a MoE layer in every pass.

This module imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from bench.reference import lm
from bench.reference.precision import Arith
from bench.roofline import counts

#: the correction bias's draw: N(0, 1) x this, in float32
BIAS_SCALE = 0.01


# --- weights ---------------------------------------------------------------


def groups(m: dict) -> list[str]:
    return ["embed"] + [f"layers.{i}" for i in range(m["n_layers"])] + ["head"]


def _d_inner(m: dict) -> int:
    return m["ssm_n_heads"] * m["ssm_head_dim"]


def group_specs(m: dict, dtype: torch.dtype, group: str) -> list[tuple]:
    """[(name, shape, dtype, init)] of one group, in drawing order."""
    f32 = torch.float32
    d, V = m["d_model"], m["vocab_size"]
    if group == "embed":
        return [("embed", (V, d), dtype, ("normal", 1.0))]
    if group == "head":
        return [("lm_head", (d, V), dtype, ("normal", d ** -0.5)),
                ("final_norm.scale", (d,), f32, ("norm",))]
    i = int(group.split(".")[1])
    p = f"layers.{i}."
    out = [(p + "norm1.scale", (d,), f32, ("norm",))]
    kind = m["layer_pattern"][i]
    if kind == "*":
        hd, H, Hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
        return out + [
            (p + "attn.wq", (d, H * hd), dtype, ("normal", d ** -0.5)),
            (p + "attn.wk", (d, Hkv * hd), dtype, ("normal", d ** -0.5)),
            (p + "attn.wv", (d, Hkv * hd), dtype, ("normal", d ** -0.5)),
            (p + "attn.wo", (H * hd, d), dtype, ("normal", (H * hd) ** -0.5))]
    if kind == "M":
        di, H, K = _d_inner(m), m["ssm_n_heads"], m["ssm_conv"]
        bc = 2 * m["ssm_groups"] * m["ssm_state"]
        return out + [
            (p + "mamba.z_proj", (d, di), dtype, ("normal", d ** -0.5)),
            (p + "mamba.x_proj", (d, di), dtype, ("normal", d ** -0.5)),
            (p + "mamba.bc_proj", (d, bc), dtype, ("normal", d ** -0.5)),
            (p + "mamba.dt_proj", (d, H), dtype, ("normal", d ** -0.5)),
            (p + "mamba.conv_x_w", (K, di), dtype, ("normal", 1.0 / K)),
            (p + "mamba.conv_x_b", (di,), dtype, ("normal", 0.1)),
            (p + "mamba.conv_bc_w", (K, bc), dtype, ("normal", 1.0 / K)),
            (p + "mamba.conv_bc_b", (bc,), dtype, ("normal", 0.1)),
            (p + "mamba.A_log", (H,), f32, ("a_log",)),
            (p + "mamba.D", (H,), f32, ("ones",)),
            (p + "mamba.dt_bias", (H,), f32, ("dt_bias",)),
            (p + "mamba.norm_scale", (di,), f32, ("norm",)),
            (p + "mamba.out_proj", (di, d), dtype, ("normal", di ** -0.5))]
    E, f, fs = m["n_experts"], m["moe_d_ff"], m["shared_expert_ff"]
    return out + [
        (p + "moe.router", (d, E), f32, ("normal", d ** -0.5)),
        (p + "moe.e_score_correction_bias", (E,), f32,
         ("normal", BIAS_SCALE)),
        (p + "moe.w_up", (E, d, f), dtype, ("normal", d ** -0.5)),
        (p + "moe.w_down", (E, f, d), dtype, ("normal", f ** -0.5)),
        (p + "moe.shared.w_up", (d, fs), dtype, ("normal", d ** -0.5)),
        (p + "moe.shared.w_down", (fs, d), dtype, ("normal", fs ** -0.5))]


# --- the plain reference ---------------------------------------------------


def relu2(x, w_up, w_down, ar: Arith):
    return ar.mm(F.relu(ar.mm(x, w_up)).square(), w_down)


def mamba(x, w, m, ar: Arith):
    """The grouped Mamba-2 mixer over x (B, L, d)."""
    B, L, _ = x.shape
    G, N, P, H = (m["ssm_groups"], m["ssm_state"], m["ssm_head_dim"],
                  m["ssm_n_heads"])
    di, hpg = _d_inner(m), H // G
    z = ar.mm(x, w["mamba.z_proj"])
    xs = lm.causal_conv(ar.mm(x, w["mamba.x_proj"]), w["mamba.conv_x_w"],
                        w["mamba.conv_x_b"]).view(B, L, H, P)
    bc = lm.causal_conv(ar.mm(x, w["mamba.bc_proj"]), w["mamba.conv_bc_w"],
                        w["mamba.conv_bc_b"])
    Bm, Cm = bc[..., :G * N].view(B, L, G, N), bc[..., G * N:].view(B, L, G, N)
    dt = F.softplus(ar.mm(x, w["mamba.dt_proj"]) + w["mamba.dt_bias"])
    A = -torch.exp(w["mamba.A_log"])
    ys = []
    for g in range(G):  # the heads that read group g's B and C
        h = slice(g * hpg, (g + 1) * hpg)
        ys.append(lm.ssd(xs[:, :, h], dt[..., h], A[h], Bm[:, :, g],
                         Cm[:, :, g]))
    y = torch.cat(ys, dim=2)
    y = y + xs * w["mamba.D"][:, None]
    v = (y.reshape(B, L, di) * F.silu(z)).view(B, L, G, di // G)
    y = lm.rmsnorm(v, w["mamba.norm_scale"].view(G, di // G), m["norm_eps"])
    return ar.mm(y.reshape(B, L, di), w["mamba.out_proj"])


def attention(x, w, m, S, cache_dtype, ar: Arith):
    """``reference.lm``'s GQA attention with the rotation off."""
    return lm.attention(x, w, dict(m, rope_theta=0.0), S, cache_dtype, ar)


def route(x, w, m):
    """(gates (T, k), expert ids (T, k)) of tokens x (T, d)."""
    s = torch.sigmoid(x @ w["moe.router"])
    ids = torch.topk(s + w["moe.e_score_correction_bias"],
                     m["experts_per_token"], dim=-1).indices
    gates = s.gather(-1, ids)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * m["moe_routed_scale"], ids


def kept(ids: torch.Tensor, E: int, Sg: int, C: int) -> torch.Tensor:
    """(T, k) whether each (token, choice) fits its expert's capacity C in
    its group of Sg consecutive tokens, in token order then choice order."""
    T, k = ids.shape
    flat = ids.reshape(T // Sg, Sg * k)
    onehot = F.one_hot(flat, E)
    rank = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    return (rank < C).view(T, k)


def moe_tokens(x, w, m, Sg: int, C: int, ar: Arith):
    """Routed relu^2 experts over x (T, d) in groups of Sg tokens, capacity
    C, plus the shared expert."""
    T, _ = x.shape
    E, k = m["n_experts"], m["experts_per_token"]
    gates, ids = route(x, w, m)
    keep = kept(ids, E, Sg, C)
    out = torch.zeros_like(x)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, k)
    for e in range(E):
        sel = (ids == e) & keep
        if not bool(sel.any()):
            continue
        rows = tok[sel]
        y = relu2(x[rows], w["moe.w_up"][e], w["moe.w_down"][e], ar)
        out.index_add_(0, rows, y * gates[sel][:, None])
    return out + relu2(x, w["moe.shared.w_up"], w["moe.shared.w_down"], ar)


def moe(x, w, m, S, ar: Arith):
    """The prompt (B, S) is one block; every later position is a block of
    B tokens, all of them routed in one pass (position-major, groups
    within each position)."""
    B, L, d = x.shape
    out = torch.empty_like(x)
    Sg, C = lm.capacity_group(m, B * S)
    out[:, :S] = moe_tokens(x[:, :S].reshape(B * S, d), w, m, Sg, C,
                            ar).view(B, S, d)
    if L > S:
        Sg, C = lm.capacity_group(m, B)
        tail = x[:, S:].transpose(0, 1).reshape((L - S) * B, d)
        y = moe_tokens(tail, w, m, Sg, C, ar)
        out[:, S:] = y.view(L - S, B, d).transpose(0, 1)
    return out


def layer(x, w, m, i, S, cache_dtype, ar: Arith):
    """Block i over x (B, L, d); the first S positions are the prompt."""
    h = lm.rmsnorm(x, w["norm1.scale"], m["norm_eps"])
    kind = m["layer_pattern"][i]
    if kind == "M":
        return x + mamba(h, w, m, ar)
    if kind == "*":
        return x + attention(h, w, m, S, cache_dtype, ar)
    return x + moe(h, w, m, S, ar)


def served_logits(cfg: dict, seed_weights: Callable[[str], dict],
                  batches: list[tuple[torch.Tensor, int]],
                  precision: str = "float32") -> list[torch.Tensor]:
    """``reference.lm.served_logits`` over this family's blocks."""
    return lm.served_logits(cfg, groups(cfg["model"]), layer, seed_weights,
                            batches, precision)


def loss_fn(cfg: dict, p: dict, tokens: torch.Tensor, labels: torch.Tensor,
            ar: Arith) -> torch.Tensor:
    return lm.loss(cfg, layer, p, tokens, labels, ar)


# --- kernel calls ------------------------------------------------------------


def ssd_call(B, S, H, G, P, N, L, elt) -> tuple[float, float]:
    """``roofline.counts.ssd_call`` with B and C in G groups: C.B^T once a
    group, the rest a head; B and C read once a group."""
    per_head = per_group = 0
    for c0 in range(0, S, L):
        Lc = min(L, S - c0)
        pairs = Lc * (Lc + 1) // 2
        per_head += pairs * 2 * P + 2 * Lc * P * N
        per_group += pairs * 2 * N
        if c0 > 0:
            per_head += 2 * Lc * P * N
    flops = B * min(H * per_head + G * per_group, H * 5 * S * P * N)
    nbytes = (2 * B * S * H * P * elt + 2 * B * S * G * N * elt
              + 4 * B * S * H + 8 * H + 4 * B * H * P * N)
    return float(flops), float(nbytes)


def layer_calls(cfg: dict, B: int, S: int, phase: str) -> dict:
    """{kernel: [(flops, bytes) per call]} of one prefill of (B, S) or one
    decode step of B tokens, over every block."""
    m = cfg["model"]
    elt = counts.ELT[cfg["dtype"]]
    calls: dict = {"flash": [], "ssd": [], "gmm": []}
    d = m["d_model"]
    for kind in m["layer_pattern"]:
        if kind == "*" and phase == "prefill":
            calls["flash"].append(counts.flash_call(
                B, S, m["n_heads"], m["n_kv_heads"], m["head_dim"], None,
                elt))
        if kind == "M" and phase == "prefill":
            calls["ssd"].append(ssd_call(
                B, S, m["ssm_n_heads"], m["ssm_groups"], m["ssm_head_dim"],
                m["ssm_state"], m["ssm_chunk"], elt))
        if kind == "E":
            T = B * S if phase == "prefill" else B
            G, C = counts.moe_capacity(m, T)
            E, f = m["n_experts"], m["moe_d_ff"]
            calls["gmm"] += [counts.gmm_call(E, G * C, d, f, elt),
                             counts.gmm_call(E, G * C, f, d, elt)]
    return calls


# --- model FLOPs -------------------------------------------------------------


def _layer_flops(m: dict, kind: str, T: int, pairs: int) -> float:
    """One block over T tokens whose attention covers ``pairs`` (query,
    key) pairs (already summed over the batch)."""
    d = m["d_model"]
    if kind == "*":
        H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        return 2.0 * T * d * (2 * H * D + 2 * Hkv * D) + 4.0 * H * D * pairs
    if kind == "M":
        di, N, P, H = (_d_inner(m), m["ssm_state"], m["ssm_head_dim"],
                       m["ssm_n_heads"])
        bc = 2 * m["ssm_groups"] * N
        return (2.0 * T * d * (2 * di + bc + H) + 2.0 * T * di * d
                + 2.0 * T * (di + bc) * m["ssm_conv"] + 5.0 * T * H * P * N)
    return (2.0 * T * d * m["n_experts"]
            + 4.0 * T * m["experts_per_token"] * d * m["moe_d_ff"]
            + 4.0 * T * d * m["shared_expert_ff"])


def _stack_flops(m: dict, T: int, pairs: int) -> float:
    return sum(_layer_flops(m, kind, T, pairs) for kind in m["layer_pattern"])


def prefill_flops(cfg: dict, B: int, S: int) -> float:
    """A prefill of B prompts of S tokens, logits at the last position."""
    m = cfg["model"]
    pairs = B * counts.causal_pairs(S, None)
    return _stack_flops(m, B * S, pairs) + 2.0 * B * m["d_model"] * \
        m["vocab_size"]


def decode_flops(cfg: dict, B: int, ctx: int) -> float:
    """One decode step of B sequences whose new token sits at position
    ``ctx`` (it attends over ctx + 1 keys)."""
    m = cfg["model"]
    return _stack_flops(m, B, B * (ctx + 1)) + 2.0 * B * m["d_model"] * \
        m["vocab_size"]


def train_flops(cfg: dict, B: int, S: int) -> float:
    """A training step on (B, S): forward with logits at every position,
    and the backward at twice the forward."""
    m = cfg["model"]
    pairs = B * counts.causal_pairs(S, None)
    fwd = _stack_flops(m, B * S, pairs) + 2.0 * B * S * m["d_model"] * \
        m["vocab_size"]
    return 3.0 * fwd
