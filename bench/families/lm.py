"""The ``lm`` family: dense GQA transformers (h2o-danube) and the Mamba-2 /
attention / MoE hybrid (jamba as the port configures it), as the
benchmark's contract of a family names them (``harness.cell.FAMILY``):

- ``groups``, ``group_specs``: the weight list, under the port's
  ``Transformer`` parameter names, in drawing order;
- ``served_logits``, ``loss_fn``: the plain float32 reference
  (``reference.lm``'s blocks, stacked by ``layer``);
- ``prefill_flops``, ``decode_flops``, ``train_flops``: model FLOPs, the
  least work that gives the phase's outputs: 2 per multiply-add of every
  matrix product with the weights, attention over the causal (windowed)
  pairs, the SSD recurrence at 5 P N a token and head, MoE experts for the
  top-k choices of every token (no capacity padding), the LM head only
  where logits are used; no remat recompute. Elementwise work is not
  counted;
- ``layer_calls``: the operations and bytes of every kernel call
  (``roofline.counts``).

This module imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable

import torch

from bench.reference import lm
from bench.reference.precision import Arith
from bench.roofline import counts


def layer_kind(m: dict, i: int) -> tuple[str, str | None]:
    """(mixer, ff) of layer i: mixer "attn" | "mamba", ff "dense" | "moe"."""
    if m["family"] == "dense":
        return "attn", "dense"
    period = m.get("attn_period", 0)
    mixer = ("attn" if period <= 0 or i % period == m["attn_offset"]
             else "mamba")
    moe = m.get("n_experts", 0) and i % m["moe_period"] == m["moe_offset"]
    return mixer, ("moe" if moe else "dense")


# --- weights ---------------------------------------------------------------


def groups(m: dict) -> list[str]:
    return ["embed"] + [f"layers.{i}" for i in range(m["n_layers"])] + ["head"]


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
    mixer, ff = layer_kind(m, i)
    out = [(p + "norm1.scale", (d,), f32, ("norm",))]
    if mixer == "attn":
        hd, H, Hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
        out += [(p + "attn.wq", (d, H * hd), dtype, ("normal", d ** -0.5)),
                (p + "attn.wk", (d, Hkv * hd), dtype, ("normal", d ** -0.5)),
                (p + "attn.wv", (d, Hkv * hd), dtype, ("normal", d ** -0.5)),
                (p + "attn.wo", (H * hd, d), dtype,
                 ("normal", (H * hd) ** -0.5))]
    else:
        di = m["ssm_expand"] * d
        N, K = m["ssm_state"], m["ssm_conv"]
        H = di // m["ssm_head_dim"]
        out += [(p + "mamba.z_proj", (d, di), dtype, ("normal", d ** -0.5)),
                (p + "mamba.x_proj", (d, di), dtype, ("normal", d ** -0.5)),
                (p + "mamba.bc_proj", (d, 2 * N), dtype, ("normal", d ** -0.5)),
                (p + "mamba.dt_proj", (d, H), dtype, ("normal", d ** -0.5)),
                (p + "mamba.conv_x_w", (K, di), dtype, ("normal", 1.0 / K)),
                (p + "mamba.conv_x_b", (di,), dtype, ("normal", 0.1)),
                (p + "mamba.conv_bc_w", (K, 2 * N), dtype, ("normal", 1.0 / K)),
                (p + "mamba.conv_bc_b", (2 * N,), dtype, ("normal", 0.1)),
                (p + "mamba.A_log", (H,), f32, ("a_log",)),
                (p + "mamba.D", (H,), f32, ("ones",)),
                (p + "mamba.dt_bias", (H,), f32, ("dt_bias",)),
                (p + "mamba.norm_scale", (di,), f32, ("norm",)),
                (p + "mamba.out_proj", (di, d), dtype, ("normal", di ** -0.5))]
    out.append((p + "norm2.scale", (d,), f32, ("norm",)))
    f = m["d_ff"]
    if ff == "dense":
        out += [(p + "ff.w_gate", (d, f), dtype, ("normal", d ** -0.5)),
                (p + "ff.w_up", (d, f), dtype, ("normal", d ** -0.5)),
                (p + "ff.w_down", (f, d), dtype, ("normal", f ** -0.5))]
    else:
        E = m["n_experts"]
        out += [(p + "moe.router", (d, E), f32, ("normal", d ** -0.5)),
                (p + "moe.w_gate", (E, d, f), dtype, ("normal", d ** -0.5)),
                (p + "moe.w_up", (E, d, f), dtype, ("normal", d ** -0.5)),
                (p + "moe.w_down", (E, f, d), dtype, ("normal", f ** -0.5))]
    return out


# --- the plain reference ---------------------------------------------------


def layer(x, w, m, i, S, cache_dtype, ar: Arith):
    """Pre-norm layer i over x (B, L, d); the first S positions are the
    prompt (see ``reference.lm`` on the cache)."""
    mixer, ff = layer_kind(m, i)
    h = lm.rmsnorm(x, w["norm1.scale"], m["norm_eps"])
    x = x + (lm.attention(h, w, m, S, cache_dtype, ar) if mixer == "attn"
             else lm.mamba(h, w, m, ar))
    h = lm.rmsnorm(x, w["norm2.scale"], m["norm_eps"])
    return x + (lm.swiglu(h, w["ff.w_gate"], w["ff.w_up"], w["ff.w_down"],
                          ar)
                if ff == "dense" else lm.moe(h, w, m, S, ar))


def served_logits(cfg: dict, seed_weights: Callable[[str], dict],
                  batches: list[tuple[torch.Tensor, int]],
                  precision: str = "float32") -> list[torch.Tensor]:
    """``reference.lm.served_logits`` over this family's layers."""
    return lm.served_logits(cfg, groups(cfg["model"]), layer, seed_weights,
                            batches, precision)


def loss_fn(cfg: dict, p: dict, tokens: torch.Tensor, labels: torch.Tensor,
            ar: Arith) -> torch.Tensor:
    return lm.loss(cfg, layer, p, tokens, labels, ar)


# --- kernel calls ------------------------------------------------------------


def layer_calls(cfg: dict, B: int, S: int, phase: str) -> dict:
    """{kernel: [(flops, bytes) per call]} of one prefill of (B, S) or one
    decode step of B tokens, over every layer."""
    m = cfg["model"]
    elt = counts.ELT[cfg["dtype"]]
    calls: dict = {"flash": [], "ssd": [], "gmm": []}
    d = m["d_model"]
    for i in range(m["n_layers"]):
        mixer, ff = layer_kind(m, i)
        if mixer == "attn" and phase == "prefill":
            calls["flash"].append(counts.flash_call(
                B, S, m["n_heads"], m["n_kv_heads"], m["head_dim"],
                m.get("sliding_window"), elt))
        if mixer == "mamba" and phase == "prefill":
            di = m["ssm_expand"] * d
            calls["ssd"].append(counts.ssd_call(
                B, S, di // m["ssm_head_dim"], m["ssm_head_dim"],
                m["ssm_state"], m["ssm_chunk"], elt))
        if ff == "moe":
            T = B * S if phase == "prefill" else B
            G, C = counts.moe_capacity(m, T)
            E, f = m["n_experts"], m["d_ff"]
            calls["gmm"] += [counts.gmm_call(E, G * C, d, f, elt)] * 2
            calls["gmm"].append(counts.gmm_call(E, G * C, f, d, elt))
    return calls


# --- model FLOPs -------------------------------------------------------------


def _layer_flops(m: dict, i: int, T: int, pairs: int) -> float:
    """One layer over T tokens whose attention covers ``pairs``
    (query, key) pairs a sequence-batch (already summed over the batch)."""
    d = m["d_model"]
    mixer, ff = layer_kind(m, i)
    f = 0.0
    if mixer == "attn":
        H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        f += 2.0 * T * d * (2 * H * D + 2 * Hkv * D)
        f += 4.0 * H * D * pairs
    else:
        di, N, P = m["ssm_expand"] * d, m["ssm_state"], m["ssm_head_dim"]
        H = di // P
        f += 2.0 * T * d * (2 * di + 2 * N + H) + 2.0 * T * di * d
        f += 2.0 * T * (di + 2 * N) * m["ssm_conv"]
        f += 5.0 * T * H * P * N
    if ff == "dense":
        f += 6.0 * T * d * m["d_ff"]
    else:
        f += 2.0 * T * d * m["n_experts"]
        f += 6.0 * T * m["experts_per_token"] * d * m["d_ff"]
    return f


def prefill_flops(cfg: dict, B: int, S: int) -> float:
    """A prefill of B prompts of S tokens, logits at the last position."""
    m = cfg["model"]
    pairs = B * counts.causal_pairs(S, m.get("sliding_window"))
    f = sum(_layer_flops(m, i, B * S, pairs) for i in range(m["n_layers"]))
    return f + 2.0 * B * m["d_model"] * m["vocab_size"]


def decode_flops(cfg: dict, B: int, ctx: int) -> float:
    """One decode step of B sequences whose new token sits at position
    ``ctx`` (it attends over ctx + 1 keys, or the window)."""
    m = cfg["model"]
    win = m.get("sliding_window")
    keys = ctx + 1 if win is None else min(ctx + 1, win)
    f = sum(_layer_flops(m, i, B, B * keys) for i in range(m["n_layers"]))
    return f + 2.0 * B * m["d_model"] * m["vocab_size"]


def train_flops(cfg: dict, B: int, S: int) -> float:
    """A training step on (B, S): forward with logits at every position,
    and the backward at twice the forward."""
    m = cfg["model"]
    pairs = B * counts.causal_pairs(S, m.get("sliding_window"))
    fwd = sum(_layer_flops(m, i, B * S, pairs) for i in range(m["n_layers"]))
    fwd += 2.0 * B * S * m["d_model"] * m["vocab_size"]
    return 3.0 * fwd
