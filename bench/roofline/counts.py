"""Operations and bytes, from a configuration's sizes and a call's shapes.

Kernels (``*_call``): the least a call has to do, as ``chip_smoke.py``
counts it: every input byte read once, every output byte written once;
operations as the call's contract defines them (the grouped matmul
multiplies every capacity slot it is given; attention's causal pairs;
the SSD scan the fewer of its chunked and token-recurrent forms).

Model phases (``*_flops``): model FLOPs, the least work that gives the
phase's outputs: 2 per multiply-add of every matrix product with the
weights, attention over the causal (windowed) pairs, the SSD recurrence at
5 P N a token and head, MoE experts for the top-k choices of every token
(no capacity padding), the LM head only where logits are used; no remat
recompute. Elementwise work is not counted.
"""

from __future__ import annotations

from bench.harness.weights import layer_kind
from bench.reference.lm import capacity_group

ELT = {"float32": 4, "bfloat16": 2}


# --- kernels -------------------------------------------------------------


def causal_pairs(S: int, window: int | None, q0: int = 0) -> int:
    """Visible (query, key) pairs of queries q0..S-1 over keys 0..S-1."""
    tot = 0
    for q in range(q0, S):
        tot += q + 1 if window is None else min(q + 1, window)
    return tot


def flash_call(B, S, H, Hkv, D, window, elt) -> tuple[float, float]:
    return (4.0 * B * H * D * causal_pairs(S, window),
            float((2 * B * S * H * D + 2 * B * S * Hkv * D) * elt))


def gmm_call(E, C, d, f, elt) -> tuple[float, float]:
    return 2.0 * E * C * d * f, float((E * C * d + E * d * f + E * C * f) * elt)


def ssd_call(B, S, H, P, N, L, elt) -> tuple[float, float]:
    chunked = 0
    for c0 in range(0, S, L):
        Lc = min(L, S - c0)
        chunked += Lc * (Lc + 1) // 2 * 2 * (N + P) + 2 * Lc * P * N
        if c0 > 0:
            chunked += 2 * Lc * P * N
    flops = B * H * min(chunked, 5 * S * P * N)
    nbytes = (2 * B * S * H * P * elt + 2 * B * S * N * elt
              + 4 * B * S * H + 8 * H + 4 * B * H * P * N)
    return float(flops), float(nbytes)


def moe_capacity(m: dict, tokens: int) -> tuple[int, int]:
    """(groups, capacity) of a block of tokens (the configuration's rule,
    as the reference applies it)."""
    Sg, cap = capacity_group(m, tokens)
    return tokens // Sg, cap


def layer_calls(cfg: dict, B: int, S: int, phase: str) -> dict:
    """{kernel: [(flops, bytes) per call]} of one prefill of (B, S) or one
    decode step of B tokens, over every layer."""
    m = cfg["model"]
    elt = ELT[cfg["dtype"]]
    calls: dict = {"flash": [], "ssd": [], "gmm": []}
    d = m["d_model"]
    for i in range(m["n_layers"]):
        mixer, ff = layer_kind(m, i)
        if mixer == "attn" and phase == "prefill":
            calls["flash"].append(flash_call(
                B, S, m["n_heads"], m["n_kv_heads"], m["head_dim"],
                m.get("sliding_window"), elt))
        if mixer == "mamba" and phase == "prefill":
            di = m["ssm_expand"] * d
            calls["ssd"].append(ssd_call(
                B, S, di // m["ssm_head_dim"], m["ssm_head_dim"],
                m["ssm_state"], m["ssm_chunk"], elt))
        if ff == "moe":
            T = B * S if phase == "prefill" else B
            G, C = moe_capacity(m, T)
            E, f = m["n_experts"], m["d_ff"]
            calls["gmm"] += [gmm_call(E, G * C, d, f, elt)] * 2
            calls["gmm"].append(gmm_call(E, G * C, f, d, elt))
    return calls


# --- model FLOPs -----------------------------------------------------------


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
    pairs = B * causal_pairs(S, m.get("sliding_window"))
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
    pairs = B * causal_pairs(S, m.get("sliding_window"))
    fwd = sum(_layer_flops(m, i, B * S, pairs) for i in range(m["n_layers"]))
    fwd += 2.0 * B * S * m["d_model"] * m["vocab_size"]
    return 3.0 * fwd
