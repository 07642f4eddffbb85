"""Operations and bytes of a kernel call, from its shapes: the least a
call has to do, as ``chip_smoke.py`` counts it: every input byte read
once, every output byte written once; operations as the call's contract
defines them (the grouped matmul multiplies every capacity slot it is
given; attention's causal pairs; the SSD scan the fewer of its chunked
and token-recurrent forms).

A family (``bench/families/``) builds its ``layer_calls`` (each kernel
call of a prefill or a decode step) and its model FLOPs
(``prefill_flops``, ``decode_flops``, ``train_flops``) on these; the
readers in ``harness/readers.py`` take them from the family.
"""

from __future__ import annotations

from bench.reference.lm import capacity_group

ELT = {"float32": 4, "bfloat16": 2}


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
