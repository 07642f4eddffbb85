"""The comparison that decides a served cell's ``correct``.

A greedy server emits, at each position, the token its logits put first.
The reference's logits at the same positions (same prompt, same earlier
served tokens) say how good that choice was: the gap by which the served
token's logit lies below the reference's best. Rounding flips near-ties,
so the gap is not zero, but it stays within the rounding of the stated
precision; a lower precision, or a fault, shows as a wider gap.
"""

from __future__ import annotations

import torch


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """ref (B, n, V), tokens (B, n) -> (B, n) best minus the token's logit."""
    ref = ref_logits.float()
    picked = ref.gather(-1, tokens.to(ref.device).long()[..., None])[..., 0]
    return ref.max(-1).values - picked


def gaps(refs: list[torch.Tensor], tokens: list[torch.Tensor]
         ) -> torch.Tensor:
    """Every judged token's gap, flat, in float64 on the host."""
    return torch.cat([token_gaps(r, t).flatten() for r, t in zip(refs, tokens)]
                     ).double().cpu()


def numbers_of(g: torch.Tensor) -> dict:
    """The numbers a served cell may compare, over every judged token:
    ``served_token_gap``, the widest gap; ``served_token_gap_mean``, the
    mean gap (steadier where rounding flips discrete choices, such as an
    MoE router's, and the widest gap is set by one flip); and
    ``served_token_gap_sq_mean``, the mean squared gap, which a few wrong
    tokens (gaps of several logits) move far more than many rounding
    flips (gaps under one or two) do."""
    return {"served_token_gap": float(g.max()),
            "served_token_gap_mean": float(g.mean()),
            "served_token_gap_sq_mean": float((g * g).mean())}


def gap_numbers(refs: list[torch.Tensor], tokens: list[torch.Tensor]
                ) -> dict:
    """``numbers_of`` the served tokens' gaps, and how many were judged."""
    g = gaps(refs, tokens)
    return {**numbers_of(g), "judged_tokens": g.numel()}
