"""Batched serving engine: prefill + decode (port of
``src/repro/serve/engine.py``).

The router decides *where* a request runs, the engine *how*: ``prefill``
materialises the per-layer decode state (ring KV caches, SSM states) and
``serve_step`` decodes one token for the whole batch. On CUDA the model
always runs through the hand-written kernels (flash attention and the SSD
scan in prefill, the grouped matmul in every MoE FF, RMSNorm everywhere);
there is no switch to the plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DecodeState, Transformer


@dataclasses.dataclass
class ServeEngine:
    cfg: ModelConfig
    model: Transformer
    max_seq: int = 4096
    #: default sampling mode: greedy engines argmax, non-greedy engines
    #: sample at temperature 1.0. An explicit ``temperature=`` to
    #: ``generate`` always wins over this flag.
    greedy: bool = True
    #: execution tier this engine instance serves (Target enum value); None
    #: means the engine accepts everything.
    tier: int | None = None
    #: concurrent KV-cache slots this instance can hold (None = unbounded).
    kv_slots: int | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device)

    def admit(self, targets) -> torch.Tensor:
        """Boolean mask over a routed batch: the requests routed to this
        engine's tier (all of them when ``tier`` is None)."""
        t = torch.as_tensor(targets)
        if self.tier is None:
            return torch.ones(t.shape, dtype=torch.bool)
        return t == self.tier

    def admit_indices(self, targets) -> np.ndarray:
        """Host-side row indices of the admitted requests (stable order)."""
        return np.nonzero(self.admit(targets).cpu().numpy())[0]

    @property
    def kv_token_budget(self) -> float:
        """Total KV tokens this instance can hold (inf when unbounded)."""
        if self.kv_slots is None:
            return float("inf")
        return float(self.kv_slots) * float(self.max_seq)

    def kv_fit_rows(self, seq_lens: np.ndarray) -> int:
        """How many leading rows of ``seq_lens`` fit this engine's KV
        capacity: at most ``kv_slots`` requests AND at most
        ``kv_slots * max_seq`` tokens, each row clamped to ``max_seq``."""
        seq = np.minimum(np.asarray(seq_lens, np.float64), self.max_seq)
        if self.kv_slots is None:
            return len(seq)
        n_rows = min(len(seq), int(self.kv_slots))
        fits = np.cumsum(seq[:n_rows]) <= self.kv_token_budget
        return int(fits.sum())

    def prefill_batch(self, tokens: torch.Tensor, **extras
                      ) -> tuple[torch.Tensor, DecodeState]:
        """tokens (B, S) -> (last-position logits (B, V), decode state).
        ``extras``: the model's ``positions`` / ``patch_embeds`` /
        ``encoder_frames``, moved to the engine's device."""
        with obs.span("prefill"):
            extras = {k: v.to(self.device) for k, v in extras.items()}
            logits, state = self.model.prefill(tokens.to(self.device),
                                               max_seq=self.max_seq, **extras)
            return logits[:, -1], state

    def serve_step(self, state: DecodeState, tokens: torch.Tensor
                   ) -> tuple[torch.Tensor, DecodeState]:
        """One decode step. tokens (B, 1) -> (logits (B, V), new state)."""
        with obs.span("decode"):
            logits, state = self.model.decode_step(state, tokens)
            return logits[:, 0], state

    def generate(self, tokens: torch.Tensor, *, max_new_tokens: int,
                 generator: torch.Generator | None = None,
                 temperature: float | None = None,
                 **extras) -> torch.Tensor:
        """Greedy/temperature sampling. Returns (B, max_new_tokens) int64.
        ``extras`` go to ``prefill_batch``.

        ``temperature=None`` defers to the ``greedy`` flag. Sampling draws
        from ``generator`` (on the engine's device); without one it
        degrades to argmax, as the reference does without a key.
        """
        if temperature is None:
            temperature = 0.0 if self.greedy else 1.0
        logits, state = self.prefill_batch(tokens, **extras)
        outs = []
        tok = self._sample(logits, generator, temperature)
        for i in range(max_new_tokens):
            outs.append(tok)
            if i == max_new_tokens - 1:
                break
            logits, state = self.serve_step(state, tok)
            tok = self._sample(logits, generator, temperature)
        return torch.cat(outs, dim=1)

    @staticmethod
    def _sample(logits: torch.Tensor, generator: torch.Generator | None,
                temperature: float) -> torch.Tensor:
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1, keepdim=True)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
