"""Closed-loop static batches for a served cell, from the workload's
parameters.

``traffic``: ``batch`` (requests a batch, one prompt length a batch, as
``Transformer.prefill`` takes) and ``cycle``, a list of
``{"prompt": tokens, "new": tokens}``. Batches follow the list in the
file's order, cycle after cycle, so every run serves the same sequence of
shapes and a window of one length the same work; the seed draws only the
prompt token ids, uniform over the vocabulary, on the device from
``(seed, batch index)``.
"""

from __future__ import annotations

import dataclasses

import torch

from bench.harness.weights import group_seed


@dataclasses.dataclass(frozen=True)
class Batch:
    index: int
    prompt: int
    new: int
    tokens: torch.Tensor  # (batch, prompt) int64


class ServeTraffic:
    def __init__(self, traffic: dict, seed: int, vocab: int, device):
        if traffic.get("kind") != "closed_static_batches":
            raise ValueError(f"unknown traffic kind {traffic.get('kind')!r}")
        self.batch = int(traffic["batch"])
        self.cycle = [(int(c["prompt"]), int(c["new"]))
                      for c in traffic["cycle"]]
        self.seed, self.vocab, self.device = seed, vocab, device
        self._n = 0

    @property
    def shapes(self) -> list[tuple[int, int]]:
        """Distinct (prompt, new) of the cycle, in the file's order."""
        return list(dict.fromkeys(self.cycle))

    @property
    def max_len(self) -> int:
        return max(p + n for p, n in self.cycle)

    def tokens(self, index: int, prompt: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(group_seed(self.seed, f"prompt.{index}"))
        return torch.randint(0, self.vocab, (self.batch, prompt),
                             generator=g, device=self.device)

    def next(self) -> Batch:
        prompt, new = self.cycle[self._n % len(self.cycle)]
        b = Batch(self._n, prompt, new, self.tokens(self._n, prompt))
        self._n += 1
        return b
