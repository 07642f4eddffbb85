"""Batched serving engine: prefill + decode (port of
``src/repro/serve/engine.py``).

The router decides *where* a request runs, the engine *how*: ``prefill``
materialises the per-layer decode state (ring KV caches, SSM states) and
``serve_step`` decodes one token for the whole batch. On CUDA the model
always runs through the hand-written kernels (flash attention and the SSD
scan in prefill, the grouped matmul in every MoE FF, RMSNorm everywhere);
there is no switch to the plain versions.

On CUDA a decode step is one replay of a captured CUDA graph. A step's
shapes do not depend on how far decoding has come (the ring holds
``min(max_seq, window)`` slots, the SSM state is fixed, the position is a
device tensor), so the engine captures once per layout of the state it is
given, the batch size and every tensor's shape and dtype, and replays that
capture for every later step of that layout. The graph reads and writes
static copies of the state's tensors that the engine owns; a state whose
tensors are not those (the first step after a prefill) is copied in, and
the state returned lives in them, so it holds until the engine next takes
another state of the same layout. A step on the CPU or on ``meta`` tensors
runs eagerly. ``STEPS`` counts captures, replays and eager steps; a replay
adds the captured step's kernel launches to ``kernels.ops.LAUNCHES``, so
the counters read as for eager steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import LAUNCHES
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import SSMState
from repro_torch.models.transformer import DecodeState, Transformer

#: decode steps by how they ran: a capture (the step runs eagerly, then
#: is captured), a replay of a capture, or an eager step (CPU, meta)
STEPS: dict[str, int] = {"captures": 0, "replays": 0, "eager_steps": 0}


def _leaves(state: DecodeState) -> list[torch.Tensor]:
    """Every tensor of ``state`` in a fixed order: each layer's cache (none
    for a layer without one), then each layer's cross K/V."""
    out = []
    for c in state.caches:
        out += [c.k, c.v] if isinstance(c, KVCache) else \
            [c.conv_x, c.conv_bc, c.ssm] if isinstance(c, SSMState) else []
    for kv in state.cross_kv:
        out += [] if kv is None else list(kv)
    return out


def _over(state: DecodeState, leaves: list[torch.Tensor],
          advance: int) -> DecodeState:
    """``state`` holding ``leaves`` (in ``_leaves``'s order), ``advance``
    steps on."""
    it = iter(leaves)
    caches = [KVCache(k=next(it), v=next(it), length=c.length + advance)
              if isinstance(c, KVCache)
              else SSMState(conv_x=next(it), conv_bc=next(it), ssm=next(it))
              if isinstance(c, SSMState) else None
              for c in state.caches]
    cross = [None if kv is None else (next(it), next(it))
             for kv in state.cross_kv]
    return DecodeState(caches=caches, step=state.step + advance,
                       cross_kv=cross)


def _layout(state: DecodeState, tokens: torch.Tensor) -> tuple:
    """What a captured step is keyed by: the batch, each cache's kind (or
    none) and which layers have cross K/V, and every tensor's shape, dtype
    and device."""
    return (tuple(tokens.shape), tuple(type(c) for c in state.caches),
            tuple(kv is None for kv in state.cross_kv),
            tuple((t.shape, t.dtype, t.device) for t in _leaves(state)))


@dataclasses.dataclass
class _StepGraph:
    """A captured decode step and the static tensors it reads and writes:
    the state's, the (B, 1) tokens and positions, the (B, 1, V) logits."""

    graph: torch.cuda.CUDAGraph
    leaves: list[torch.Tensor]
    tokens: torch.Tensor
    positions: torch.Tensor
    logits: torch.Tensor
    #: kernel launches of one step, by wrapper
    launches: dict[str, int]


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
    #: captured decode steps by ``_layout``
    _graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False)

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
        """One decode step. tokens (B, 1) -> (logits (B, V), new state).
        On CUDA a replay of the step captured for the state's layout (see
        the module docstring), else the model's eager step."""
        with obs.span("decode"):
            leaves = _leaves(state)
            if not (tokens.is_cuda and all(t.is_cuda for t in leaves)):
                STEPS["eager_steps"] += 1
                logits, state = self.model.decode_step(state, tokens)
                return logits[:, 0], state
            key = _layout(state, tokens)
            g = self._graphs.get(key)
            if g is None:
                logits, self._graphs[key] = self._capture(state, tokens)
                STEPS["captures"] += 1
                return logits, _over(state, self._graphs[key].leaves, 1)
            for dst, src in zip(g.leaves, leaves):
                if dst is not src:
                    dst.copy_(src)
            g.tokens.copy_(tokens)
            g.positions.fill_(state.step)
            g.graph.replay()
            for name, n in g.launches.items():
                LAUNCHES[name] += n
            STEPS["replays"] += 1
            return g.logits[:, 0].clone(), _over(state, g.leaves, 1)

    def _capture(self, state: DecodeState, tokens: torch.Tensor
                 ) -> tuple[torch.Tensor, _StepGraph]:
        """The first step of a layout: the step runs eagerly on a side
        stream over static copies of the state (the warm-up a capture
        needs, and this call's own step: its logits are returned), then
        the same step is captured. The capture ends by copying the new
        SSM states into the static ones; KV caches are written in place.
        The eager step's kernel launches count; the capture's are taken
        back out of ``LAUNCHES`` and kept, for each replay to add."""
        leaves = [t.clone() for t in _leaves(state)]
        tok = tokens.clone()
        pos = torch.full((tokens.shape[0], 1), state.step, dtype=torch.int32,
                         device=tokens.device)
        inner = _over(state, leaves, 0)

        def step() -> torch.Tensor:
            logits, new = self.model.decode_step(inner, tok, positions=pos)
            for dst, src in zip(leaves, _leaves(new)):
                if dst is not src:
                    dst.copy_(src)
            return logits

        main = torch.cuda.current_stream(tokens.device)
        side = torch.cuda.Stream(tokens.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = step()[:, 0]
        main.wait_stream(side)
        first.record_stream(main)
        graph = torch.cuda.CUDAGraph()
        counted = dict(LAUNCHES)
        with torch.cuda.graph(graph):
            logits = step()
        launches = {k: LAUNCHES[k] - counted[k] for k in LAUNCHES}
        LAUNCHES.update(counted)
        return first, _StepGraph(graph, leaves, tok, pos, logits, launches)

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
