"""Deterministic synthetic LM data pipeline (port of
``src/repro/data/pipeline.py``).

A seeded order-1 Markov language with Zipfian marginals, shard-aware:
each data-parallel rank makes exactly its own slice of the global batch
from (seed, step, shard). The draws go through ``threefry``, the numpy
copy of ``jax.random``, so tokens and labels are the reference's bit for
bit; the stub-frontend gaussians (qwen2-vl's ``patch_embeds``, whisper's
``encoder_frames``) land within a few ulp of the reference's (numpy's
``log1p`` in the inverse error function is not XLA's). Batches are made
on the host and moved to the ``device`` given.

``u ** 3`` is computed as the reference's XLA CPU program computes it,
by the C library's ``powf``: that is correctly rounded but for one value
in a few thousand, where it is one ulp off, and one ulp can move
``vocab * u ** 3`` across an integer. So the cube is taken correctly
rounded (through float64) and ``powf`` is asked only where a neighbouring
float32 would truncate to another token id.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import Family, ModelConfig, ShapeConfig
from repro_torch.data import threefry


@functools.cache
def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return libm.powf


def zipf_ids(u: np.ndarray, vocab: int) -> np.ndarray:
    """``clip(int32(vocab * u ** 3.0), 0, vocab - 1)`` for float32 u, as
    the reference computes it."""
    f32 = np.float32
    cube = (u.astype(np.float64) ** 3).astype(f32)
    ids = (f32(vocab) * cube).astype(np.int32)
    near = ((f32(vocab) * np.nextafter(cube, f32(0))).astype(np.int32) != ids
            ) | ((f32(vocab) * np.nextafter(cube, f32(2))).astype(np.int32)
                 != ids)
    if near.any():
        powf = _powf()
        exact = np.array([powf(float(x), 3.0) for x in u[near]], f32)
        ids[near] = (f32(vocab) * exact).astype(np.int32)
    return np.clip(ids, 0, vocab - 1)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Order-1 Markov language with Zipf marginals over ``vocab`` tokens."""

    vocab: int
    seed: int = 0
    branching: int = 16  # successors per token (lower = more learnable)

    def _keys(self, step: int, shard: int) -> np.ndarray:
        base = threefry.prng_key(self.seed)
        return threefry.fold_in(threefry.fold_in(base, step), shard)

    @functools.cached_property
    def _successors(self) -> np.ndarray:
        key = threefry.fold_in(threefry.prng_key(self.seed), 0xC0FFEE)
        u = threefry.uniform(key, (self.vocab, self.branching))
        return zipf_ids(u, self.vocab)

    def transition_successors(self) -> np.ndarray:
        """(vocab, branching) int32 successor table: the language (made
        once per instance)."""
        return self._successors

    def sample_tokens(self, step: int, shard: int, batch: int,
                      seq_len: int) -> np.ndarray:
        """(batch, seq_len) int32 token ids for one rank's slice."""
        succ = self._successors
        k0, kc = threefry.split(self._keys(step, shard))
        start = zipf_ids(threefry.uniform(k0, (batch,)), self.vocab)
        choices = threefry.randint(kc, (batch, seq_len - 1), 0,
                                   self.branching)
        tokens = np.empty((batch, seq_len), np.int32)
        tokens[:, 0] = start
        for t in range(seq_len - 1):
            tokens[:, t + 1] = succ[tokens[:, t], choices[:, t]]
        return tokens


def batch_for(cfg: ModelConfig, shape: ShapeConfig, *, step: int,
              shard: int = 0, n_shards: int = 1,
              lang: SyntheticLM | None = None,
              dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cpu") -> dict:
    """One rank's training batch for (cfg, shape) at ``step``, as tensors
    on ``device``: ``tokens`` and ``labels`` (B, S) int64 (next token,
    the last label wrapping to the first token), ``positions`` (3, B, S)
    under M-RoPE, and the stub-frontend gaussians x 0.02 in ``dtype``."""
    lang = lang or SyntheticLM(vocab=cfg.vocab_size)
    if shape.global_batch % n_shards:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {n_shards} shards")
    local_b = shape.global_batch // n_shards
    S = shape.seq_len
    tokens = lang.sample_tokens(step, shard, local_b, S)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()}

    key = threefry.fold_in(threefry.prng_key(lang.seed + 1),
                           step * 1000 + shard)
    if cfg.mrope:
        batch["positions"] = torch.arange(S).expand(3, local_b, S)
    if cfg.family == Family.VLM and cfg.vision_patches:
        P = min(cfg.vision_patches, S)
        batch["patch_embeds"] = _stub(key, (local_b, P, cfg.d_model), dtype)
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = _stub(
            key, (local_b, cfg.encoder_seq, cfg.d_model), dtype)
    return {k: v.to(device) for k, v in batch.items()}


def _stub(key: np.ndarray, shape: tuple[int, ...],
          dtype: torch.dtype) -> torch.Tensor:
    x = threefry.normal(key, shape) * np.float32(0.02)
    return torch.from_numpy(x).to(dtype)
