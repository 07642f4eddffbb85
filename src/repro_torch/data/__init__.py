"""Deterministic synthetic LM data pipeline (shard-aware)."""

from repro_torch.data.pipeline import SyntheticLM, batch_for
