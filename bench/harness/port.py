"""The program under test, built from a configuration file: the port's
own config with the file's cuts applied, checked against every size the
file states, and its model filled with the seed's weights from the
configuration's family's weight list."""

from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from bench.harness import weights


def port_config(cfg: dict):
    """``repro_torch``'s ModelConfig of ``cfg["arch"]`` (its smoke variant
    where ``cfg["smoke"]``, for tests) with ``cfg["reduced"]`` (the cuts
    from the source) and ``cfg["published"]`` (keys where the port's own
    config departs from the source, set back to the source's value)
    applied, each as ``{key: [was, runs]}``; raises where a stated size
    differs."""
    from repro_torch.configs import get_config

    pc = get_config(cfg["arch"], smoke=bool(cfg.get("smoke", False)))
    pc = dataclasses.replace(pc, **{
        k: v[1] for k, v in {**cfg.get("published", {}),
                             **cfg["reduced"]}.items()})
    for key, want in cfg["model"].items():
        got = getattr(pc, key)
        got = got.value if hasattr(got, "value") else got
        if got != want:
            raise ValueError(f"{cfg['name']}: the port's {key} is {got!r}, "
                             f"the configuration states {want!r}")
    if pc.cache_dtype != cfg["cache_dtype"]:
        raise ValueError(f"{cfg['name']}: the port caches in "
                         f"{pc.cache_dtype}, the configuration states "
                         f"{cfg['cache_dtype']}")
    return pc


def set_precision(cfg: dict) -> None:
    """Run as the configuration states (TF32 on or off)."""
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])


def build_model(cfg: dict, family: ModuleType, seed: int, device):
    """(port config, ``Transformer`` on ``device`` holding the seed's
    weights, drawn by ``family``'s list); no weight is drawn by the
    program."""
    from repro_torch.models import Transformer

    pc = port_config(cfg)
    dtype = getattr(torch, cfg["dtype"])
    model = Transformer(pc, device="meta", dtype=dtype).to_empty(device=device)
    weights.fill(model, family, cfg["model"], dtype, seed)
    return pc, model


def draw_fn(cfg: dict, family: ModuleType, seed: int, device):
    """The reference's view of the weights: any group, drawn afresh."""
    dtype = getattr(torch, cfg["dtype"])
    return lambda group: weights.draw(family, cfg["model"], dtype, seed,
                                      group, device)
