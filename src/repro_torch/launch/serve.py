"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Routes the batch's request with the ``GreenScaleRouter`` under the hour's
carbon intensities (the paper's Table-1 decision), then generates through
the ``ServeEngine``. Port of ``src/repro/launch/serve.py`` with two of its
defects fixed in this copy: ``--smoke/--no-smoke`` really selects the
config (default smoke), and the engine runs the kernels. Builds every
family; an encoder-decoder (``whisper-base``) gets stub ``encoder_frames``
(B, encoder_seq, d) x 0.02 from the seed and a position table of
prompt + new + 8, as the reference launcher makes them; ``qwen2-vl-7b``
runs text-only, as there. Params are ``--dtype`` (float32 by default;
``qwen3-moe-30b-a3b`` and ``qwen2-vl-7b`` take bfloat16 on one card) and
drawn from a generator seeded by ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    ChargingBehavior,
    Grid,
    grid_trace,
    mobile_carbon_intensity,
)
from repro_torch.core.carbon_model import Environment
from repro_torch.device import resolve_device
from repro_torch.models import Transformer
from repro_torch.serve import GreenScaleRouter, Request, RouteDecision, ServeEngine

TARGETS = ("on-device", "edge-DC", "hyperscale-DC")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_fits(cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> None:
    """Raise, with the sizes, when the weights alone exceed the card."""
    if device.type != "cuda":
        return
    need = cfg.param_count() * torch.empty((), dtype=dtype).element_size()
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise ValueError(
            f"{cfg.name}: {cfg.param_count() / 1e9:.2f} B parameters in "
            f"{str(dtype)[6:]} take {need / 1e9:.1f} GB, more than the "
            f"{have / 1e9:.1f} GB of {torch.cuda.get_device_name(device)}; "
            "try --dtype bfloat16")


def env_at_hour(hour: int, *,
                device: str | torch.device = "cuda") -> Environment:
    dev = resolve_device(device)
    ciso = grid_trace(Grid.CISO, device=dev)
    urban = grid_trace(Grid.URBAN, device=dev)
    ci_m = mobile_carbon_intensity(ChargingBehavior.AVERAGE, ciso)
    return Environment.make(
        ci_mobile=float(ci_m),
        ci_edge=float(urban.ci_hourly[hour % 24]),
        ci_core=float(ciso.ci_hourly.mean()),
        ci_hyper=float(ciso.ci_hourly[hour % 24]),
        device=dev,
    )


@dataclasses.dataclass
class ServeRun:
    """What one launcher run produced, for callers that check it."""

    cfg: ModelConfig
    decision: RouteDecision
    engine: ServeEngine
    prompt: torch.Tensor  # (batch, prompt_len)
    tokens: torch.Tensor  # (batch, new_tokens)
    extras: dict  # the stub frontend inputs given to the engine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--hour", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> ServeRun:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    dtype = DTYPES[args.dtype]
    check_fits(cfg, dtype, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    max_seq = args.prompt_len + args.new_tokens + 8
    model = Transformer(cfg, device=device, dtype=dtype, generator=gen,
                        max_positions=max_seq)

    # --- route the batch with GreenScale ------------------------------------
    router = GreenScaleRouter(get_config(args.arch), device=device)
    env = env_at_hour(args.hour, device=device)
    req = Request(prompt_tokens=args.prompt_len,
                  max_new_tokens=args.new_tokens)
    decision = router.route(req, env)
    print(f"[router] hour={args.hour} -> target: {TARGETS[decision.target]} "
          f"(carbon {decision.carbon_g:.3g} g, latency "
          f"{decision.latency_s * 1e3:.1f} ms, feasible={decision.feasible})")
    print(f"[router] per-target carbon (g): "
          f"{dict(zip(TARGETS, decision.per_target_carbon))}")

    # --- run the batch through the engine ------------------------------------
    engine = ServeEngine(cfg, model, max_seq=max_seq, device=device)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    extras = {}
    if cfg.is_encoder_decoder:
        extras["encoder_frames"] = torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=device).to(dtype) * 0.02
    out = engine.generate(prompt, max_new_tokens=args.new_tokens, **extras)
    print(f"[engine] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}; "
          f"generated {tuple(out.shape)} tokens; "
          f"first row: {out[0, :8].tolist()}...")
    return ServeRun(cfg=cfg, decision=decision, engine=engine, prompt=prompt,
                    tokens=out, extras=extras)


if __name__ == "__main__":
    main()
