"""Architecture registry: ``--arch <id>`` -> exact published config.

A copy of the reference registry (``src/repro/configs``); its
``specs.py`` helpers build meta tensors through the port's model. Beside
the copy, ``_PORT_ONLY`` holds the architectures only the port runs
(``PatternConfig``s, ``configs.pattern``).
"""

from repro_torch.configs.base import (
    Family,
    ModelConfig,
    SHAPES,
    ShapeConfig,
    ShapeKind,
    supports_decode,
    supports_long_context,
)
from repro_torch.configs.pattern import PatternConfig
from repro_torch.configs import (
    deepseek_7b,
    granite_34b,
    h2o_danube_1_8b,
    jamba_v0_1_52b,
    mamba2_780m,
    moonshot_v1_16b_a3b,
    nemotron_3_nano_30b_a3b,
    qwen2_72b,
    qwen2_vl_7b,
    qwen3_moe_30b_a3b,
    whisper_base,
)

_MODULES = {
    "mamba2-780m": mamba2_780m,
    "deepseek-7b": deepseek_7b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "qwen2-72b": qwen2_72b,
    "granite-34b": granite_34b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "whisper-base": whisper_base,
}

#: architectures only the port runs (``configs.pattern``): ``get_config``
#: finds them, ``ARCH_IDS`` (the reference's registry) does not list them
_PORT_ONLY = {
    "nemotron-3-nano-30b-a3b": nemotron_3_nano_30b_a3b,
}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)
SHAPE_IDS: tuple[str, ...] = tuple(SHAPES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES.get(arch) or _PORT_ONLY.get(arch)
    if mod is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{list(_MODULES) + list(_PORT_ONLY)}")
    return mod.SMOKE if smoke else mod.FULL


def get_shape(shape: str) -> ShapeConfig:
    if shape not in SHAPES:
        raise KeyError(f"unknown shape {shape!r}; known: {list(SHAPES)}")
    return SHAPES[shape]


def all_cells() -> list[tuple[str, str]]:
    """All 40 (arch x shape) cells of the assignment."""
    return [(a, s) for a in ARCH_IDS for s in SHAPE_IDS]


from repro_torch.configs.specs import (  # noqa: E402  (imports the models lazily)
    batch_specs,
    cell_supported,
    decode_specs,
    max_positions_for,
    meta_model,
    param_specs,
)

__all__ = [k for k in dir() if not k.startswith("_")]
