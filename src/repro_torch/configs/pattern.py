"""Architectures the port runs that the reference registry does not hold.

``PatternConfig`` extends the copied ``ModelConfig`` (whose fields stay
the reference's) with what a layer-pattern hybrid such as Nemotron-H needs:
a layer of one kind each, spelled by ``layer_pattern`` (``M`` a Mamba-2
mixer, ``E`` an MoE FF, ``*`` an attention mixer, each ``x + f(norm(x))``);
Mamba-2 B/C in ``ssm_groups`` groups and d_inner set by ``ssm_n_heads``;
a sigmoid router with a score-correction bias; relu^2 experts and a shared
expert. Every model module reads these through ``option``, so a plain
``ModelConfig`` takes the defaults, which are what the copied configs
compute.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

#: a pattern letter -> (mixer, ff) of the layer
KINDS = {"M": ("mamba", None), "*": ("attn", None), "E": (None, "moe")}


@dataclasses.dataclass(frozen=True)
class PatternConfig(ModelConfig):
    #: one letter a layer: ``M`` Mamba-2, ``E`` MoE, ``*`` attention
    layer_pattern: str = ""
    #: B/C groups of the Mamba-2 mixer (heads share a group's B and C)
    ssm_groups: int = 1
    #: Mamba-2 heads; d_inner = heads x ssm_head_dim where set (else expand)
    ssm_n_heads: int = 0
    #: "softmax" (softmax top-k, renormalised) | "sigmoid_bias" (sigmoid
    #: scores, top-k of score + e_score_correction_bias, renormalised)
    moe_router: str = "softmax"
    #: factor on the renormalised gates (Nemotron-H's routed_scaling_factor)
    moe_routed_scale: float = 1.0
    #: expert FF: "swiglu" (gate, up, down) | "relu2" (down(relu(up x)^2))
    moe_act: str = "swiglu"
    #: width of the one shared relu^2 expert added to the routed output
    #: (0: none)
    shared_expert_ff: int = 0

    def __post_init__(self):
        super().__post_init__()
        if len(self.layer_pattern) != self.n_layers or set(
                self.layer_pattern) - set(KINDS):
            raise ValueError(f"{self.name}: layer_pattern must spell "
                             f"{self.n_layers} layers of {sorted(KINDS)}")
        if self.ssm_heads % self.ssm_groups:
            raise ValueError(f"{self.name}: {self.ssm_heads} SSM heads do "
                             f"not split into {self.ssm_groups} groups")
        if self.moe_router not in ("softmax", "sigmoid_bias"):
            raise ValueError(f"unknown moe_router {self.moe_router!r}")
        if self.moe_act not in ("swiglu", "relu2"):
            raise ValueError(f"unknown moe_act {self.moe_act!r}")

    @property
    def d_inner(self) -> int:
        if self.ssm_n_heads:
            return self.ssm_n_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    def is_attn_layer(self, i: int) -> bool:
        return self.layer_pattern[i] == "*"

    def is_moe_layer(self, i: int) -> bool:
        return self.layer_pattern[i] == "E"

    def _ssm_params(self) -> int:
        d, di, h = self.d_model, self.d_inner, self.ssm_heads
        bc = 2 * self.ssm_groups * self.ssm_state
        return (d * (2 * di + bc + h) + (di + bc) * (self.ssm_conv + 1)
                + 3 * h + di + di * d)

    def _expert_params(self) -> int:
        mats = 2 if self.moe_act == "relu2" else 3
        return mats * self.d_model * self.expert_ff

    def _moe_ff_params(self) -> int:
        e = self.n_experts
        bias = e if self.moe_router == "sigmoid_bias" else 0
        return (self.d_model * e + bias + e * self._expert_params()
                + 2 * self.d_model * self.shared_expert_ff)

    def _layer_params(self, i: int) -> int:
        kind = self.layer_pattern[i]
        return self.d_model + (self._ssm_params() if kind == "M" else
                               self._attn_params() if kind == "*" else
                               self._moe_ff_params())

    def active_param_count(self) -> int:
        """Parameters touched per token: the top-k routed experts, the
        router and the shared expert of each MoE layer."""
        idle = (self.n_experts - self.experts_per_token) * \
            self._expert_params()
        return self.param_count() - idle * self.layer_pattern.count("E")


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(PatternConfig)
             if f.name not in {g.name for g in dataclasses.fields(ModelConfig)}}


def option(cfg: ModelConfig, name: str):
    """``cfg``'s value of a ``PatternConfig`` field, its default for a
    plain ``ModelConfig``."""
    return getattr(cfg, name, _DEFAULTS[name])
