"""The cell's weights, drawn from the seed on the device.

The benchmark makes the weights, not the program: one generator per group
(the embedding, the head, each layer), seeded from ``(seed, group)``, draws
the group's tensors in a fixed order, in float32, scaled, then cast to the
dtype they are served in. The program gets them under its own parameter
names (``fill``); the plain reference draws any group again on its own
(``draw``), so it reads nothing the program holds. The names follow the
port's ``Transformer`` because that is the interface the weights are handed
through; ``fill`` refuses a model whose parameters differ from this list.
"""

from __future__ import annotations

import hashlib
import math

import torch

# init kinds: ("normal", scale) N(0,1)*scale; ("norm",) 1 + 0.1 N(0,1);
# ("a_log",) log U(1, 16); ("dt_bias",) softplus^-1 of a log-uniform dt in
# [1e-3, 1e-1]; ("ones",) 1 + 0.1 N(0,1) for the SSM skip D


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def layer_kind(m: dict, i: int) -> tuple[str, str | None]:
    """(mixer, ff) of layer i: mixer "attn" | "mamba", ff "dense" | "moe"."""
    if m["family"] == "dense":
        return "attn", "dense"
    period = m.get("attn_period", 0)
    mixer = ("attn" if period <= 0 or i % period == m["attn_offset"]
             else "mamba")
    moe = m.get("n_experts", 0) and i % m["moe_period"] == m["moe_offset"]
    return mixer, ("moe" if moe else "dense")


def groups(m: dict) -> list[str]:
    return ["embed"] + [f"layers.{i}" for i in range(m["n_layers"])] + ["head"]


def group_specs(m: dict, dtype: torch.dtype, group: str) -> list[tuple]:
    """[(name, shape, dtype, init)] of one group, in drawing order."""
    f32 = torch.float32
    d, V = m["d_model"], m["vocab_size"]
    if group == "embed":
        return [("embed", (V, d), dtype, ("normal", 1.0))]
    if group == "head":
        return [("lm_head", (d, V), dtype, ("normal", d ** -0.5)),
                ("final_norm.scale", (d,), f32, ("norm",))]
    i = int(group.split(".")[1])
    p = f"layers.{i}."
    mixer, ff = layer_kind(m, i)
    out = [(p + "norm1.scale", (d,), f32, ("norm",))]
    if mixer == "attn":
        hd, H, Hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
        out += [(p + "attn.wq", (d, H * hd), dtype, ("normal", d ** -0.5)),
                (p + "attn.wk", (d, Hkv * hd), dtype, ("normal", d ** -0.5)),
                (p + "attn.wv", (d, Hkv * hd), dtype, ("normal", d ** -0.5)),
                (p + "attn.wo", (H * hd, d), dtype,
                 ("normal", (H * hd) ** -0.5))]
    else:
        di = m["ssm_expand"] * d
        N, K = m["ssm_state"], m["ssm_conv"]
        H = di // m["ssm_head_dim"]
        out += [(p + "mamba.z_proj", (d, di), dtype, ("normal", d ** -0.5)),
                (p + "mamba.x_proj", (d, di), dtype, ("normal", d ** -0.5)),
                (p + "mamba.bc_proj", (d, 2 * N), dtype, ("normal", d ** -0.5)),
                (p + "mamba.dt_proj", (d, H), dtype, ("normal", d ** -0.5)),
                (p + "mamba.conv_x_w", (K, di), dtype, ("normal", 1.0 / K)),
                (p + "mamba.conv_x_b", (di,), dtype, ("normal", 0.1)),
                (p + "mamba.conv_bc_w", (K, 2 * N), dtype, ("normal", 1.0 / K)),
                (p + "mamba.conv_bc_b", (2 * N,), dtype, ("normal", 0.1)),
                (p + "mamba.A_log", (H,), f32, ("a_log",)),
                (p + "mamba.D", (H,), f32, ("ones",)),
                (p + "mamba.dt_bias", (H,), f32, ("dt_bias",)),
                (p + "mamba.norm_scale", (di,), f32, ("norm",)),
                (p + "mamba.out_proj", (di, d), dtype, ("normal", di ** -0.5))]
    out.append((p + "norm2.scale", (d,), f32, ("norm",)))
    f = m["d_ff"]
    if ff == "dense":
        out += [(p + "ff.w_gate", (d, f), dtype, ("normal", d ** -0.5)),
                (p + "ff.w_up", (d, f), dtype, ("normal", d ** -0.5)),
                (p + "ff.w_down", (f, d), dtype, ("normal", f ** -0.5))]
    else:
        E = m["n_experts"]
        out += [(p + "moe.router", (d, E), f32, ("normal", d ** -0.5)),
                (p + "moe.w_gate", (E, d, f), dtype, ("normal", d ** -0.5)),
                (p + "moe.w_up", (E, d, f), dtype, ("normal", d ** -0.5)),
                (p + "moe.w_down", (E, f, d), dtype, ("normal", f ** -0.5))]
    return out


def _make(shape, init, g: torch.Generator, device) -> torch.Tensor:
    kw = dict(generator=g, device=device, dtype=torch.float32)
    kind = init[0]
    if kind == "normal":
        return torch.randn(shape, **kw).mul_(init[1])
    if kind in ("norm", "ones"):
        return torch.randn(shape, **kw).mul_(0.1).add_(1.0)
    if kind == "a_log":
        return torch.rand(shape, **kw).mul_(15.0).add_(1.0).log_()
    if kind == "dt_bias":
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.rand(shape, **kw).mul_(hi - lo).add_(lo).exp_()
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {init!r}")


def draw(m: dict, dtype: torch.dtype, seed: int, group: str,
         device) -> dict:
    """{name: tensor in its served dtype} of one group, drawn afresh."""
    g = torch.Generator(device=device)
    g.manual_seed(group_seed(seed, group))
    return {name: _make(shape, init, g, device).to(dt)
            for name, shape, dt, init in group_specs(m, dtype, group)}


def fill(model: torch.nn.Module, m: dict, dtype: torch.dtype, seed: int
         ) -> None:
    """Write the seed's weights into ``model``'s parameters, group by
    group; raises unless its parameters are exactly this list."""
    params = dict(model.named_parameters())
    want = {name: (shape, dt) for gname in groups(m)
            for name, shape, dt, _ in group_specs(m, dtype, gname)}
    got = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:8]
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's weight list: {diff}")
    device = next(iter(params.values())).device
    with torch.no_grad():
        for gname in groups(m):
            for name, t in draw(m, dtype, seed, gname, device).items():
                params[name].copy_(t)
