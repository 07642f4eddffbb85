"""The cell's weights, drawn from the seed on the device.

The benchmark makes the weights, not the program: one generator per group
of the configuration's family (``groups``: the embedding, the head, each
layer), seeded from ``(seed, group)``, draws the group's tensors in the
family's order (``group_specs``), in float32, scaled, then cast to the
dtype they are served in. The program gets them under its own parameter
names (``fill``); the plain reference draws any group again on its own
(``draw``), so it reads nothing the program holds. This module is the
machinery; the weight list is the family's (``bench/families/``), and
``fill`` refuses a model whose parameters differ from it.
"""

from __future__ import annotations

import hashlib
import math
from types import ModuleType

import torch

# shared init kinds: ("normal", scale) N(0,1)*scale; ("norm",) 1 + 0.1
# N(0,1); ("a_log",) log U(1, 16); ("dt_bias",) softplus^-1 of a
# log-uniform dt in [1e-3, 1e-1]; ("ones",) 1 + 0.1 N(0,1) for the SSM
# skip D. A family adds its own as ``INITS = {kind: fn(shape, init, g,
# device) -> float32 tensor}``.


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _make(shape, init, g: torch.Generator, device,
          family: ModuleType) -> torch.Tensor:
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
    make = getattr(family, "INITS", {}).get(kind)
    if make is None:
        raise ValueError(f"unknown init {init!r}")
    return make(shape, init, g, device)


def draw(family: ModuleType, m: dict, dtype: torch.dtype, seed: int,
         group: str, device) -> dict:
    """{name: tensor in its served dtype} of one group, drawn afresh."""
    g = torch.Generator(device=device)
    g.manual_seed(group_seed(seed, group))
    return {name: _make(shape, init, g, device, family).to(dt)
            for name, shape, dt, init in family.group_specs(m, dtype, group)}


def fill(model: torch.nn.Module, family: ModuleType, m: dict,
         dtype: torch.dtype, seed: int) -> None:
    """Write the seed's weights into ``model``'s parameters, group by
    group; raises unless its parameters are exactly the family's list."""
    params = dict(model.named_parameters())
    want = {name: (shape, dt) for gname in family.groups(m)
            for name, shape, dt, _ in family.group_specs(m, dtype, gname)}
    got = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:8]
        raise ValueError(f"the program's parameters differ from the weight "
                         f"list of the family {family.__name__}: {diff}")
    device = next(iter(params.values())).device
    with torch.no_grad():
        for gname in family.groups(m):
            for name, t in draw(family, m, dtype, seed, gname,
                                device).items():
                params[name].copy_(t)
