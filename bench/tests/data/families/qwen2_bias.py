"""A family that the ``lm`` family cannot build, for the tests: dense GQA
whose q, k and v projections carry biases (``attn.bq``, ``.bk``, ``.bv``),
as the port's qwen2-72b does. It reuses the ``lm`` family's weight list
and ``reference.lm``'s blocks and adds the biases to the weight list (drawn
by an init kind of its own, ``INITS``) and to the reference's attention.
The counts are ``lm``'s: a bias is an elementwise add, which model FLOPs
do not count, and no kernel takes it.
"""

from __future__ import annotations

import torch

from bench.families import lm
from bench.reference import lm as blocks

groups = lm.groups
prefill_flops = lm.prefill_flops
decode_flops = lm.decode_flops
train_flops = lm.train_flops
layer_calls = lm.layer_calls


def _uniform(shape, init, g, device):
    """U(-a, a) for ("uniform", a)."""
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return u.mul_(2 * init[1]).sub_(init[1])


INITS = {"uniform": _uniform}


def group_specs(m, dtype, group):
    out = lm.group_specs(m, dtype, group)
    if not group.startswith("layers."):
        return out
    p, hd = group + ".attn.", m["head_dim"]
    return out + [(p + "bq", (m["n_heads"] * hd,), dtype, ("uniform", 0.2)),
                  (p + "bk", (m["n_kv_heads"] * hd,), dtype, ("uniform", 0.2)),
                  (p + "bv", (m["n_kv_heads"] * hd,), dtype, ("uniform", 0.2))]


def attention(x, w, m, S, cache_dtype, ar):
    B, L, _ = x.shape
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = (ar.mm(x, w["attn.wq"]) + w["attn.bq"]).view(B, L, H, D)
    k = (ar.mm(x, w["attn.wk"]) + w["attn.bk"]).view(B, L, Hkv, D)
    v = (ar.mm(x, w["attn.wv"]) + w["attn.bv"]).view(B, L, Hkv, D)
    out = blocks.attend(q, k, v, m, S, cache_dtype, ar)
    return ar.mm(out.view(B, L, H * D), w["attn.wo"])


def layer(x, w, m, i, S, cache_dtype, ar):
    h = blocks.rmsnorm(x, w["norm1.scale"], m["norm_eps"])
    x = x + attention(h, w, m, S, cache_dtype, ar)
    h = blocks.rmsnorm(x, w["norm2.scale"], m["norm_eps"])
    return x + blocks.swiglu(h, w["ff.w_gate"], w["ff.w_up"], w["ff.w_down"],
                             ar)


def served_logits(cfg, seed_weights, batches, precision="float32"):
    return blocks.served_logits(cfg, groups(cfg["model"]), layer,
                                seed_weights, batches, precision)


def loss_fn(cfg, p, tokens, labels, ar):
    return blocks.loss(cfg, layer, p, tokens, labels, ar)
