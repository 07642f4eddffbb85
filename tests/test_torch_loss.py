"""``loss_fn`` and its gradient on the six model families against
``jax.value_and_grad`` of the reference's ``loss_fn`` (``use_pallas=
False``): the smoke configs of h2o-danube-1.8b (dense, SWA), mamba2-780m
(SSM), qwen3-moe-30b-a3b (MoE), whisper-base (encoder-decoder),
qwen2-vl-7b (M-RoPE, patch embeddings) and jamba-v0.1-52b (hybrid), in
float32 at (2, 64), on the reference's own batch. Loss within rtol 1e-5,
every parameter's gradient within 1e-4 x its largest |value| + 1e-7,
mapped leaf for leaf by ``jax_tree_names``. Before the MoE gradients are
compared, the port's router inputs are routed by both packages' routers:
the expert ids must agree and no top-k choice may sit within 1e-6 of a
tie (the packages' hidden states differ by ~1e-7 there). No kernel is
launched."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig, ShapeKind  # noqa: E402
from repro.data import batch_for as r_batch_for  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import MoE, jax_tree_names, loss_fn  # noqa: E402
from torch_branch_parity import make_pair  # noqa: E402
from torch_fleet_parity import one_thread  # noqa: E402,F401

ARCHS = ["h2o-danube-1.8b", "mamba2-780m", "qwen3-moe-30b-a3b",
         "whisper-base", "qwen2-vl-7b", "jamba-v0.1-52b"]
SHAPE = ShapeConfig("t", ShapeKind.TRAIN, 64, 2)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_ATOL = 1e-7
TIE_MARGIN = 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, one_thread):
    cfg, params, model = make_pair(arch)
    batch = r_batch_for(cfg, SHAPE, step=0)
    (r_loss, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: r_tf.loss_fn(p, cfg, b), has_aux=True))(params, batch)

    routed = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: routed.append((mod, args[0].detach())))
        for m in model.modules() if isinstance(m, MoE)]
    t_batch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        t_batch[k] = t_batch[k].long()
    before = dict(ops.LAUNCHES)
    loss, metrics = loss_fn(model, t_batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for h in hooks:
        h.remove()
    assert ops.LAUNCHES == before

    for mod, x in routed:
        probs = torch.softmax(x.float() @ mod.router.detach(), dim=-1)
        top = torch.topk(probs, cfg.experts_per_token + 1, dim=-1)
        margin = (top.values[..., -2] - top.values[..., -1]).min()
        assert float(margin) > TIE_MARGIN, "a top-k choice sits on a tie"
        _, r_ids, _ = r_moe.router_probs(
            {"router": jnp.asarray(mod.router.detach().numpy())}, cfg,
            jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(
            np.sort(top.indices[..., :-1].numpy(), -1),
            np.sort(np.asarray(r_ids), -1))
    assert len(routed) == sum(cfg.is_moe_layer(i)
                              for i in range(cfg.n_layers)) * bool(
        cfg.n_experts)

    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               rtol=LOSS_RTOL)
    for key in ("ce", "moe_aux"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(r_metrics[key]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    want = jax_tree_names(model.cfg, jax.tree.map(np.asarray, r_grads))
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        ref = want[name]
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=GRAD_REL * float(np.abs(ref).max()) + GRAD_ATOL,
            err_msg=name)
