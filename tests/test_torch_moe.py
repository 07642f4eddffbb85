"""The port's MoE FF against the JAX reference on the smoke config
``qwen3-moe-30b-a3b-smoke`` (8 experts, top-2): weights from the
reference ``init_moe``, inputs from numpy. The routing (expert ids, each
choice's slot in its expert's buffer, which choices fit the capacity) is
exactly equal, also with ``moe_capacity_factor=0.25`` where tokens are
dropped; the output and the aux loss agree within 5e-4 in float32 with
the reference's einsum path and its interpreted Pallas path."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
TOL = dict(atol=5e-4, rtol=5e-4)


def _configs(capacity: float | None):
    r_cfg, cfg = r_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if capacity is not None:
        r_cfg = dataclasses.replace(r_cfg, moe_capacity_factor=capacity)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    return r_cfg, cfg


@pytest.fixture(scope="module")
def params():
    return r_moe.init_moe(jax.random.PRNGKey(0), r_get_config(ARCH, smoke=True),
                          jnp.float32)


def _port(params, cfg, dtype=torch.float32):
    layer = t_moe.MoE(cfg, device="cpu", dtype=dtype)
    for name, leaf in params.items():
        with torch.no_grad():
            getattr(layer, name).copy_(torch.tensor(np.asarray(leaf)))
    return layer


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _reference_dispatch(params, r_cfg, xt):
    """ids, pos and keep as src/repro/models/moe.py:71-79 computes them."""
    E = r_cfg.n_experts
    C = r_moe.group_capacity(r_cfg, xt.shape[1])
    _, ids, _ = r_moe.router_probs(params, r_cfg, xt)
    onehot_e = jax.nn.one_hot(ids, E, dtype=jnp.int32)
    flat = onehot_e.reshape(xt.shape[0], -1, E)
    pos_in_e = jnp.cumsum(flat, axis=1) - flat
    pos = (pos_in_e * flat).sum(-1).reshape(ids.shape)
    return np.asarray(ids), np.asarray(pos), np.asarray(pos < C)


def test_leaf_names_and_dtypes(params):
    _, cfg = _configs(None)
    layer = _port(params, cfg)
    assert {n for n, _ in layer.named_parameters()} == set(params)
    bf = t_moe.MoE(cfg, device="cpu", dtype=torch.bfloat16)
    assert bf.router.dtype == torch.float32
    assert bf.w_gate.dtype == bf.w_up.dtype == bf.w_down.dtype == torch.bfloat16


@pytest.mark.parametrize("tokens,group", [(2048, 1024), (4, 4), (24, 24),
                                         (48, 16), (7, 7)])
def test_group_size(tokens, group):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              moe_group_size=1024 if tokens != 48 else 32)
    assert t_moe.group_size(cfg, tokens) == group


@pytest.mark.parametrize("capacity", [None, 0.25])
def test_dispatch_integers_equal(params, capacity):
    r_cfg, cfg = _configs(capacity)
    x = _x((4, 16, cfg.d_model), seed=1)
    Sg = t_moe.group_size(cfg, 64)
    xt = x.reshape(-1, Sg, cfg.d_model)
    ids, pos, keep = _reference_dispatch(params, r_cfg, jnp.asarray(xt))
    layer = _port(params, cfg)
    _, t_ids, _ = t_moe.router_probs(layer, cfg, torch.from_numpy(xt))
    C = t_moe.group_capacity(cfg, Sg)
    assert C == r_moe.group_capacity(r_cfg, Sg)
    _, t_pos, t_keep = t_moe.dispatch_positions(t_ids, cfg.n_experts, C)
    assert t_pos.dtype == torch.int32
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    if capacity is not None:
        assert not keep.all()  # some choices are dropped


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("capacity", [None, 0.25])
def test_moe_forward(params, capacity, use_pallas):
    r_cfg, cfg = _configs(capacity)
    x = _x((2, 32, cfg.d_model), seed=2)
    want, want_aux = r_moe.moe_forward(params, r_cfg, jnp.asarray(x),
                                       use_pallas=use_pallas)
    counts = dict(t_ops.LAUNCHES)
    got, aux = t_moe.moe_forward(_port(params, cfg), cfg, torch.from_numpy(x))
    assert t_ops.LAUNCHES == counts  # CPU tensors launch nothing
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **TOL)


def test_plain_kernel_set_is_the_same_function(params):
    """The module call and both kernel sets give one result on the CPU."""
    _, cfg = _configs(0.25)
    layer = _port(params, cfg)
    x = torch.from_numpy(_x((1, 24, cfg.d_model), seed=3))
    a, _ = layer(x)
    b, _ = t_moe.moe_forward(layer, cfg, x, kernels=t_ops.PLAIN)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
