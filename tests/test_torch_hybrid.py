"""jamba-v0.1-52b (hybrid attention + Mamba-2 + MoE) in the port against
the JAX reference on its smoke config: one whole 8-layer super-block, with
attention at layer 4, Mamba-2 at the other seven and MoE at the four odd
layers. Forward logits, prefill (logits, KV cache, SSM states and conv
tails) and decode, greedy serving and the launcher. Inputs from numpy
seeds; tolerances in ``torch_branch_parity``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.launch import serve as t_serve  # noqa: E402

from torch_branch_parity import (  # noqa: E402
    DECODE_TOL, TOL, check_greedy, check_prefill_and_decode, make_pair, np_,
    param_counts, r_forward, tokens)
from torch_fleet_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


def test_super_block_layout_and_param_count(pair):
    cfg, params, model = pair
    kinds = [(layer.kind.mixer, layer.kind.ff) for layer in model.layers]
    assert kinds == [("mamba", "dense"), ("mamba", "moe"),
                     ("mamba", "dense"), ("mamba", "moe"),
                     ("attn", "dense"), ("mamba", "moe"),
                     ("mamba", "dense"), ("mamba", "moe")]
    assert len(params["blocks"]) == 8  # one super-block, period 8
    assert param_counts(cfg, params, model) == (cfg.param_count(),) * 2


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits(pair, use_pallas):
    """S = 24: the Mamba layers pad to their 16-token chunk."""
    cfg, params, model = pair
    toks = tokens((2, 24), seed=1)
    want, _ = r_forward(params, cfg, jnp.asarray(toks), use_pallas=use_pallas)
    got = model(torch.from_numpy(toks))
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)


def test_prefill_states_and_decode(pair):
    """Prefill 20 tokens, then 2 decode steps; after them every layer's
    cache (the attention layer's KV ring, the Mamba layers' SSM state and
    conv tails) equals the reference's."""
    cfg, params, model = pair
    r_state, state = check_prefill_and_decode(
        cfg, params, model, tokens((2, 22), seed=2), 20, 32, {})
    assert state.step == 22
    for i, cache in enumerate(state.caches):
        r_cache = r_state.caches[i]  # one super-block: position i is layer i
        fields = (("k", "v") if model.layers[i].kind.mixer == "attn"
                  else ("ssm", "conv_x", "conv_bc"))
        for f in fields:
            np.testing.assert_allclose(
                np_(getattr(cache, f)), np.asarray(getattr(r_cache, f)[0]),
                **DECODE_TOL, err_msg=f"layer {i} {f}")


def test_greedy_generate_tokens_identical(pair):
    cfg, params, model = pair
    check_greedy(cfg, params, model, tokens((3, 20), seed=3), 10, 40, {})


def test_launcher_main_on_cpu(capsys):
    run = t_serve.main(["--arch", ARCH, "--device", "cpu", "--prompt-len",
                        "10", "--new-tokens", "3"])
    assert run.cfg.name == "jamba-v0.1-52b-smoke" and run.extras == {}
    assert run.tokens.shape == (4, 3)
    assert "jamba-v0.1-52b-smoke" in capsys.readouterr().out
