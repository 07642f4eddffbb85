"""whisper-base (encoder-decoder) in the port against the JAX reference on
its smoke config (2 + 2 layers, 32 encoder frames, a 64-position learned
table): the encoder alone, the cross K/V, forward logits, prefill and
decode past the position table's wrap, greedy serving, the launcher and
the parameter map. Inputs from numpy seeds; tolerances in
``torch_branch_parity``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as r_tf  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import Transformer, load_jax_params  # noqa: E402

from torch_branch_parity import (  # noqa: E402
    CPU, MAX_POSITIONS, TOL, both, check_greedy, check_prefill_and_decode,
    make_pair, normal, np_, param_counts, r_forward, tokens)
from torch_fleet_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


def _frames(cfg, batch, seed=7):
    return normal((batch, cfg.encoder_seq, cfg.d_model), seed)


def test_structure_and_param_count(pair):
    cfg, params, model = pair
    assert param_counts(cfg, params, model) == (cfg.param_count(),) * 2
    assert len(model.encoder.blocks) == cfg.n_encoder_layers
    assert tuple(model.pos_embed.shape) == (MAX_POSITIONS, cfg.d_model)
    assert all(layer.kind.cross_attn and hasattr(layer, "cross")
               and hasattr(layer, "norm_x") for layer in model.layers)


def test_encoder_alone(pair):
    """The encoder (sinusoid, bidirectional attention, GELU FF, final
    norm) on its own."""
    cfg, params, model = pair
    frames = _frames(cfg, 2)
    want = r_tf.encode(params, cfg, jnp.asarray(frames))
    got = model.encoder(torch.from_numpy(frames))
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits(pair, use_pallas):
    cfg, params, model = pair
    jx, tx = both({"encoder_frames": _frames(cfg, 2)})
    toks = tokens((2, 24), seed=1)
    want, _ = r_forward(params, cfg, jnp.asarray(toks), use_pallas=use_pallas,
                        **jx)
    got = model(torch.from_numpy(toks), **tx)
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)


def test_prefill_cross_kv_and_decode_past_the_table(pair):
    """Prefill 63 tokens, then 2 decode steps at positions 63 and 64: the
    second reads the 64-row position table at 64 % 64 = 0. The cross K/V
    that prefill fills equal the reference's, and carry over unchanged."""
    cfg, params, model = pair
    frames = _frames(cfg, 2, seed=8)
    r_state, state = check_prefill_and_decode(
        cfg, params, model, tokens((2, 65), seed=2), 63, 72,
        {"encoder_frames": frames})
    assert state.step == 65 and len(state.cross_kv) == cfg.n_layers
    for i, (k, v) in enumerate(state.cross_kv):
        rk, rv = r_state.cross_kv[0]  # period 1: stacked over layers
        np.testing.assert_allclose(np_(k), np.asarray(rk[i]), **TOL)
        np.testing.assert_allclose(np_(v), np.asarray(rv[i]), **TOL)


def test_greedy_generate_tokens_identical(pair):
    cfg, params, model = pair
    check_greedy(cfg, params, model, tokens((3, 20), seed=3), 12, 40,
                 {"encoder_frames": _frames(cfg, 3, seed=9)})


def test_forward_needs_encoder_frames(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="encoder_frames"):
        model(torch.from_numpy(tokens((1, 4), seed=4)))


def test_load_params_covers_every_leaf(pair):
    """Every leaf (``pos_embed``, ``encoder.blocks``, the encoder's final
    norm, ``cross``, the FF biases) has one parameter: dropping any of
    them leaves a parameter without a leaf, and an extra one has no
    parameter."""
    cfg, params, _ = pair
    np_params = jax.tree.map(np.asarray, params)
    model = Transformer(get_config(ARCH, smoke=True), device=CPU,
                        max_positions=MAX_POSITIONS)
    load_jax_params(model, np_params)
    enc = np_params["encoder"]["blocks"]
    np.testing.assert_array_equal(np_(model.encoder.blocks[1].ff.b1),
                                  enc["ff"]["b1"][1])
    np.testing.assert_array_equal(np_(model.layers[1].cross.wk),
                                  np_params["blocks"][0]["cross"]["wk"][1])
    np.testing.assert_array_equal(np_(model.pos_embed), np_params["pos_embed"])
    cut = lambda tree, key: {k: v for k, v in tree.items() if k != key}
    for tree, missing in (
            (cut(np_params, "pos_embed"), "pos_embed"),
            (dict(np_params, encoder=cut(np_params["encoder"], "final_norm")),
             "encoder.final_norm.scale"),
            (dict(np_params, encoder=cut(np_params["encoder"], "blocks")),
             "encoder.blocks.0")):
        with pytest.raises(ValueError, match=missing):
            load_jax_params(model, tree)
    with pytest.raises(KeyError):
        load_jax_params(model, dict(np_params, encoder=dict(
            np_params["encoder"], extra=np.zeros(3, np.float32))))


def test_launcher_main_on_cpu(capsys):
    """The launcher draws the stub frames and sizes the position table to
    prompt + new + 8, as the reference launcher does."""
    run = t_serve.main(["--arch", ARCH, "--device", "cpu", "--prompt-len",
                        "10", "--new-tokens", "4"])
    cfg = run.cfg
    assert cfg.name == "whisper-base-smoke" and run.tokens.shape == (4, 4)
    assert tuple(run.extras["encoder_frames"].shape) == (
        4, cfg.encoder_seq, cfg.d_model)
    assert run.engine.model.pos_embed.shape[0] == 10 + 4 + 8
    assert 0 <= int(run.tokens.min()) <= int(run.tokens.max()) \
        < cfg.vocab_size
    assert "whisper-base-smoke" in capsys.readouterr().out
