"""qwen2-vl-7b (M-RoPE, stub patch embeddings) in the port against the JAX
reference on its smoke config (2 layers, head_dim 16, sections (2, 3, 3),
8 patches): ``apply_mrope`` on distinct position streams, forward logits
with the default and with grid positions and patches, prefill and decode,
greedy serving and the launcher. Inputs from numpy seeds; tolerances in
``torch_branch_parity``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.layers import apply_mrope as r_apply_mrope  # noqa: E402

from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models.layers import apply_mrope, apply_rope  # noqa: E402

from torch_branch_parity import (  # noqa: E402
    TOL, both, check_greedy, check_prefill_and_decode, make_pair, normal,
    np_, param_counts, r_forward, tokens)
from torch_fleet_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "qwen2-vl-7b"


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


def grid_positions(batch: int, seq: int, side: int) -> np.ndarray:
    """(3, B, S) positions of a side x side patch grid followed by text:
    patch i at (t 0, h i // side, w i % side), text token j at
    t = h = w = side + j."""
    n = side * side
    i, j = np.arange(n), np.arange(seq - n)
    pos = np.stack([np.concatenate([np.zeros(n, np.int64), side + j]),
                    np.concatenate([i // side, side + j]),
                    np.concatenate([i % side, side + j])])
    return np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, batch, seq))).astype(np.int32)


@pytest.mark.parametrize("shape", [(2, 10, 4, 16), (1, 7, 2, 128)])
def test_apply_mrope_distinct_streams(shape):
    """Three random, distinct position streams, so each channel section
    rotates by its own stream: within 1e-6 of the reference."""
    B, S, H, D = shape
    x = normal(shape, seed=D)
    rng = np.random.default_rng(S)
    pos = rng.integers(0, 4096, (3, B, S)).astype(np.int32)
    assert len({tuple(p.ravel()) for p in pos}) == 3
    sections = (2, 3, 3) if D == 16 else (16, 24, 24)
    want = r_apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      sections)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    # one stream in all three: plain RoPE, bit for bit
    same = torch.from_numpy(pos[:1]).expand(3, B, S)
    np.testing.assert_array_equal(
        np_(apply_mrope(torch.from_numpy(x), same, 1e6, sections)),
        np_(apply_rope(torch.from_numpy(x), same[0], 1e6)))
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                    (1, 1, 1))


def test_param_count_and_biases(pair):
    cfg, params, model = pair
    assert param_counts(cfg, params, model) == (cfg.param_count(),) * 2
    attn = model.layers[0].attn
    np.testing.assert_array_equal(
        np_(attn.bq), np.asarray(params["blocks"][0]["attn"]["bq"][0]))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_default_positions(pair, use_pallas):
    cfg, params, model = pair
    toks = tokens((2, 20), seed=1)
    want, _ = r_forward(params, cfg, jnp.asarray(toks), use_pallas=use_pallas)
    got = model(torch.from_numpy(toks))
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)


def _vision_inputs(cfg, batch: int, seq: int, seed: int) -> dict:
    """Patch embeddings over the first 4 x 4 = 16 positions (more than
    the smoke config's 8: the splice takes any P) and their grid
    positions."""
    return {"patch_embeds": normal((batch, 16, cfg.d_model), seed, 0.02),
            "positions": grid_positions(batch, seq, 4)}


def test_forward_with_patches_and_grid_positions(pair):
    cfg, params, model = pair
    toks = tokens((2, 24), seed=2)
    jx, tx = both(_vision_inputs(cfg, 2, 24, seed=3))
    want, _ = r_forward(params, cfg, jnp.asarray(toks), **jx)
    got = model(torch.from_numpy(toks), **tx)
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)
    # the grid positions matter: arange positions give other logits
    plain = model(torch.from_numpy(toks), patch_embeds=tx["patch_embeds"])
    assert np.abs(np_(plain) - np_(got)).max() > 1e-3


def test_prefill_and_decode_with_patches(pair):
    cfg, params, model = pair
    toks = tokens((2, 22), seed=4)
    extras = _vision_inputs(cfg, 2, 20, seed=5)
    _, state = check_prefill_and_decode(cfg, params, model, toks, 20, 32,
                                        extras)
    assert state.step == 22 and state.cross_kv == [None] * cfg.n_layers


def test_greedy_generate_tokens_identical(pair):
    cfg, params, model = pair
    check_greedy(cfg, params, model, tokens((3, 20), seed=6), 10, 40,
                 _vision_inputs(cfg, 3, 20, seed=7))


def test_launcher_main_on_cpu(capsys):
    """Text-only, as the reference launcher runs qwen2-vl."""
    run = t_serve.main(["--arch", ARCH, "--device", "cpu", "--dtype",
                        "bfloat16", "--prompt-len", "10", "--new-tokens",
                        "3"])
    assert run.cfg.name == "qwen2-vl-7b-smoke" and run.extras == {}
    assert run.tokens.shape == (4, 3)
    assert run.engine.model.layers[0].attn.wq.dtype == torch.bfloat16
    assert "qwen2-vl-7b-smoke" in capsys.readouterr().out
