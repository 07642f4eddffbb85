"""Shared helpers of the model-branch parity tests (``test_torch_whisper.py``,
``test_torch_vlm.py``, ``test_torch_hybrid.py``): the reference's smoke
params from ``init_params(max_positions=64)`` in float32, carried into a
port ``Transformer`` by ``load_jax_params``; inputs drawn with numpy; the
reference run as ``tests/test_models.py`` runs it (``use_pallas=False``,
or ``True`` with the Pallas kernels in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as r_get_config
from repro.models import transformer as r_tf
from repro.serve.engine import ServeEngine as RServeEngine

from repro_torch.configs import get_config
from repro_torch.models import Transformer, load_jax_params
from repro_torch.serve import ServeEngine

CPU = "cpu"
MAX_POSITIONS = 64
#: forward logits (tests/test_models.py's Pallas-vs-jnp bar)
TOL = dict(atol=5e-4, rtol=5e-4)
#: prefill and decode with bfloat16 caches (tests/test_models.py:85-92)
DECODE_TOL = dict(atol=2e-3, rtol=5e-3)

r_forward = jax.jit(r_tf.forward, static_argnums=1,
                    static_argnames=("use_pallas",))
r_prefill = jax.jit(r_tf.prefill, static_argnums=1,
                    static_argnames=("max_seq", "cache_dtype", "use_pallas"))
r_decode = jax.jit(r_tf.decode_step, static_argnums=1)


def make_pair(arch: str):
    """(reference cfg, reference params, port model with the same
    weights) for the smoke config of ``arch``."""
    cfg = r_get_config(arch, smoke=True)
    params = jax.jit(r_tf.init_params, static_argnums=1,
                     static_argnames=("dtype", "max_positions"))(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32,
        max_positions=MAX_POSITIONS)
    model = Transformer(get_config(arch, smoke=True), device=CPU,
                        max_positions=MAX_POSITIONS)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg, params, model


def tokens(shape, seed: int, vocab: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def np_(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def both(extras: dict) -> tuple[dict, dict]:
    """The same numpy inputs as jnp (reference) and torch (port) kwargs."""
    return ({k: jnp.asarray(v) for k, v in extras.items()},
            {k: torch.from_numpy(v) for k, v in extras.items()})


def check_prefill_and_decode(cfg, params, model, toks: np.ndarray,
                             n_prompt: int, max_seq: int, extras: dict):
    """Prefill ``toks[:, :n_prompt]`` (bfloat16 caches, the engine's
    default) then decode the rest one token at a time, both packages;
    logits within ``DECODE_TOL`` at every step. Returns both states."""
    jx, tx = both(extras)
    want, r_state = r_prefill(params, cfg, jnp.asarray(toks[:, :n_prompt]),
                              max_seq=max_seq, use_pallas=True, **jx)
    got, state = model.prefill(torch.from_numpy(toks[:, :n_prompt]),
                               max_seq=max_seq, **tx)
    np.testing.assert_allclose(np_(got), np.asarray(want), **DECODE_TOL)
    assert state.step == int(r_state.step) == n_prompt
    for pos in range(n_prompt, toks.shape[1]):
        step = toks[:, pos:pos + 1]
        want, r_state = r_decode(params, cfg, r_state, jnp.asarray(step))
        got, state = model.decode_step(state, torch.from_numpy(step))
        np.testing.assert_allclose(np_(got), np.asarray(want), **DECODE_TOL,
                                   err_msg=f"position {pos}")
    return r_state, state


def check_greedy(cfg, params, model, toks: np.ndarray, new: int,
                 max_seq: int, extras: dict) -> None:
    """``ServeEngine.generate`` greedy tokens equal in both packages."""
    jx, tx = both(extras)
    want = RServeEngine(cfg, params, max_seq=max_seq,
                        use_pallas=True).generate(jnp.asarray(toks),
                                                  max_new_tokens=new, **jx)
    got = ServeEngine(model.cfg, model, max_seq=max_seq,
                      device=CPU).generate(torch.from_numpy(toks),
                                           max_new_tokens=new, **tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def param_counts(cfg, params, model) -> tuple[int, int]:
    return (sum(p.numel() for p in model.parameters()),
            r_tf.count_params(params))
