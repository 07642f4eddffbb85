"""The decode step's device-side position and the rotary tables behind
the engine's CUDA graph, on the CPU: a decode step given its position
tensor equals one that builds it, bit for bit, across a wrapping ring,
whisper's learned table and qwen2-vl's M-RoPE; the rotary table is built
once per (head_dim, theta, device) with the bits of ``rope_frequencies``;
``ServeEngine.serve_step`` on the CPU takes the eager step and counts it.
The graph itself runs on the card only (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import Transformer
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import ServeEngine

SMOKE = ("h2o-danube-1.8b", "mamba2-780m", "qwen3-moe-30b-a3b",
         "whisper-base", "qwen2-vl-7b", "jamba-v0.1-52b")
PROMPT, STEPS, MAX_SEQ = 30, 40, 48


def _model(arch: str) -> Transformer:
    cfg = get_config(arch, smoke=True)
    return Transformer(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))


def _inputs(cfg, batch: int = 2, seq: int = PROMPT) -> dict:
    rng = np.random.default_rng(3)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int64))}
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(engine_mod._leaves(a), engine_mod._leaves(b)))


@pytest.mark.parametrize("arch", SMOKE)
def test_decode_step_given_its_positions_equals_the_default(arch):
    """40 steps past a 30-token prompt: danube's 16-slot SWA ring wraps
    twice, whisper's 64-row learned table wraps, qwen2-vl rotates by
    M-RoPE. One state steps with the positions ``decode_step`` builds,
    the other with one (B, 1) int32 tensor refilled each step, as the
    engine's graph refills its static one: logits and every state tensor
    stay the same bits."""
    model = _model(arch)
    cfg = model.cfg
    inp = _inputs(cfg)
    toks = inp.pop("tokens")
    _, s_built = model.prefill(toks, max_seq=MAX_SEQ, **inp)
    logits, s_given = model.prefill(toks, max_seq=MAX_SEQ, **inp)
    pos = torch.zeros((toks.shape[0], 1), dtype=torch.int32)
    tok = logits[:, -1:].argmax(-1)
    for _ in range(STEPS):
        a, s_built = model.decode_step(s_built, tok)
        pos.fill_(s_given.step)
        b, s_given = model.decode_step(s_given, tok, positions=pos)
        assert torch.equal(a, b)
        assert _leaves_equal(s_built, s_given)
        assert s_built.step == s_given.step
        tok = a.argmax(-1)
    assert s_given.step == PROMPT + STEPS
    if arch == "h2o-danube-1.8b":
        assert s_given.caches[0].k.shape[1] == cfg.sliding_window == 16
    if arch == "whisper-base":
        assert s_given.step > model.pos_embed.shape[0]
    for c in s_given.caches:
        if isinstance(c, KVCache):
            assert c.length == s_given.step


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (80, 1e4),
                                            (128, 1e6), (64, 5e5)])
def test_rope_table_has_the_bits_of_rope_frequencies(head_dim, theta):
    got = layers.rope_table(head_dim, theta, torch.device("cpu"))
    want = torch.as_tensor(layers.rope_frequencies(head_dim, theta),
                           dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_rope_frequencies_runs_once_per_head_dim_theta_and_device(
        monkeypatch):
    """Every rotation after the first reads the cached table: neither
    ``apply_rope`` nor ``apply_mrope`` calls ``rope_frequencies`` again for
    a (head_dim, theta, device) it has seen; M-RoPE's section ids are
    cached likewise."""
    calls = []
    real = layers.rope_frequencies

    def counted(head_dim, theta):
        calls.append((head_dim, theta))
        return real(head_dim, theta)

    monkeypatch.setattr(layers, "_INV_FREQ", {})
    monkeypatch.setattr(layers, "_SECTION_IDS", {})
    monkeypatch.setattr(layers, "rope_frequencies", counted)
    x = torch.randn(2, 5, 4, 16)
    pos = torch.arange(5).expand(2, 5)
    for _ in range(5):
        layers.apply_rope(x, pos, 1e4)
        layers.apply_mrope(x, pos.expand(3, 2, 5), 1e4, (2, 3, 3))
    assert calls == [(16, 1e4)]
    layers.apply_rope(x, pos, 1e6)
    layers.apply_rope(x.to("meta"), pos.to("meta"), 1e4)
    layers.apply_rope(torch.randn(2, 5, 4, 32), pos, 1e4)
    assert calls == [(16, 1e4), (16, 1e6), (16, 1e4), (32, 1e4)]
    assert len(layers._SECTION_IDS) == 1


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "jamba-v0.1-52b",
                                  "whisper-base"])
def test_serve_step_on_the_cpu_is_the_eager_step(arch, monkeypatch):
    """On the CPU ``serve_step`` counts an eager step and no capture or
    replay, and gives the bits of ``decode_step`` on a twin state."""
    monkeypatch.setattr(engine_mod, "STEPS", dict.fromkeys(
        engine_mod.STEPS, 0))
    model = _model(arch)
    eng = ServeEngine(model.cfg, model, max_seq=MAX_SEQ, device="cpu")
    inp = _inputs(model.cfg)
    toks = inp.pop("tokens")
    logits, state = eng.prefill_batch(toks, **inp)
    _, twin = model.prefill(toks, max_seq=MAX_SEQ, **inp)
    tok = logits.argmax(-1, keepdim=True)
    for _ in range(3):
        logits, state = eng.serve_step(state, tok)
        want, twin = model.decode_step(twin, tok)
        assert torch.equal(logits, want[:, 0])
        assert _leaves_equal(state, twin)
        tok = logits.argmax(-1, keepdim=True)
    assert engine_mod.STEPS == {"captures": 0, "replays": 0,
                                "eager_steps": 3}
    assert not eng._graphs


@pytest.mark.parametrize("arch", SMOKE)
def test_one_layout_for_every_prompt_length(arch):
    """The graph's key: two prefills of different lengths give one layout
    (the ring and the SSM state do not grow), another batch size another;
    a state rebuilt over its own tensors is the same state."""
    model = _model(arch)
    cfg = model.cfg
    key = {}
    for batch, seq in ((2, 10), (2, 30), (3, 10)):
        inp = _inputs(cfg, batch, seq)
        toks = inp.pop("tokens")
        _, state = model.prefill(toks, max_seq=MAX_SEQ, **inp)
        key[batch, seq] = engine_mod._layout(state, toks[:, :1])
        again = engine_mod._over(state, engine_mod._leaves(state), 0)
        assert all(a is b for a, b in zip(engine_mod._leaves(again),
                                           engine_mod._leaves(state)))
        nxt = engine_mod._over(state, engine_mod._leaves(state), 1)
        assert nxt.step == state.step + 1 == seq + 1
    assert key[2, 10] == key[2, 30] != key[3, 10]
