"""The port's meta-tensor specs (``repro_torch.configs.specs``) against the
reference's ``jax.eval_shape`` structs: every parameter, batch and decode
state leaf of the ten full configs at the four shapes has the reference's
shape and dtype exactly, once the reference's leading super-block axis is
dropped (names mapped by ``models.jax_tree_names``). Then
``Transformer.init_decode_state`` against the state ``prefill`` returns on
the six smoke configs, and decode through ``train_paths(cfg)`` against
decode through the kernel set on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.kernels.ops import KERNELS  # noqa: E402
from repro_torch.models import (  # noqa: E402
    KVCache, SSMState, Transformer, block_period, jax_tree_names,
    train_paths)

from torch_fleet_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = r_configs.ARCH_IDS
SHAPES = r_configs.SHAPE_IDS
SMOKE = ("h2o-danube-1.8b", "mamba2-780m", "qwen3-moe-30b-a3b",
         "whisper-base", "qwen2-vl-7b", "jamba-v0.1-52b")


def _zeros(sds):
    """A zero-strided numpy view of a ShapeDtypeStruct (no allocation), so
    ``jax_tree_names`` can index its stacked axis."""
    return np.broadcast_to(np.zeros((), sds.dtype), sds.shape)


def _sig(t) -> tuple:
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


def test_copied_helpers_answer_as_the_reference():
    for arch in ARCHS:
        for sid in SHAPES:
            r_cfg, r_shape = r_configs.get_config(arch), r_configs.get_shape(sid)
            t_cfg, t_shape = t_configs.get_config(arch), t_configs.get_shape(sid)
            assert (t_configs.max_positions_for(t_cfg, t_shape)
                    == r_configs.max_positions_for(r_cfg, r_shape))
            assert (t_configs.cell_supported(t_cfg, t_shape)
                    == r_configs.cell_supported(r_cfg, r_shape))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, shape):
    cfg = r_configs.get_config(arch)
    want = jax_tree_names(cfg, jax.tree.map(
        _zeros, r_configs.param_specs(cfg, r_configs.get_shape(shape))))
    got = t_configs.param_specs(t_configs.get_config(arch),
                                t_configs.get_shape(shape))
    assert set(got) == set(want)
    for name, (shp, dtype) in got.items():
        assert (shp, str(dtype).removeprefix("torch.")) == _sig(want[name]), \
            name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch, shape):
    want = r_configs.batch_specs(r_configs.get_config(arch),
                                 r_configs.get_shape(shape))
    got = t_configs.batch_specs(t_configs.get_config(arch),
                                t_configs.get_shape(shape))
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert _sig(t) == _sig(want[k]), k


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_specs_equal_the_reference(arch, shape):
    """Cache i of the port is the reference's position j = i % period at
    super-block s = i // period; its ``length`` and the state's ``step``
    are Python ints where the reference has int32 scalars."""
    r_cfg = r_configs.get_config(arch)
    r_state, r_tok = r_configs.decode_specs(r_cfg,
                                            r_configs.get_shape(shape))
    state, tok = t_configs.decode_specs(t_configs.get_config(arch),
                                        t_configs.get_shape(shape))
    assert _sig(tok) == _sig(r_tok)
    period = block_period(r_cfg)
    assert len(state.caches) == r_cfg.n_layers
    assert _sig(r_state.step) == ((), "int32") and state.step == 0
    for i, cache in enumerate(state.caches):
        s, ref = divmod(i, period)[0], r_state.caches[i % period]
        if isinstance(cache, KVCache):
            assert (_sig(cache.k), _sig(cache.v)) == (
                _sig(_zeros(ref.k)[s]), _sig(_zeros(ref.v)[s])), i
            assert cache.length == 0 and _sig(ref.length)[1] == "int32"
        else:
            assert isinstance(cache, SSMState)
            for leaf in ("conv_x", "conv_bc", "ssm"):
                assert _sig(getattr(cache, leaf)) == _sig(
                    _zeros(getattr(ref, leaf))[s]), (i, leaf)
    if r_state.cross_kv is None:
        assert state.cross_kv == [None] * r_cfg.n_layers
    else:
        for i, (k, v) in enumerate(state.cross_kv):
            rk, rv = r_state.cross_kv[i % period]
            s = i // period
            assert (_sig(k), _sig(v)) == (_sig(_zeros(rk)[s]),
                                          _sig(_zeros(rv)[s])), i


def _smoke_inputs(cfg, B: int, S: int) -> dict:
    rng = np.random.default_rng(3)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))}
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", SMOKE)
def test_init_decode_state_matches_prefill_state(arch):
    """Every leaf of ``init_decode_state`` has the shape and dtype of the
    state ``prefill`` returns, on the CPU and on meta tensors alike; the
    cross K/V are the prefill's own values. The weights are in
    ``cfg.dtype``: a Mamba layer's prefill keeps its conv tails in the
    activations' dtype and the empty state holds them in bfloat16, in the
    reference as here."""
    cfg = t_configs.get_config(arch, smoke=True)
    dtype = getattr(torch, cfg.dtype)
    model = Transformer(cfg, device="cpu", dtype=dtype,
                        generator=torch.Generator().manual_seed(0))
    inp = _smoke_inputs(cfg, 2, 12)
    frames = inp.get("encoder_frames")
    frames = None if frames is None else frames.to(dtype)
    _, want = model.prefill(inp["tokens"], max_seq=32,
                            encoder_frames=frames)
    got = model.init_decode_state(2, 32, encoder_frames=frames)
    meta = Transformer(cfg, device="meta", dtype=dtype).init_decode_state(
        2, 32, encoder_frames=None if frames is None else frames.to("meta"),
        kernels=train_paths(cfg))
    for state in (got, meta):
        assert state.step == 0
        assert len(state.caches) == len(want.caches)
        for c, w in zip(state.caches, want.caches):
            assert type(c) is type(w)
            leaves = ("k", "v") if isinstance(c, KVCache) else (
                "conv_x", "conv_bc", "ssm")
            for leaf in leaves:
                assert _sig(getattr(c, leaf)) == _sig(getattr(w, leaf)), leaf
        for c, w in zip(state.cross_kv, want.cross_kv):
            assert (c is None) == (w is None)
            if c is not None:
                assert [_sig(t) for t in c] == [_sig(t) for t in w]
    for c, w in zip(got.cross_kv, want.cross_kv):
        if c is not None:
            for a, b in zip(c, w):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", SMOKE)
def test_decode_through_train_paths_equals_the_kernel_set(arch):
    """On the CPU both kernel sets are plain functions of the same math:
    a decode step through ``train_paths(cfg)`` gives the logits of one
    through ``KERNELS`` (the default)."""
    cfg = t_configs.get_config(arch, smoke=True)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    inp = _smoke_inputs(cfg, 2, 10)
    _, s1 = model.prefill(inp["tokens"], max_seq=16,
                          encoder_frames=inp.get("encoder_frames"))
    _, s2 = model.prefill(inp["tokens"], max_seq=16,
                          encoder_frames=inp.get("encoder_frames"))
    step = inp["tokens"][:, :1]
    a, _ = model.decode_step(s1, step)
    b, _ = model.decode_step(s2, step, kernels=train_paths(cfg))
    c, _ = model.decode_step(s1, step, kernels=KERNELS)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(c).all()


def test_reference_decode_state_is_stacked_per_position():
    """The reference's layout the mapping above relies on: one cache per
    sub-layer position, stacked over the super-blocks."""
    cfg = r_configs.get_config("jamba-v0.1-52b")
    state, _ = r_configs.decode_specs(cfg, r_configs.get_shape("decode_32k"))
    assert len(state.caches) == block_period(cfg) == 8
    assert state.caches[4].k.shape[0] == cfg.n_layers // 8
    assert jnp.dtype(state.caches[0].ssm.dtype) == jnp.float32


@pytest.mark.parametrize("arch", SMOKE)
def test_decode_step_seam_keeps_the_served_launch_counts(arch, monkeypatch):
    """A default decode step calls each kernel wrapper as often as
    ``kernel_launches`` counts for one step (counted on the CPU through
    the plain versions the wrappers take there); one through
    ``train_paths(cfg)`` calls none of them."""
    from repro_torch.kernels import ref as t_ref
    from repro_torch.models import kernel_launches

    cfg = t_configs.get_config(arch, smoke=True)
    paths = train_paths(cfg)  # before the patch: the unpatched functions
    counts = dict.fromkeys(("flash_attention", "fused_rmsnorm", "ssd_scan",
                            "grouped_matmul"), 0)
    for fn, key in (("flash_attention_ref", "flash_attention"),
                    ("rmsnorm_ref", "fused_rmsnorm"),
                    ("ssd_ref", "ssd_scan"),
                    ("grouped_matmul_ref", "grouped_matmul")):
        def counted(*args, _fn=getattr(t_ref, fn), _key=key, **kw):
            counts[_key] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(t_ref, fn, counted)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    inp = _smoke_inputs(cfg, 2, 10)
    _, state = model.prefill(inp["tokens"], max_seq=16, kernels=paths,
                             encoder_frames=inp.get("encoder_frames"))
    model.decode_step(state, inp["tokens"][:, :1], kernels=paths)
    assert not any(counts.values())
    model.decode_step(state, inp["tokens"][:, :1])
    one, none = kernel_launches(cfg, 1), kernel_launches(cfg, 0)
    assert counts == {k: one[k] - none[k] for k in one}
