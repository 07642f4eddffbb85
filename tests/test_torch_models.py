"""The port's execute half against the JAX reference on the smoke configs
``h2o-danube-1.8b-smoke`` (head_dim 16, window 16), ``mamba2-780m-smoke``
and ``qwen3-moe-30b-a3b-smoke``: params from the reference
``init_params``, converted with ``load_jax_params`` (also from the default
bfloat16, bit for bit); tokens from numpy. Forward, prefill (logits and
ring caches / SSM states) and decode (past the window wrap for danube)
within 5e-4 (bf16 cache: the ``tests/test_models.py`` decode bar),
prefill-then-decode equal to the full forward at the reference's own bars,
greedy tokens identical, and the launcher end to end on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.launch.serve import env_at_hour as r_env_at_hour  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro.serve.router import GreenScaleRouter as RRouter  # noqa: E402
from repro.serve.router import Request as RRequest  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Environment, Grid, Workload, grid_trace  # noqa: E402
from repro_torch.core.infrastructure import pack_infra, tpu_fleet  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import Transformer, init_kv_cache, load_jax_params  # noqa: E402
from repro_torch.models.layers import GeluMLP  # noqa: E402
from repro_torch.serve import GreenScaleRouter, Request, ServeEngine  # noqa: E402

ARCH = "h2o-danube-1.8b"
CPU = "cpu"
TOL = dict(atol=5e-4, rtol=5e-4)
BF16_CACHE_TOL = dict(atol=5e-3, rtol=1e-2)  # tests/test_models.py:92

_r_prefill = jax.jit(r_tf.prefill, static_argnums=1,
                     static_argnames=("max_seq", "cache_dtype", "use_pallas"))
_r_decode = jax.jit(r_tf.decode_step, static_argnums=1)
_r_forward = jax.jit(r_tf.forward, static_argnums=1,
                     static_argnames=("use_pallas",))


@pytest.fixture(scope="module")
def pair():
    """(cfg, reference params, port model holding the same weights)."""
    cfg = r_get_config(ARCH, smoke=True)
    params = jax.jit(r_tf.init_params, static_argnums=1,
                     static_argnames="dtype")(jax.random.PRNGKey(0), cfg,
                                              dtype=jnp.float32)
    model = Transformer(get_config(ARCH, smoke=True), device=CPU)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg, params, model


def _tokens(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _np(t):
    return t.detach().float().cpu().numpy()


def _dense(model, name):
    return next(p for n, p in model.named_parameters() if n == name)


class TestLoadParams:
    @pytest.mark.parametrize("arch", [ARCH, "mamba2-780m", "qwen3-moe-30b-a3b"])
    def test_default_bfloat16_params_convert_bit_for_bit(self, arch):
        """``init_params`` in the config's own dtype (bfloat16) converts
        into a bfloat16 model; every parameter equals its reference leaf
        bit for bit (float32 leaves stay float32)."""
        cfg = r_get_config(arch, smoke=True)
        assert cfg.dtype == "bfloat16"
        params = r_tf.init_params(jax.random.PRNGKey(1), cfg)
        model = Transformer(get_config(arch, smoke=True), device=CPU,
                            dtype=torch.bfloat16)
        load_jax_params(model, jax.tree.map(np.asarray, params))
        period = r_tf.block_period(cfg)
        want = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
            if keys[0] == "blocks":
                for s_ in range(leaf.shape[0]):
                    name = ".".join(map(str, ["layers", s_ * period + keys[1]]
                                        + keys[2:]))
                    want[name] = leaf[s_]
            else:
                want[".".join(map(str, keys))] = leaf
        assert set(want) == {n for n, _ in model.named_parameters()}
        for name, leaf in want.items():
            p = _dense(model, name)
            assert str(p.dtype)[6:] == str(leaf.dtype), name
            got = p.detach().view(torch.int16 if p.dtype == torch.bfloat16
                                  else torch.int32).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(leaf).view(got.dtype), err_msg=name)

    def test_every_leaf_is_loaded(self, pair):
        cfg, params, model = pair
        leaves = jax.tree.leaves(params)
        assert sum(p.numel() for p in model.parameters()) == \
            sum(int(np.prod(l.shape)) for l in leaves) == cfg.param_count()
        np_params = jax.tree.map(np.asarray, params)
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(
                _np(model.layers[i].attn.wq), np_params["blocks"][0]["attn"]["wq"][i])
            np.testing.assert_array_equal(
                _np(model.layers[i].norm2.scale),
                np_params["blocks"][0]["norm2"]["scale"][i])
        np.testing.assert_array_equal(_np(model.lm_head), np_params["lm_head"])

    def test_mismatched_trees_raise(self, pair):
        cfg, params, _ = pair
        np_params = jax.tree.map(np.asarray, params)
        model = Transformer(get_config(ARCH, smoke=True), device=CPU)
        extra = dict(np_params, pos_embed=np.zeros((4, cfg.d_model), np.float32))
        with pytest.raises(KeyError):
            load_jax_params(model, extra)
        missing = {k: v for k, v in np_params.items() if k != "lm_head"}
        with pytest.raises(ValueError, match="lm_head"):
            load_jax_params(model, missing)


class TestParity:
    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_forward_logits(self, pair, use_pallas):
        cfg, params, model = pair
        toks = _tokens((2, 32))  # S=32 > window 16: the window mask bites
        want, _ = _r_forward(params, cfg, jnp.asarray(toks),
                             use_pallas=use_pallas)
        got = model(torch.from_numpy(toks))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    @pytest.mark.parametrize("seq", [12, 32])  # ring padded / ring wrapped
    def test_prefill_logits_and_ring_caches(self, pair, seq):
        cfg, params, model = pair
        toks = _tokens((2, seq), seed=seq)
        want, r_state = _r_prefill(params, cfg, jnp.asarray(toks), max_seq=40,
                                   cache_dtype=jnp.float32, use_pallas=True)
        got, state = model.prefill(torch.from_numpy(toks), max_seq=40,
                                   cache_dtype=torch.float32)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        assert state.step == int(r_state.step) == seq
        for i, cache in enumerate(state.caches):
            assert cache.length == seq
            np.testing.assert_allclose(_np(cache.k),
                                       np.asarray(r_state.caches[0].k[i]), **TOL)
            np.testing.assert_allclose(_np(cache.v),
                                       np.asarray(r_state.caches[0].v[i]), **TOL)

    @pytest.mark.parametrize("cache", ["float32", "bfloat16"])
    def test_decode_past_window_wrap(self, pair, cache):
        """Prompt 12, then 10 decode steps: positions 12..21 wrap the
        16-slot ring at 16."""
        cfg, params, model = pair
        jd, td = {"float32": (jnp.float32, torch.float32),
                  "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache]
        tol = TOL if cache == "float32" else BF16_CACHE_TOL
        toks = _tokens((2, 22), seed=3)
        _, r_state = _r_prefill(params, cfg, jnp.asarray(toks[:, :12]),
                                max_seq=30, cache_dtype=jd, use_pallas=True)
        _, state = model.prefill(torch.from_numpy(toks[:, :12]), max_seq=30,
                                 cache_dtype=td)
        assert state.caches[0].k.shape[1] == 16
        for pos in range(12, 22):
            step = toks[:, pos:pos + 1]
            want, r_state = _r_decode(params, cfg, r_state, jnp.asarray(step))
            got, state = model.decode_step(state, torch.from_numpy(step))
            np.testing.assert_allclose(_np(got), np.asarray(want), **tol,
                                       err_msg=f"position {pos}")
        assert state.step == 22

    @pytest.mark.parametrize("arch,max_seq", [(ARCH, 40), (ARCH, 8),
                                              ("deepseek-7b", 40)])
    def test_init_kv_cache(self, arch, max_seq):
        """Ring buffer min(max_seq, window) for SWA, max_seq otherwise."""
        r_cfg, t_cfg = r_get_config(arch, smoke=True), get_config(arch, smoke=True)
        want = r_attn.init_kv_cache(r_cfg, 3, max_seq, jnp.float32)
        got = init_kv_cache(t_cfg, 3, max_seq, torch.float32, device=CPU)
        assert tuple(got.k.shape) == tuple(want.k.shape)
        assert tuple(got.v.shape) == tuple(want.v.shape)
        assert got.length == int(want.length) == 0
        assert got.k.dtype == torch.float32 and not got.k.any()

    def test_engine_admission_and_kv_fit(self, pair):
        cfg, params, model = pair
        targets = np.array([0, 1, 2, 1, 1, 0])
        seq = np.array([30.0, 50.0, 10.0, 40.0, 5.0])
        for tier, slots in [(None, None), (1, 3), (2, 1)]:
            r = RServeEngine(cfg, params, max_seq=40, tier=tier, kv_slots=slots)
            t = ServeEngine(get_config(ARCH, smoke=True), model, max_seq=40,
                            tier=tier, kv_slots=slots, device=CPU)
            np.testing.assert_array_equal(t.admit_indices(targets),
                                          r.admit_indices(targets))
            assert t.kv_fit_rows(seq) == r.kv_fit_rows(seq)
            assert t.kv_token_budget == r.kv_token_budget


class TestSlice:
    def test_route_then_greedy_generate(self, pair):
        """The whole slice: route one request on the full config at hour
        12, then serve a batch greedily on the smoke weights, on both
        sides; decisions and tokens identical."""
        cfg, params, model = pair
        r_dec = RRouter(r_get_config(ARCH)).route(
            RRequest(prompt_tokens=512, max_new_tokens=16), r_env_at_hour(12))
        t_dec = GreenScaleRouter(get_config(ARCH), device=CPU).route(
            Request(prompt_tokens=512, max_new_tokens=16),
            t_serve.env_at_hour(12, device=CPU))
        assert t_dec.target == r_dec.target and t_dec.feasible == r_dec.feasible
        np.testing.assert_allclose(t_dec.per_target_carbon,
                                   r_dec.per_target_carbon, rtol=1e-5)
        toks = _tokens((4, 24), seed=11)
        want = RServeEngine(cfg, params, max_seq=48, use_pallas=True).generate(
            jnp.asarray(toks), max_new_tokens=16)
        got = ServeEngine(get_config(ARCH, smoke=True), model, max_seq=48,
                          device=CPU).generate(torch.from_numpy(toks),
                                               max_new_tokens=16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_launcher_main_on_cpu(self, capsys):
        run = t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--prompt-len", "10", "--new-tokens", "5"])
        assert run.cfg.name == "h2o-danube-1.8b-smoke"
        assert run.tokens.shape == (4, 5) and run.prompt.shape == (4, 10)
        assert int(run.tokens.min()) >= 0
        assert int(run.tokens.max()) < run.cfg.vocab_size
        assert run.decision.target in (0, 1, 2)
        out = capsys.readouterr().out
        assert "[router] hour=12" in out and "generated (4, 5) tokens" in out

    def test_launcher_smoke_flag(self):
        assert t_serve.parse_args(["--arch", ARCH]).smoke is True
        assert t_serve.parse_args(["--arch", ARCH, "--no-smoke"]).smoke is False
        assert t_serve.parse_args(["--arch", ARCH]).device == "cuda"


def _entry_points():
    cfg = get_config(ARCH, smoke=True)
    model = Transformer(cfg, device=CPU)
    return {
        "Transformer": lambda: Transformer(cfg),
        "ServeEngine": lambda: ServeEngine(cfg, model),
        "GreenScaleRouter": lambda: GreenScaleRouter(get_config(ARCH)),
        "pack_infra": lambda: pack_infra(tpu_fleet()),
        "Workload.make": lambda: Workload.make(1.0, 1.0, 1.0, 1.0, 1.0),
        "Environment.make": lambda: Environment.make(1.0, 1.0, 1.0, 1.0),
        "grid_trace": lambda: grid_trace(Grid.CISO),
        "env_at_hour": lambda: t_serve.env_at_hour(12),
        "launcher": lambda: t_serve.main(["--arch", ARCH]),
    }


@pytest.mark.parametrize("name", ["Transformer", "ServeEngine",
                                  "GreenScaleRouter", "pack_infra",
                                  "Workload.make", "Environment.make",
                                  "grid_trace", "env_at_hour", "launcher"])
def test_entry_point_without_device_raises_on_cpu_host(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


NEW_ARCHS = ["mamba2-780m", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module", params=NEW_ARCHS)
def new_pair(request):
    """(cfg, reference params, port model) for the SSM and MoE smoke
    configs, in float32."""
    arch = request.param
    cfg = r_get_config(arch, smoke=True)
    params = jax.jit(r_tf.init_params, static_argnums=1,
                     static_argnames="dtype")(jax.random.PRNGKey(0), cfg,
                                              dtype=jnp.float32)
    model = Transformer(get_config(arch, smoke=True), device=CPU)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg, params, model


class TestNewFamiliesSlice:
    """The SSM and MoE families of this slice, module by module stacked:
    forward, prefill (logits and per-layer state), decode, greedy serving
    and the launcher, against the reference."""

    def test_layer_kinds_and_param_count(self, new_pair):
        cfg, params, model = new_pair
        kinds = {(l.kind.mixer, l.kind.ff) for l in model.layers}
        assert kinds == ({("mamba", None)} if cfg.family.value == "ssm"
                         else {("attn", "moe")})
        assert sum(p.numel() for p in model.parameters()) == \
            cfg.param_count() == sum(int(np.prod(l.shape))
                                     for l in jax.tree.leaves(params))

    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_forward_logits(self, new_pair, use_pallas):
        cfg, params, model = new_pair
        toks = _tokens((2, 24), seed=21)  # S=24: mamba pads to its chunk 16
        want, _ = _r_forward(params, cfg, jnp.asarray(toks),
                             use_pallas=use_pallas)
        got = model(torch.from_numpy(toks))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    def test_prefill_state_and_decode(self, new_pair):
        cfg, params, model = new_pair
        toks = _tokens((2, 20), seed=22)
        want, r_state = _r_prefill(params, cfg, jnp.asarray(toks[:, :16]),
                                   max_seq=32, cache_dtype=jnp.float32,
                                   use_pallas=True)
        got, state = model.prefill(torch.from_numpy(toks[:, :16]), max_seq=32,
                                   cache_dtype=torch.float32)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        assert state.step == int(r_state.step) == 16
        for i, cache in enumerate(state.caches):
            r_cache = r_state.caches[0]
            fields = (("ssm", "conv_x", "conv_bc")
                      if model.layers[i].kind.mixer == "mamba" else ("k", "v"))
            for f in fields:
                np.testing.assert_allclose(
                    _np(getattr(cache, f)), np.asarray(getattr(r_cache, f)[i]),
                    **TOL, err_msg=f"layer {i} {f}")
        for pos in range(16, 20):
            step = toks[:, pos:pos + 1]
            want, r_state = _r_decode(params, cfg, r_state, jnp.asarray(step))
            got, state = model.decode_step(state, torch.from_numpy(step))
            np.testing.assert_allclose(_np(got), np.asarray(want), **TOL,
                                       err_msg=f"position {pos}")
        assert state.step == 20

    def test_prefill_then_decode_equals_forward(self, new_pair):
        """tests/test_models.py:85-92, on the port alone."""
        cfg, params, model = new_pair
        toks = torch.from_numpy(_tokens((2, 17), seed=23))
        full = model(toks)
        logits_S, state = model.prefill(toks[:, :16], max_seq=32,
                                        cache_dtype=torch.float32)
        np.testing.assert_allclose(_np(logits_S[:, -1]), _np(full[:, 15]),
                                   atol=2e-3, rtol=1e-3)
        dec, _ = model.decode_step(state, toks[:, 16:17])
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, 16]),
                                   atol=5e-3, rtol=1e-2)

    def test_greedy_generate_tokens_identical(self, new_pair):
        cfg, params, model = new_pair
        toks = _tokens((3, 20), seed=24)
        want = RServeEngine(cfg, params, max_seq=40, use_pallas=True).generate(
            jnp.asarray(toks), max_new_tokens=12)
        got = ServeEngine(get_config(cfg.name.removesuffix("-smoke"),
                                     smoke=True), model, max_seq=40,
                          device=CPU).generate(torch.from_numpy(toks),
                                               max_new_tokens=12)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("arch", NEW_ARCHS)
    def test_launcher_main_on_cpu(self, arch, capsys):
        run = t_serve.main(["--arch", arch, "--device", "cpu",
                            "--prompt-len", "10", "--new-tokens", "4"])
        assert run.cfg.name == f"{arch}-smoke"
        assert run.tokens.shape == (4, 4)
        assert 0 <= int(run.tokens.min()) <= int(run.tokens.max()) \
            < run.cfg.vocab_size
        assert f"{arch}-smoke" in capsys.readouterr().out

    def test_launcher_bfloat16_and_fit_check(self):
        assert t_serve.parse_args(["--arch", ARCH]).dtype == "float32"
        run = t_serve.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu",
                            "--dtype", "bfloat16", "--prompt-len", "8",
                            "--new-tokens", "3"])
        assert run.engine.model.layers[0].moe.w_up.dtype == torch.bfloat16
        assert run.engine.model.layers[0].moe.router.dtype == torch.float32
        full = get_config("qwen3-moe-30b-a3b")
        assert full.param_count() * 4 > 100e9  # f32 cannot fit one card
        t_serve.check_fits(full, torch.float32, torch.device("cpu"))  # no card


def test_dense_config_with_qkv_bias_runs():
    """The DENSE family also covers qwen2 (qkv bias): shapes and finiteness."""
    cfg = get_config("qwen2-72b", smoke=True)
    assert cfg.qkv_bias
    model = Transformer(cfg, device=CPU,
                        generator=torch.Generator().manual_seed(0))
    logits = model(torch.from_numpy(_tokens((2, 8), vocab=cfg.vocab_size)))
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()


#: DENSE-family configs beyond danube: granite-34b's fc-GELU-fc MLP (tanh
#: GELU, biases), deepseek-7b, qwen2-72b (qkv bias) and the moonshot MoE
OTHER_ARCHS = ["granite-34b", "deepseek-7b", "qwen2-72b",
               "moonshot-v1-16b-a3b"]


@pytest.fixture(scope="module", params=OTHER_ARCHS)
def other_pair(request):
    """(cfg, reference params, port model) for the other configs' smoke
    versions, in float32."""
    arch = request.param
    cfg = r_get_config(arch, smoke=True)
    params = jax.jit(r_tf.init_params, static_argnums=1,
                     static_argnames="dtype")(jax.random.PRNGKey(0), cfg,
                                              dtype=jnp.float32)
    model = Transformer(get_config(arch, smoke=True), device=CPU)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg, params, model


class TestOtherConfigs:
    """Parameter count, forward and prefill logits within 5e-4 and greedy
    tokens identical to the reference, for each config of
    ``OTHER_ARCHS``."""

    def test_param_count_and_mlp(self, other_pair):
        cfg, params, model = other_pair
        assert sum(p.numel() for p in model.parameters()) == \
            cfg.param_count() == sum(int(np.prod(l.shape))
                                     for l in jax.tree.leaves(params))
        ffs = [l.ff for l in model.layers if hasattr(l, "ff")]
        if cfg.mlp_gelu:
            assert ffs and all(isinstance(f, GeluMLP) for f in ffs)
            assert {n for n, _ in ffs[0].named_parameters()} == \
                {"w1", "b1", "w2", "b2"}
        else:
            assert not any(isinstance(f, GeluMLP) for f in ffs)

    def test_forward_and_prefill_logits(self, other_pair):
        cfg, params, model = other_pair
        toks = _tokens((2, 20), seed=31, vocab=cfg.vocab_size)
        want, _ = _r_forward(params, cfg, jnp.asarray(toks), use_pallas=True)
        np.testing.assert_allclose(_np(model(torch.from_numpy(toks))),
                                   np.asarray(want), **TOL)
        want, _ = _r_prefill(params, cfg, jnp.asarray(toks), max_seq=32,
                             cache_dtype=jnp.float32, use_pallas=True)
        got, _ = model.prefill(torch.from_numpy(toks), max_seq=32,
                               cache_dtype=torch.float32)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    def test_greedy_generate_tokens_identical(self, other_pair):
        cfg, params, model = other_pair
        toks = _tokens((3, 16), seed=32, vocab=cfg.vocab_size)
        want = RServeEngine(cfg, params, max_seq=40, use_pallas=True).generate(
            jnp.asarray(toks), max_new_tokens=10)
        got = ServeEngine(get_config(cfg.name.removesuffix("-smoke"),
                                     smoke=True), model, max_seq=40,
                          device=CPU).generate(torch.from_numpy(toks),
                                               max_new_tokens=10)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gelu_mlp_is_the_tanh_approximation():
    """``GeluMLP`` computes ``jax.nn.gelu``'s default (tanh) form."""
    rng = np.random.default_rng(0)
    mlp = GeluMLP(8, 16, device=CPU,
                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mlp.b1.copy_(torch.from_numpy(rng.normal(size=16).astype(np.float32)))
        mlp.b2.copy_(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
    x = rng.normal(size=(5, 8)).astype(np.float32)
    p = {k: np.asarray(v.detach()) for k, v in mlp.named_parameters()}
    want = np.asarray(jax.nn.gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])
    np.testing.assert_allclose(_np(mlp(torch.from_numpy(x))), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m",
                                  "qwen3-moe-30b-a3b", "whisper-base",
                                  "qwen2-vl-7b", "jamba-v0.1-52b",
                                  "nemotron-3-nano-30b-a3b"])
def test_kernel_launches_counts_each_wrapper_call(arch, monkeypatch):
    """``kernel_launches`` (the exact counts the chip smoke asserts) equals
    the calls a served batch makes to each kernel wrapper, counted on the
    CPU through the plain versions the wrappers take there."""
    from repro_torch.kernels import ref as t_ref
    from repro_torch.models import kernel_launches

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
    cfg = get_config(arch, smoke=True)
    model = Transformer(cfg, device=CPU,
                        generator=torch.Generator().manual_seed(0))
    extras = {}
    if cfg.is_encoder_decoder:
        extras["encoder_frames"] = torch.as_tensor(np.random.default_rng(
            1).normal(0, 0.02, (2, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32)
    engine = ServeEngine(cfg, model, max_seq=40, device=CPU)
    engine.generate(torch.as_tensor(_tokens((2, 20), vocab=cfg.vocab_size)),
                    max_new_tokens=6, **extras)
    assert counts == kernel_launches(cfg, decode_steps=5)
