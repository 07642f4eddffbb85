"""The port's data pipeline against the reference's (``repro.data``):
``jax.random``'s threefry keys, splits, bits, uniforms and integers
reproduced bit for bit by ``repro_torch.data.threefry``; the successor
table and ``batch_for``'s tokens and labels bit-identical on a (vocab,
seed, step, shard, n_shards) matrix; the stub-frontend gaussians of
whisper and qwen2-vl within ``NORMAL_ULP`` ulp (numpy's ``log1p`` in the
inverse error function is not XLA's)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs.base import ShapeConfig, ShapeKind  # noqa: E402
from repro.data import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.data import batch_for as r_batch_for  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM, batch_for, threefry  # noqa: E402

NORMAL_ULP = 4
#: (arch, vocab override, seed, step, shard, n_shards, seq_len, batch)
MATRIX = [("h2o-danube-1.8b", None, 0, 0, 0, 1, 32, 4),
          ("h2o-danube-1.8b", 32000, 3, 7, 2, 4, 48, 8),
          ("mamba2-780m", 50280, 0, 11, 1, 2, 64, 4),
          ("deepseek-7b", None, 5, 3, 0, 2, 16, 8),
          ("qwen3-moe-30b-a3b", 151936, 1, 2, 3, 4, 24, 8),
          ("whisper-base", None, 0, 4, 1, 2, 32, 4),
          ("qwen2-vl-7b", None, 2, 1, 0, 1, 40, 2)]


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


class TestThreefry:
    @pytest.mark.parametrize("seed,data", [(0, 0), (3, 7), (2 ** 31 - 1, 99),
                                           (42, 0xC0FFEE)])
    def test_keys_and_splits_bit_identical(self, seed, data):
        key = jax.random.PRNGKey(seed)
        assert np.array_equal(np.asarray(key), threefry.prng_key(seed))
        folded = jax.random.fold_in(key, data)
        mine = threefry.fold_in(threefry.prng_key(seed), data)
        assert np.array_equal(np.asarray(folded), mine)
        for num in (2, 3):
            assert np.array_equal(np.asarray(jax.random.split(folded, num)),
                                  threefry.split(mine, num))

    @pytest.mark.parametrize("shape", [(1,), (5, 7), (3, 4, 5)])
    def test_draws_bit_identical(self, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(9), 4)
        k = np.asarray(key)
        assert np.array_equal(np.asarray(jax.random.uniform(key, shape)),
                              threefry.uniform(k, shape))
        for lo, hi in ((0, 16), (3, 1000), (0, 7)):
            assert np.array_equal(
                np.asarray(jax.random.randint(key, shape, lo, hi)),
                threefry.randint(k, shape, lo, hi))
        assert _ulp(np.asarray(jax.random.normal(key, shape)),
                    threefry.normal(k, shape)) <= NORMAL_ULP

    def test_normal_ulp_bound_on_many_draws(self):
        key = jax.random.PRNGKey(11)
        want = np.asarray(jax.random.normal(key, (200, 257)))
        got = threefry.normal(np.asarray(key), (200, 257))
        assert _ulp(want, got) <= NORMAL_ULP
        assert np.mean(want == got) > 0.9


class TestPipeline:
    @pytest.mark.parametrize("vocab", [64, 256, 32000, 50280])
    def test_successor_table_bit_identical(self, vocab):
        want = np.asarray(RSyntheticLM(vocab=vocab, seed=1)
                          .transition_successors())
        assert np.array_equal(
            SyntheticLM(vocab=vocab, seed=1).transition_successors(), want)

    @pytest.mark.parametrize("case", MATRIX, ids=lambda c: f"{c[0]}-{c[1]}")
    def test_batch_bit_identical(self, case):
        arch, vocab, seed, step, shard, n_shards, seq, batch = case
        r_cfg, cfg = r_get_config(arch, smoke=True), get_config(arch,
                                                                smoke=True)
        shape = ShapeConfig("t", ShapeKind.TRAIN, seq, batch)
        kw = dict(step=step, shard=shard, n_shards=n_shards)
        want = r_batch_for(r_cfg, shape, lang=RSyntheticLM(
            vocab=vocab or r_cfg.vocab_size, seed=seed), **kw)
        got = batch_for(cfg, shape, lang=SyntheticLM(
            vocab=vocab or cfg.vocab_size, seed=seed), **kw)
        assert set(got) == set(want)
        for k in ("tokens", "labels", "positions"):
            if k in want:
                assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert got["tokens"].shape == (batch // n_shards, seq)
        for k in ("patch_embeds", "encoder_frames"):
            if k in want:
                assert got[k].dtype == torch.float32
                assert _ulp(got[k].numpy(), np.asarray(want[k])) <= \
                    NORMAL_ULP, k

    def test_stub_dtype_and_device(self):
        cfg = get_config("whisper-base", smoke=True)
        b = batch_for(cfg, ShapeConfig("t", ShapeKind.TRAIN, 16, 2), step=0,
                      dtype=torch.bfloat16, device="cpu")
        assert b["encoder_frames"].dtype == torch.bfloat16
        assert b["tokens"].dtype == torch.long
        r = r_batch_for(r_get_config("whisper-base", smoke=True),
                        ShapeConfig("t", ShapeKind.TRAIN, 16, 2), step=0,
                        dtype=jnp.bfloat16)
        np.testing.assert_allclose(
            b["encoder_frames"].float().numpy(),
            np.asarray(r["encoder_frames"].astype(jnp.float32)), rtol=8e-3)

    def test_shards_differ_and_split_refused(self):
        cfg = get_config("deepseek-7b", smoke=True)
        shape = ShapeConfig("t", ShapeKind.TRAIN, 16, 8)
        s0 = batch_for(cfg, shape, step=3, shard=0, n_shards=2)
        s1 = batch_for(cfg, shape, step=3, shard=1, n_shards=2)
        assert s0["tokens"].shape[0] == 4
        assert not torch.equal(s0["tokens"], s1["tokens"])
        with pytest.raises(ValueError, match="does not split"):
            batch_for(cfg, shape, step=0, n_shards=3)

    def test_language_is_learnable_structure(self):
        lang = SyntheticLM(vocab=64)
        toks = lang.sample_tokens(0, 0, 8, 128)
        succ = lang.transition_successors()
        for row in toks:
            for a, b in zip(row[:-1], row[1:]):
                assert b in succ[a]

    def test_powf_consulted_only_near_an_integer(self):
        """The cube goes to the C library's powf only where a neighbouring
        float32 truncates to another id, and the ids then equal the
        reference's float32 ``vocab * u ** 3.0`` everywhere."""
        from repro_torch.data.pipeline import zipf_ids

        u = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (50000,)))
        want = np.clip(np.asarray(
            (32000 * jnp.asarray(u) ** 3.0).astype(jnp.int32)), 0, 31999)
        assert np.array_equal(zipf_ids(u, 32000), want)
