"""The port's checkpoint store (``repro_torch.checkpoint``), mirroring the
reference's ``tests/test_checkpoint.py``: round trips, atomicity (tmp and
manifest-less directories ignored), overwrite, shape and missing-leaf
errors, a whole model's parameters, restore onto a device; plus what the
port adds: bfloat16 leaves as their uint16 bits, a ``TrainState`` keyed by
``params/<name>``, ``opt/mu/<name>``, ``opt/count``, and a reference
parameter tree carried in through ``jax_tree_names`` that restores into
the port's names."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as r_ckpt  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import init_params as r_init_params  # noqa: E402

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Transformer, jax_tree_names  # noqa: E402
from repro_torch.train import adamw, init_train_state  # noqa: E402


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((2,), dtype=torch.int32)},
            "list": [torch.zeros(()), torch.full((5,), 2.5)]}


def _leaves(tree):
    from repro_torch.checkpoint.store import _flatten
    return [leaf for _, leaf in _flatten(tree)]


def _equal(a, b):
    assert len(_leaves(a)) == len(_leaves(b))
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    _equal(ckpt.restore(str(tmp_path), 7, t), t)


def test_latest_step_ignores_tmp_and_partial(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    ckpt.save(str(tmp_path), 10, t)
    os.makedirs(tmp_path / "step_99.tmp-1234")  # crashed writer
    os.makedirs(tmp_path / "step_50")  # no manifest -> partial
    assert ckpt.latest_step(str(tmp_path)) == 10
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


def test_overwrite_same_step(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    t2 = {"a": t["a"] + 1, "nested": t["nested"], "list": t["list"]}
    ckpt.save(str(tmp_path), 1, t2)
    back = ckpt.restore(str(tmp_path), 1, t)
    assert torch.equal(back["a"], t["a"] + 1)
    assert not any(".tmp-" in n for n in os.listdir(tmp_path))


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 0, {"x": torch.ones((2, 2))})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 0, {"x": torch.ones((3, 3))})


def test_missing_leaf_raises(tmp_path):
    ckpt.save(str(tmp_path), 0, {"x": torch.ones(2)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 0, {"x": torch.ones(2),
                                        "y": torch.ones(2)})


def test_model_params_roundtrip(tmp_path):
    """A whole model's parameters (jamba's hybrid stack) survive."""
    model = Transformer(get_config("jamba-v0.1-52b", smoke=True),
                        device="cpu", generator=torch.Generator().manual_seed(3))
    params = dict(model.named_parameters())
    ckpt.save(str(tmp_path), 42, params)
    _equal(ckpt.restore(str(tmp_path), 42, params),
           {k: v.detach() for k, v in params.items()})


def test_restore_places_on_the_given_device(tmp_path):
    t = {"w": np.ones((8, 4), np.float32)}
    ckpt.save(str(tmp_path), 1, t)
    back = ckpt.restore(str(tmp_path), 1, t, device="cpu")
    assert isinstance(back["w"], torch.Tensor)
    assert back["w"].device.type == "cpu"


def test_bfloat16_stored_as_bits(tmp_path):
    x = torch.randn((4, 3), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    ckpt.save(str(tmp_path), 2, {"x": x})
    with open(tmp_path / "step_2" / "manifest.json") as f:
        entry = json.load(f)["x"]
    assert entry["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_2" / entry["file"]).dtype == np.uint16
    back = ckpt.restore(str(tmp_path), 2, {"x": x})
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)


def test_train_state_paths_and_roundtrip(tmp_path):
    model = Transformer(get_config("h2o-danube-1.8b", smoke=True),
                        device="cpu", generator=torch.Generator().manual_seed(1))
    state = init_train_state({k: v.detach().clone() for k, v in
                              model.named_parameters()}, adamw(1e-3))
    state.opt.count.fill_(7)
    ckpt.save(str(tmp_path), 7, state)
    with open(tmp_path / "step_7" / "manifest.json") as f:
        keys = set(json.load(f))
    assert {"params/layers.1.attn.wq", "opt/mu/embed", "opt/nu/embed",
            "opt/count"} <= keys
    assert not any(k.startswith("ef") for k in keys)  # None holds no leaf
    back = ckpt.restore(str(tmp_path), 7, state)
    assert type(back) is type(state) and back.ef is None
    assert int(back.step) == 7 and back.opt.count.dtype == torch.int32
    _equal(back, state)


def test_reference_tree_restores_into_port_names(tmp_path):
    """A reference param tree saved by the reference store, read back by
    the reference's own restore and carried into port names, restores
    through the port's store into a port model's parameters exactly."""
    r_cfg = r_get_config("qwen3-moe-30b-a3b", smoke=True)
    params = r_init_params(jax.random.PRNGKey(3), r_cfg, dtype=jnp.float32)
    r_ckpt.save(str(tmp_path / "ref"), 1, params)
    back = r_ckpt.restore(str(tmp_path / "ref"), 1, params)
    named = {k: torch.tensor(np.asarray(v)) for k, v in jax_tree_names(
        get_config("qwen3-moe-30b-a3b", smoke=True),
        jax.tree.map(np.asarray, back)).items()}
    model = Transformer(get_config("qwen3-moe-30b-a3b", smoke=True),
                        device="cpu")
    assert set(named) == {k for k, _ in model.named_parameters()}
    ckpt.save(str(tmp_path / "port"), 1, named)
    got = ckpt.restore(str(tmp_path / "port"), 1,
                       dict(model.named_parameters()))
    _equal(got, {k: named[k] for k in got})
