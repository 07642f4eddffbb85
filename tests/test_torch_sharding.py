"""The port's partition rules (``repro_torch.sharding``) and meshes
(``repro_torch.launch.mesh``) against the reference's: the cases of
``tests/test_sharding_dryrun.py``'s ``TestRules`` and ``TestDivisibility``
on tuples of axis names; every parameter leaf's spec of the ten smoke and
the ten full configs, with and without ``fsdp``, on both production
meshes, equal to the reference's with the leading ``None`` of a stacked
leaf dropped; the batch and decode-state specs of the full configs at the
four shapes; and the placements on a ``fake_world`` mesh."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.sharding import rules as r_rules  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import block_period, jax_tree_names  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    MeshAxes, batch_sharding, decode_state_sharding, enforce_divisible,
    local_shape, logical_param_spec, param_shardings, placements, spec_tree)
from repro_torch.sharding.rules import axis_sizes  # noqa: E402

from torch.distributed.tensor import (  # noqa: E402
    Replicate, Shard, distribute_tensor)

M = MeshAxes()
ARCHS = r_configs.ARCH_IDS
SHAPES = r_configs.SHAPE_IDS
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """What the reference's rules read of a mesh: axis names and sizes."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


@pytest.fixture
def r_specs(monkeypatch):
    """The reference's rule functions returning bare specs: its
    ``NamedSharding`` needs a device per mesh slot, the rules do not."""
    monkeypatch.setattr(r_rules, "NamedSharding", lambda mesh, spec: spec)
    return r_rules


class TestRules:
    def test_attention_tp_pattern(self):
        assert logical_param_spec("wq", 2, M) == (None, "model")
        assert logical_param_spec("wo", 2, M) == ("model", None)

    def test_mlp_pattern(self):
        assert logical_param_spec("w_gate", 2, M) == (None, "model")
        assert logical_param_spec("w_down", 2, M) == ("model", None)

    def test_moe_expert_parallel(self):
        assert logical_param_spec("w_gate", 3, M) == ("model", None, None)
        assert logical_param_spec("router", 2, M) == ()

    def test_mamba_head_parallel(self):
        assert logical_param_spec("x_proj", 2, M) == (None, "model")
        assert logical_param_spec("bc_proj", 2, M) in ((), (None, None))
        assert logical_param_spec("out_proj", 2, M) == ("model", None)

    def test_embedding_vocab_parallel(self):
        assert logical_param_spec("embed", 2, M) == ("model", None)
        assert logical_param_spec("lm_head", 2, M) == (None, "model")

    def test_unstacked_blocks_get_no_leading_none(self):
        specs = spec_tree(t_configs.param_specs(
            t_configs.get_config("deepseek-7b", smoke=True)), M)
        assert specs["layers.0.attn.wq"] == (None, "model")

    def test_every_leaf_has_a_spec(self):
        for arch in ("jamba-v0.1-52b", "whisper-base", "qwen2-vl-7b"):
            params = t_configs.param_specs(t_configs.get_config(arch,
                                                                smoke=True))
            assert set(spec_tree(params, M)) == set(params)

    @pytest.mark.parametrize("fsdp", [None, "data"])
    def test_every_key_as_the_reference(self, fsdp):
        keys = ("embed", "lm_head", "pos_embed", "wq", "wk", "wv", "wo",
                "bq", "bk", "bv", "w_gate", "w_up", "w_down", "w1", "b1",
                "w2", "b2", "router", "z_proj", "x_proj", "dt_proj",
                "bc_proj", "conv_x_w", "conv_x_b", "conv_bc_w", "conv_bc_b",
                "A_log", "D", "dt_bias", "norm_scale", "out_proj", "scale",
                "anything")
        m, rm = MeshAxes(fsdp=fsdp), r_rules.MeshAxes(fsdp=fsdp)
        for key in keys:
            for ndim in (1, 2, 3):
                assert logical_param_spec(key, ndim, m) == tuple(
                    r_rules.logical_param_spec(key, ndim, rm)), (key, ndim)


class TestDivisibility:
    def test_divisible_kept(self):
        assert enforce_divisible({"model": 1}, ("model", None), (7, 3)) == \
            ("model", None)

    def test_nondivisible_dropped(self):
        mesh = {"data": 16, "model": 16}
        assert enforce_divisible(mesh, ("data", None), (1, 8)) == (None, None)
        assert enforce_divisible(mesh, ("model", None), (50280, 8)) == \
            (None, None)
        assert enforce_divisible(mesh, ("model", None), (50176, 8)) == \
            ("model", None)

    def test_tuple_axes(self):
        mesh = {"pod": 2, "data": 16}
        assert enforce_divisible(mesh, (("pod", "data"),), (64,)) == \
            (("pod", "data"),)
        assert enforce_divisible(mesh, (("pod", "data"),), (16,)) == (None,)

    def test_as_the_reference(self):
        cases = [(("model", None), (50280, 8)), (("data", "model"), (32, 48)),
                 ((("pod", "data"), None), (64, 3)), ((), (5,)),
                 ((("pod", "data"), "model"), (16, 16))]
        for sizes in MESHES.values():
            for spec, shape in cases:
                if not set(a for s in spec if s for a in
                           (s if isinstance(s, tuple) else (s,))) <= set(sizes):
                    continue
                assert enforce_divisible(sizes, spec, shape) == tuple(
                    r_rules.enforce_divisible(FakeMesh(sizes), P(*spec),
                                              shape))


def _reference_param_specs(r_specs, cfg, sizes, fsdp: bool) -> dict:
    """{port name: spec} from the reference's ``param_shardings``: each
    stacked leaf's spec loses its leading None (asserted) and is handed
    to ``jax_tree_names`` as an object array over the stacked axis."""
    params = r_configs.param_specs(cfg)
    specs = r_specs.param_shardings(FakeMesh(sizes), params, fsdp=fsdp)

    def unstack(spec, leaf):
        arr = np.empty(leaf.shape[0], object)
        assert spec[0] is None
        arr[:] = [tuple(spec)[1:]] * leaf.shape[0]
        return arr

    tree = dict(specs)
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    tree["blocks"] = [jax.tree.map(unstack, b, pb, is_leaf=is_p)
                      for b, pb in zip(specs["blocks"], params["blocks"])]
    if "encoder" in specs:
        tree["encoder"] = dict(specs["encoder"], blocks=jax.tree.map(
            unstack, specs["encoder"]["blocks"],
            params["encoder"]["blocks"], is_leaf=is_p))
    return {name: tuple(s) for name, s in jax_tree_names(cfg, tree).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(r_specs, arch, smoke, fsdp, mesh):
    sizes = MESHES[mesh]
    want = _reference_param_specs(r_specs, r_configs.get_config(
        arch, smoke=smoke), sizes, fsdp)
    got = param_shardings(sizes, t_configs.param_specs(
        t_configs.get_config(arch, smoke=smoke)), fsdp=fsdp)
    assert got == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_specs_equal_the_reference(r_specs, arch, shape):
    r_cfg, r_shape = r_configs.get_config(arch), r_configs.get_shape(shape)
    t_cfg, t_shape = t_configs.get_config(arch), t_configs.get_shape(shape)
    for sizes in MESHES.values():
        fm = FakeMesh(sizes)
        want = r_specs.batch_sharding(fm, r_configs.batch_specs(r_cfg,
                                                                r_shape))
        got = batch_sharding(sizes, t_configs.batch_specs(t_cfg, t_shape))
        assert got == {k: tuple(v) for k, v in want.items()}

        r_state, _ = r_configs.decode_specs(r_cfg, r_shape)
        state, _ = t_configs.decode_specs(t_cfg, t_shape)
        r_tree = r_specs.decode_state_sharding(fm, r_state)
        period = block_period(r_cfg)
        want = {}
        for path, spec in jax.tree_util.tree_flatten_with_path(
                r_tree, is_leaf=lambda x: isinstance(x, P))[0]:
            # .caches[j].k / .cross_kv[j][0] / .step
            parts = jax.tree_util.keystr(path).strip(".").replace(
                "]", "").replace("[", ".").split(".")
            if parts[0] == "step" or parts[-1] == "length":
                continue
            j = int(parts[1])
            assert spec[0] is None
            for s in range(r_cfg.n_layers // period):
                want[".".join([parts[0], str(s * period + j)] + parts[2:])] = \
                    tuple(spec)[1:]
        assert decode_state_sharding(sizes, state) == want


def test_placements_and_shards_on_a_fake_world():
    """The 512-rank two-pod mesh of one process: a meta (8192, 29568)
    bfloat16 column-parallel weight (qwen2-72b's ``w_gate``) holds a
    (8192, 1848) shard; a data-sharded batch shards over pod and data."""
    with t_mesh.fake_world(512):
        mesh = t_mesh.make_production_mesh(multi_pod=True, device="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert axis_sizes(mesh) == MESHES["2x16x16"]
        assert t_mesh.data_axes(mesh) == ("pod", "data")
        assert t_mesh.mesh_name(mesh) == "2x16x16"
        spec = logical_param_spec("w_gate", 2, MeshAxes.for_mesh(mesh))
        pl = placements(mesh, spec)
        assert pl == [Replicate(), Replicate(), Shard(1)]
        w = torch.empty((8192, 29568), dtype=torch.bfloat16, device="meta")
        dt = distribute_tensor(w, mesh, pl)
        assert tuple(dt.to_local().shape) == (8192, 1848) == local_shape(
            mesh, spec, (8192, 29568))
        bspec = batch_sharding(mesh, {"tokens": torch.empty(
            (64, 8), device="meta")})["tokens"]
        assert placements(mesh, bspec) == [Shard(0), Shard(0), Replicate()]
        assert local_shape(mesh, bspec, (64, 8)) == (2, 8)
        fsdp = MeshAxes.for_mesh(mesh, fsdp=True)
        assert fsdp.fsdp == "data"
        assert placements(mesh, logical_param_spec("wo", 2, fsdp)) == [
            Replicate(), Shard(1), Shard(0)]
    with t_mesh.fake_world(256):
        mesh = t_mesh.make_production_mesh(device="cpu")
        assert t_mesh.mesh_name(mesh) == "16x16"
        assert t_mesh.data_axes(mesh) == ("data",)
    with t_mesh.fake_world(8):
        assert t_mesh.mesh_name(t_mesh.make_mesh(2, 2, 2, device="cpu")) == \
            "2x2x2"


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with t_mesh.fake_world(4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_mesh.make_mesh(2, 2)
