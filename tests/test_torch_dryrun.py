"""The port's dry run (``repro_torch.launch.dryrun``) on meta tensors over
a fake process group: FlopCounterMode's count equals the closed form
``flop_terms`` term by term on the danube, qwen3-moe, mamba2 and whisper
smoke configs at (2, 64) (training under each remat policy, prefill,
decode); the per-device state bytes equal a hand sum of the shard
shapes; the SKIPs are the reference's; under tensor parallelism on a
(2, 2) mesh an attention block and an MLP each issue one all-reduce; the
CLI runs a cell."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro import configs as r_configs  # noqa: E402

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.configs.base import ShapeConfig, ShapeKind  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    fake_world, make_mesh, make_production_mesh)
from repro_torch.models import (  # noqa: E402
    Transformer, layer_kinds, train_paths)
from repro_torch.kernels import ops  # noqa: E402

from torch_fleet_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = ("h2o-danube-1.8b", "qwen3-moe-30b-a3b", "mamba2-780m",
            "whisper-base")
CELLS = [(ShapeKind.TRAIN, "none"), (ShapeKind.TRAIN, "dots"),
         (ShapeKind.TRAIN, "minimal"), (ShapeKind.PREFILL, "none"),
         (ShapeKind.DECODE, "none")]


@pytest.fixture
def mesh22():
    with fake_world(4):
        yield make_mesh(2, 2, device="cpu")


@pytest.mark.parametrize("kind,remat", CELLS,
                         ids=[f"{k.value}-{r}" for k, r in CELLS])
@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_equal_the_closed_form_term_by_term(arch, kind, remat):
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("smoke", kind, 64, 2)
    got = dryrun.count_flops(cfg, shape, remat=remat)
    terms = dryrun.flop_terms(cfg, shape, remat=remat)
    assert got == sum(terms.values()), terms
    assert terms["weights"] > 0 and terms["attention"] + terms[
        "ssd_chunks"] > 0
    if kind != ShapeKind.TRAIN or remat == "none":
        assert terms["remat_recompute"] == 0
    else:
        assert terms["remat_recompute"] > 0


def test_microbatches_split_the_same_work():
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    shape = ShapeConfig("smoke", ShapeKind.TRAIN, 64, 4)
    assert dryrun.count_flops(cfg, shape, microbatches=2) == \
        dryrun.count_flops(cfg, shape)


def test_the_closed_form_weights_term_is_6_n_tokens():
    """For a dense model the weights term is 6 x the weight matrices'
    elements x the tokens, the 6·N·D rule."""
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = Transformer(cfg, device="meta")
    n = sum(p.numel() for name, p in model.named_parameters()
            if p.ndim == 2 and name != "embed")
    shape = ShapeConfig("smoke", ShapeKind.TRAIN, 64, 2)
    assert dryrun.flop_terms(cfg, shape)["weights"] == 6 * n * 128


def test_count_runs_no_kernel():
    ops.reset_launches()
    dryrun.count_flops(get_config("mamba2-780m", smoke=True),
                       ShapeConfig("smoke", ShapeKind.PREFILL, 64, 2))
    assert not any(ops.LAUNCHES.values())


def _hand_bytes(cfg, shape, sizes, train):
    """Each parameter's local numel by hand: a weight matrix splits over
    model (its column-parallel or row-parallel dim) and, training, over
    data (FSDP on the other dim), an expert stack over model by expert
    and over data on d, each where it divides."""
    dp, tp = sizes["data"], sizes["model"]
    model = Transformer(cfg, device="meta", dtype=getattr(torch, cfg.dtype))
    col = ("wq", "wk", "wv", "w_gate", "w_up", "w1", "z_proj", "x_proj",
           "dt_proj", "lm_head")
    row = ("wo", "w_down", "w2", "out_proj", "embed")
    total = 4 if train else 0
    for name, p in model.named_parameters():
        key = name.rsplit(".", 1)[-1]
        shp = list(p.shape)
        if p.ndim == 2 and key in col + row:
            m_dim = 1 if key in col else 0
            if shp[m_dim] % tp == 0:
                shp[m_dim] //= tp
            if train and p.shape[1 - m_dim] % dp == 0:
                shp[1 - m_dim] //= dp
        elif key == "bc_proj":  # the B/C streams: FSDP only
            if train and shp[0] % dp == 0:
                shp[0] //= dp
        elif key == "conv_x_w":  # (K, d_inner): channels over model
            if shp[1] % tp == 0:
                shp[1] //= tp
        elif p.ndim == 3:  # experts over model, FSDP on d
            if shp[0] % tp == 0:
                shp[0] //= tp
            if train and shp[1] % dp == 0:
                shp[1] //= dp
        elif p.ndim == 1 and key in ("bq", "bk", "bv", "b1", "A_log", "D",
                                     "dt_bias", "norm_scale", "conv_x_b"):
            if shp[0] % tp == 0:
                shp[0] //= tp
        n = math.prod(shp)
        total += n * (2 * p.element_size() + 8 if train
                      else p.element_size())
    return total


@pytest.mark.parametrize("arch", FAMILIES)
def test_state_bytes_equal_a_hand_sum_of_the_shards(arch):
    cfg = get_config(arch, smoke=True)
    sizes = {"data": 2, "model": 2}
    train = ShapeConfig("t", ShapeKind.TRAIN, 64, 4)
    assert dryrun.state_bytes_per_device(cfg, train, sizes) == \
        _hand_bytes(cfg, train, sizes, True)
    # int8 compression: one float32 residual a weight shard
    plus = dryrun.state_bytes_per_device(cfg, train, sizes,
                                         compression="int8")
    assert plus > _hand_bytes(cfg, train, sizes, True)
    dec = ShapeConfig("d", ShapeKind.DECODE, 64, 4)
    caches = 0
    state = Transformer(cfg, device="meta").init_decode_state(
        4, 64, encoder_frames=(torch.empty((4, cfg.encoder_seq, cfg.d_model),
                                           device="meta")
                               if cfg.is_encoder_decoder else None),
        kernels=train_paths(cfg))
    for c in state.caches:
        for t in vars(c).values():
            if isinstance(t, torch.Tensor):
                caches += t.numel() // 2 * t.element_size()  # batch / data
    for kv in state.cross_kv:
        if kv is not None:
            caches += sum(t.numel() // 2 * 2 for t in kv)  # bfloat16
    assert dryrun.state_bytes_per_device(cfg, dec, sizes) == \
        _hand_bytes(cfg, dec, sizes, False) + caches


def test_skips_are_the_reference_s(mesh22):
    for arch in r_configs.ARCH_IDS:
        for sid in r_configs.SHAPE_IDS:
            ok, why = r_configs.cell_supported(r_configs.get_config(arch),
                                               r_configs.get_shape(sid))
            if ok:
                continue
            res = dryrun.lower_cell(arch, sid, mesh22)
            assert not res.ok and res.error == "SKIP: " + why
            assert res.mesh == "2x2"


def test_one_all_reduce_per_attention_block_and_mlp(mesh22):
    """danube smoke on (data 2, model 2): a prefill or a decode step
    issues one all-reduce per attention block, one per MLP and one for
    the vocab-parallel embedding, and nothing else."""
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    for kind in (ShapeKind.PREFILL, ShapeKind.DECODE):
        got = dryrun.collective_cost(cfg, ShapeConfig("s", kind, 64, 4),
                                     mesh22)["counts"]
        assert got == {"all_reduce": 2 * cfg.n_layers + 1, "all_gather": 0,
                       "reduce_scatter": 0, "all_to_all": 0}


def test_training_collectives_on_a_2x2_mesh(mesh22):
    """Training without remat: per layer the two forward all-reduces, the
    two backward ones of the column-parallel inputs and one per norm
    scale's gradient (replicated over data); every FSDP-sharded weight
    gathered once and its gradient reduce-scattered."""
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    shape = ShapeConfig("t", ShapeKind.TRAIN, 64, 4)
    got = dryrun.collective_cost(cfg, shape, mesh22, remat="none")["counts"]
    n_fsdp = 7 * cfg.n_layers + 2  # q k v o gate up down, embed, lm_head
    # embed + head: lookup, max, sum, gold, the head input's gradient
    assert got["all_reduce"] == 6 * cfg.n_layers + 5
    assert got["all_gather"] == got["reduce_scatter"] == n_fsdp
    remat = dryrun.collective_cost(cfg, shape, mesh22,
                                   remat="minimal")["counts"]
    assert remat["all_reduce"] > got["all_reduce"]


@pytest.mark.parametrize("arch", ("qwen3-moe-30b-a3b", "mamba2-780m",
                                  "whisper-base", "jamba-v0.1-52b",
                                  "qwen2-vl-7b"))
def test_every_family_counts_on_the_production_mesh(arch):
    """Each layer kind runs sharded on the 16 x 16 mesh at full width."""
    cfg = get_config(arch)
    with fake_world(256):
        mesh = make_production_mesh(device="cpu")
        got = dryrun.collective_cost(cfg, get_shape("decode_32k"),
                                     mesh)["counts"]
    kinds = layer_kinds(cfg)
    n_blocks = sum(1 + (k.ff is not None) + k.cross_attn
                   for k in kinds) * (cfg.n_layers // len(kinds))
    embed = int(cfg.vocab_size % 16 == 0)
    assert got["all_reduce"] == n_blocks + embed


def test_main_runs_a_cell(capsys):
    assert dryrun.main(["--arch", "mamba2-780m", "--shape",
                        "decode_32k"]) == 0
    out = capsys.readouterr().out
    assert "mamba2-780m" in out and "1 cells, 0 failures" in out


def test_main_reports_a_skip(capsys):
    assert dryrun.main(["--arch", "deepseek-7b", "--shape", "long_500k",
                        "--both-meshes"]) == 0
    out = capsys.readouterr().out
    assert out.count("FAIL SKIP: full attention") == 2
    assert "2 cells, 0 failures" in out
