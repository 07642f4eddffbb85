"""The port's per-device accounting (``repro_torch.launch.costs``,
``dryrun.device_cost`` / ``collective_cost``) and its roofline
(``repro_torch.launch.roofline``), on the CPU: ``model_flops`` and
``analyze`` (at the TPU v5e's rates) against ``benchmarks/roofline.py``;
``DeviceCostMode`` on hand-sized ops; on the smoke configs the per-device
FLOPs equal ``count_flops`` on a (1, 1) mesh, the depth-extended count
equals the whole step's, and on a (2, 2) mesh the collective bytes
follow the counts; the rendered tables have one row per cell."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from benchmarks import roofline as r_roofline  # noqa: E402
from repro import configs as r_configs  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, ShapeKind  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.costs import DeviceCostMode  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402

from torch_fleet_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = ("h2o-danube-1.8b", "qwen3-moe-30b-a3b", "mamba2-780m",
            "whisper-base")
KINDS = [(ShapeKind.TRAIN, "dots"), (ShapeKind.TRAIN, "minimal"),
         (ShapeKind.PREFILL, "none"), (ShapeKind.DECODE, "none")]
CELLS = [KINDS[0], *KINDS[2:]]
ONE = {"data": 1, "model": 1}
# the reference's rates: every cell at the bf16 peak, every collective
# over one 50 GB/s link
TPU_V5E = roofline.Rates(name="TPU v5e", bf16_flops=197e12,
                         f32_flops=197e12, hbm=819e9, intra_node=50e9,
                         inter_node=50e9, devices_per_node=1)


@pytest.fixture
def mesh22():
    with fake_world(4):
        yield make_mesh(2, 2, device="cpu")


@pytest.mark.parametrize("arch", r_configs.ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    for sid in r_configs.SHAPE_IDS:
        assert roofline.model_flops(arch, sid) == \
            r_roofline.model_flops(arch, sid)


def _records(arch, shape, mesh, flops, hbm, groups, peak):
    """(the port's record, the reference's) of the same cell."""
    port = {"ok": True, "arch": arch, "shape": shape, "mesh": mesh,
            "dtype": "bfloat16", "flops_per_device": flops,
            "bytes_accessed": hbm, "peak_mem_per_device": peak,
            "collective_groups": [{"kind": k, "size": 16, "span": span,
                                   "bytes": b} for k, span, b in groups]}
    ref = {"ok": True, "arch": arch, "shape": shape, "mesh": mesh,
           "flops": flops, "hlo_bytes": hbm, "peak_mem_per_device": peak,
           "collectives": {"total": sum(b for *_, b in groups)}}
    return port, ref


@pytest.mark.parametrize("case", [
    ("qwen2-72b", "train_4k", "16x16", 2.85e15, 3.46e13,
     [("all_reduce", [0, 15], 3.2e11), ("all_gather", [0, 240], 1.1e11),
      ("reduce_scatter", [0, 240], 1.1e11)], 2.9e11),
    ("mamba2-780m", "decode_32k", "2x16x16", 1.5e11, 7.5e8,
     [("all_reduce", [0, 15], 1.18e6), ("all_reduce", [0, 256], 4096)],
     9.6e8),
    ("jamba-v0.1-52b", "prefill_32k", "16x16", 1.4e14, 2.2e12, [], 1.9e10),
    ("h2o-danube-1.8b", "train_4k", "16x16", 1e15, 1e12,
     [("all_reduce", [0, 15], 1e10)], 1e10),  # bound by compute
    ("granite-34b", "decode_32k", "16x16", 1e12, 1e9,
     [("all_gather", [0, 240], 1e11)], 1e9),  # bound by the collective
], ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_analyze_at_tpu_rates_equals_the_reference(case):
    """Field by field, but for the bound's name: the port's memory term is
    eager bytes, a ceiling, and a cell it bounds is ``eager-memory``."""
    port, ref = _records(*case)
    got = dataclasses.asdict(roofline.analyze(port, TPU_V5E))
    want = dataclasses.asdict(r_roofline.analyze(ref))
    assert got.pop("dtype") == "bfloat16"
    eager = {"memory": "eager-memory"}
    want["bottleneck"] = eager.get(want["bottleneck"], want["bottleneck"])
    assert got == want
    assert roofline.analyze(port, TPU_V5E).derived() == \
        r_roofline.analyze(ref).derived().replace("bound=memory",
                                                  "bound=eager-memory")
    assert roofline.analyze(dict(port, ok=False)) is None


def test_h100_prices_each_group_on_its_link():
    """A group inside one 8-GPU node takes NVLink, any other the NIC: on
    the production meshes every group spans nodes."""
    h = roofline.H100_SXM
    assert h.link([0, 7]) == 450e9 and h.link([0, 15]) == 50e9
    assert h.link([0, 240]) == h.link([0, 256]) == 50e9
    port, _ = _records("h2o-danube-1.8b", "train_4k", "16x16", 1e12, 1e9,
                       [("all_reduce", [0, 7], 9e9),
                        ("all_gather", [0, 240], 1e9)], 1e9)
    row = roofline.analyze(port)
    assert row.t_collective == pytest.approx(9e9 / 450e9 + 1e9 / 50e9)
    assert row.t_compute == 1e12 / 989e12 and row.t_memory == 1e9 / 3.35e12


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_cost_mode_on_hand_sized_ops(device):
    m, k, n = 8, 16, 4
    a = torch.empty(m, k, device=device)
    b = torch.empty(k, n, device=device)
    with DeviceCostMode() as c:
        a @ b
    assert c.bytes_accessed == (m * k + k * n + m * n) * 4
    assert c.flops == 2 * m * k * n
    with DeviceCostMode() as c:
        a.view(k, m), a.transpose(0, 1), a.T, a.detach(), a.expand(2, m, k)
    assert c.bytes_accessed == 0 and c.peak_live_bytes == 0
    with DeviceCostMode() as c:
        a + a
    assert c.bytes_accessed == 3 * m * k * 4
    with DeviceCostMode() as c:
        a.mul_(2.0)  # in place: read and written
    assert c.bytes_accessed == 2 * m * k * 4 and c.peak_live_bytes == 0


def test_peak_of_a_chain_that_frees_its_temporaries():
    a = torch.empty(64, 64, device="meta")  # 16 KiB, made outside
    size = 64 * 64 * 4
    with DeviceCostMode() as c:
        x = a * 2  # 1 alive
        y = x + 1  # 2
        del x  # 1
        z = y.exp()  # 2
        w = z.view(-1)  # a view: no storage of its own
        del y  # 1
        c.mark()
        t = torch.cat([w, w])  # 1 + 2
        del t, w, z  # 0
        c.mark()
    assert c.peak_live_bytes == 3 * size
    assert c.phase_peaks == [2 * size, 3 * size]
    assert c.live_bytes == 0


def test_functional_collectives_count_their_bytes_by_kind():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with fake_world(8):
        mesh = make_mesh(2, 4, device="cpu")
        t = torch.empty(16, 256, dtype=torch.bfloat16, device="meta")

        def move(src, dst):
            return DTensor.from_local(t, mesh, src, run_check=False
                                      ).redistribute(mesh, dst).to_local()

        with DeviceCostMode() as c:
            r = move([Replicate(), Partial()], [Replicate(), Replicate()])
            g = move([Shard(0), Replicate()], [Replicate(), Replicate()])
            s = move([Partial(), Replicate()], [Shard(0), Replicate()])
    assert (r.shape, g.shape, s.shape) == ((16, 256), (32, 256), (8, 256))
    assert dict(c.collective_bytes) == {"all_reduce": 8192,
                                        "all_gather": 16384,
                                        "reduce_scatter": 8192}
    assert dict(c.collective_counts) == {"all_reduce": 1, "all_gather": 1,
                                         "reduce_scatter": 1}
    # the model axis's group is ranks 0-3, the data axis's ranks 0 and 4
    assert dict(c.collective_groups) == {
        ("all_reduce", 4, 0, 3): 8192, ("all_gather", 2, 0, 4): 16384,
        ("reduce_scatter", 2, 0, 4): 8192}
    assert c.bytes_accessed == 0


@pytest.mark.parametrize("kind,remat", CELLS,
                         ids=[f"{k.value}-{r}" for k, r in CELLS])
@pytest.mark.parametrize("arch", FAMILIES)
def test_one_device_of_a_1x1_mesh_counts_the_global_step(arch, kind, remat):
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("smoke", kind, 64, 2)
    got = dryrun.device_cost(cfg, shape, ONE, remat=remat)
    assert got["flops_per_device"] == dryrun.count_flops(cfg, shape,
                                                         remat=remat)
    assert got["bytes_accessed"] > 0
    assert got["peak_mem_per_device"] >= dryrun.state_bytes_per_device(
        cfg, shape, ONE)
    with fake_world(1):
        coll = dryrun.collective_cost(cfg, shape, make_mesh(1, 1,
                                                            device="cpu"),
                                      remat=remat)
    assert coll["bytes"]["total"] == 0 and coll["groups"] == []


@pytest.mark.parametrize("arch", FAMILIES)
def test_a_step_on_cpu_tensors_counts_the_meta_count(arch):
    """``chip_smoke.py``'s card check at smoke size on the CPU: the same
    ``device_step`` with its AdamW update on real tensors counts the meta
    count's FLOPs and bytes, and the state, inputs and buffers it holds
    plus the mode's peak make ``peak_mem_per_device``."""
    from repro_torch.configs import batch_specs
    from repro_torch.data import batch_for
    from repro_torch.launch.costs import nbytes
    from repro_torch.models import Transformer
    from repro_torch.train import init_train_state

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    shape = ShapeConfig("smoke", ShapeKind.TRAIN, 16, 2)
    meta = dryrun.device_cost(cfg, shape, ONE, remat="dots")
    model = Transformer(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    opt = dryrun.step_optimizer()
    state = init_train_state(dict(model.named_parameters()), opt)
    spec = batch_specs(cfg, shape)
    batch = {k: v.to(spec[k].dtype)
             for k, v in batch_for(cfg, shape, step=0).items()}
    assert batch.keys() == spec.keys()
    with DeviceCostMode() as cost:
        dryrun.device_step(model, "train", batch, state=state, opt=opt,
                           remat="dots")
    held = sum(map(nbytes, [*state.params.values(), *state.opt.mu.values(),
                            *state.opt.nu.values(), state.opt.count,
                            *batch.values(), *model.buffers()]))
    assert cost.flops == meta["flops_per_device"]
    assert cost.bytes_accessed == meta["bytes_accessed"]
    assert held + cost.peak_live_bytes == meta["peak_mem_per_device"]


DEPTHS = [("h2o-danube-1.8b", 5, k, r) for k, r in KINDS] + [
    ("whisper-base", 4, k, r) for k, r in KINDS] + [
    ("jamba-v0.1-52b", 32, ShapeKind.PREFILL, "none")]


@pytest.mark.parametrize("arch,layers,kind,remat", DEPTHS,
                         ids=[f"{a}-{n}-{k.value}-{r}"
                              for a, n, k, r in DEPTHS])
def test_the_depth_extended_count_is_the_whole_step(arch, layers, kind,
                                                    remat):
    """``device_cost`` counts two and three super-blocks and extends them
    to the depth: the same FLOPs, bytes and peak as one whole step
    (jamba: four super-blocks of eight layers)."""
    base = get_config(arch, smoke=True)
    cfg = dataclasses.replace(base, n_layers=layers, n_encoder_layers=(
        layers if base.is_encoder_decoder else 0))
    shape = ShapeConfig("smoke", kind, 64, 2)
    got = dryrun.device_cost(cfg, shape, ONE, remat=remat)
    cost, inputs = dryrun._step_cost(cfg, cfg, shape, shape, ONE,
                                     remat=remat, microbatches=1)
    resident = dryrun.state_bytes_per_device(cfg, shape, ONE) - sum(
        v for k, v in dryrun._state_parts(cfg, shape, ONE).items()
        if k in dryrun._MADE_BY_STEP[dryrun.cell_kind(shape)])
    assert got == {"flops_per_device": cost.flops,
                   "bytes_accessed": cost.bytes_accessed,
                   "peak_mem_per_device": resident + inputs
                   + cost.peak_live_bytes}


def test_microbatches_count_their_steps():
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    shape = ShapeConfig("smoke", ShapeKind.TRAIN, 64, 4)
    one = dryrun.device_cost(cfg, shape, ONE)
    two = dryrun.device_cost(cfg, shape, ONE, microbatches=2)
    assert two["flops_per_device"] == one["flops_per_device"]
    assert two["peak_mem_per_device"] < one["peak_mem_per_device"]


@pytest.mark.parametrize("kind", [ShapeKind.TRAIN, ShapeKind.DECODE],
                         ids=lambda k: k.value)
@pytest.mark.parametrize("arch", FAMILIES)
def test_collective_bytes_follow_the_counts_on_a_2x2_mesh(arch, kind,
                                                          mesh22):
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("smoke", kind, 64, 4)
    coll = dryrun.collective_cost(cfg, shape, mesh22)
    for k, n in coll["counts"].items():
        assert (coll["bytes"][k] > 0) == (n > 0), k
    assert coll["bytes"]["total"] == sum(g["bytes"] for g in coll["groups"])
    assert all(g["size"] == 2 for g in coll["groups"])
    per_dev = dryrun.device_cost(cfg, shape, mesh22)["flops_per_device"]
    assert per_dev * 4 >= dryrun.count_flops(cfg, shape)


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "qwen3-moe-30b-a3b",
                                  "whisper-base"))
def test_fsdp_training_peak_holds_the_gathered_weights(arch, mesh22):
    """Under FSDP a training step computes with every weight gathered to
    the rank's full size, and makes its gradients at that size: the peak
    holds both beside the sharded moments. The same local step on
    (data 1, model 2), where nothing is sharded over data, differs from
    (data 2, model 2) at twice the batch only by the moments' shards:
    at this size the backward's peak is the step's (at 32 tokens the
    update's is, and the update makes moments of each mesh's shard
    size)."""
    from repro_torch.configs import meta_model
    from repro_torch.launch.costs import nbytes

    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("smoke", ShapeKind.TRAIN, 64, 4)
    got = dryrun.device_cost(cfg, shape, mesh22)["peak_mem_per_device"]
    parts = dryrun._state_parts(cfg, shape, mesh22)
    local = sum(map(nbytes, meta_model(dryrun.tp_local_config(cfg, 2),
                                       shape).parameters()))
    assert parts["weights"] < local
    assert got >= parts["weights"] + parts["moments"] + local
    assert got >= parts["moments"] + 2 * local  # weights and gradients

    one = {"data": 1, "model": 2}
    half = dataclasses.replace(shape, global_batch=2)
    unsharded = dryrun.device_cost(cfg, half, one)["peak_mem_per_device"]
    moments = dryrun._state_parts(cfg, half, one)["moments"]
    assert unsharded - got == moments - parts["moments"]


def _matrix_records():
    """A runnable pair and a SKIP on both production meshes."""
    out = []
    for arch, sid in (("mamba2-780m", "decode_32k"),
                      ("deepseek-7b", "long_500k")):
        out += [dataclasses.asdict(r) for r in dryrun.run_pair(
            arch, sid, [False, True], {})]
    return out


def test_render_gives_one_row_per_runnable_16x16_record(tmp_path, capsys):
    records = _matrix_records()
    text = roofline.render(records)
    matrix, terms = text.split("### Roofline terms")
    assert sum(line.startswith("| ") for line in matrix.splitlines()) == \
        1 + len(records)
    assert matrix.count("skip (long-context") == 2 and "FAIL" not in text
    rows = [line for line in terms.splitlines()
            if line.startswith("| ") and not line.startswith("| arch")]
    runnable = [r for r in records if r["ok"] and r["mesh"] == "16x16"]
    assert len(rows) == len(runnable) == 1
    assert all(row.split(" | ")[5] in ("compute", "eager-memory",
                                       "collective") for row in rows)

    path = tmp_path / "matrix.json"
    path.write_text(json.dumps(records))
    names = [r.name for r in roofline.run(path)]
    assert names == [f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}"
                     for r in records]
    assert roofline.main(["--artifact", str(path), "--render"]) == 0
    out = capsys.readouterr().out
    assert out.count("bound=") == 2 and out.count(",SKIP:") == 2
    assert "### Dry-run matrix" in out
    missing = roofline.run(tmp_path / "none.json")
    assert [r.name for r in missing] == ["roofline/ARTIFACT_MISSING"]
