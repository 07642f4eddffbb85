"""A model family is a module found by name: a model that the ``lm``
family refuses (the port's qwen2-72b smoke config, whose attention
carries q, k and v biases) joins the benchmark as new files only, a
family module, its configuration and a served cell with its
``BENCHMARK.json`` entries, in a scratch root; its cell reads correct
and its control not. A family that lacks a function of the contract is
refused when the cell is loaded, before any set-up."""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from bench.harness import control, port
from bench.harness.cell import FAMILY, load_cell, load_family
from bench.harness.cli import run_cell
from bench.harness.record import emit
from bench.tests.smoke import ROOT, make_root

DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")
CELL = "qwen2-bias-smoke-chat"
# bf16 on the CPU: over seeds 2_600_000_001..012 the program's widest gap
# read at most 0.0212 and its fp8 control's at least 0.0906
LIMITS = {"served_token_gap": 0.05}


def add_cell(root: Path, name: str, config: str, family: str,
             limits: dict = LIMITS) -> None:
    """What a PR that adds a model family adds: the family's module, its
    configuration, a served cell, and the cell's entries in
    ``BENCHMARK.json``. No file already in ``root`` is edited."""
    bench = root / "bench"
    shutil.copy(DATA / "families" / f"{family}.py",
                bench / "families" / f"{family}.py")
    shutil.copy(DATA / "configs" / f"{config}.json",
                bench / "configs" / f"{config}.json")
    wl = {"name": name, "config": config, "driver": "serve", "chips": 1,
          "traffic": {"kind": "closed_static_batches", "batch": 8,
                      "cycle": [{"prompt": 24, "new": 16},
                                {"prompt": 16, "new": 16}]},
          "trace_seconds": 1.0, "judge": {"batches": 2}, "limits": limits}
    (bench / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config, "source": "CPU smoke",
                            "file": f"bench/configs/{config}.json",
                            "reduced": [], "why": "CPU smoke"})
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": "smoke", "chips": 1,
                              "why": "CPU smoke cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("itl_p95_ms", "mfu.decode"):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("bench"))
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    add_cell(root, CELL, "qwen2-bias-smoke", "qwen2_bias")
    for rel, data in before.items():
        if rel.name != "BENCHMARK.json":
            assert (root / rel).read_bytes() == data, rel
    return root


def test_the_lm_family_refuses_the_model():
    cfg = json.loads((DATA / "configs" / "qwen2-bias-smoke.json").read_text())
    with pytest.raises(ValueError, match="attn.bq"):
        port.build_model(dict(cfg, family_module="lm"),
                         load_family(dict(cfg, family_module="lm")), 0, CPU)


def test_the_family_is_found_in_the_cells_root(root):
    cell = load_cell(CELL, root)
    assert Path(cell.family.__file__) == (root / "bench" / "families"
                                          / "qwen2_bias.py")
    assert all(callable(getattr(cell.family, f)) for f in FAMILY)
    # its biases are drawn by an init kind of its own (the family's INITS)
    w = port.draw_fn(cell.config, cell.family, 0, CPU)("layers.1")
    assert 0 < w["layers.1.attn.bv"].float().abs().max() <= 0.2
    assert not (ROOT / "bench" / "families" / "qwen2_bias.py").exists()
    assert load_cell("danube-smoke-chat", root).family.__file__ == str(
        root / "bench" / "families" / "lm.py")


@pytest.mark.parametrize("seed", [2_600_000_101, 2_600_000_102,
                                  2_600_000_103])
def test_the_added_cell_reads_correct_and_its_control_not(root, seed,
                                                          capsys):
    cell = load_cell(CELL, root)
    run = run_cell(cell, seed, 0.3, False, CPU, time.time())
    run.device = {"platform": "cpu", "kind": "test", "count": 1,
                  "memory_peak_bytes": 0}
    line = emit(run)
    assert line["correct"] and line["attempted"] > 0, line
    assert {"itl_p95_ms", "setup_s"} <= set(line["metrics"])
    nums, _ = control.readings(run, CPU)
    verdict = control.verdicts(nums, cell.workload["limits"])
    assert verdict["program"]["correct"], verdict
    assert not verdict["control"]["correct"], verdict
    assert control.faults_caught(verdict)


def test_a_family_without_loss_fn_is_refused_at_load(root):
    bench = root / "bench"
    text = (DATA / "families" / "qwen2_bias.py").read_text()
    (bench / "families" / "no_loss.py").write_text(text + "\ndel loss_fn\n")
    cfg = json.loads((DATA / "configs" / "qwen2-bias-smoke.json").read_text())
    cfg.update(name="no-loss-smoke", family_module="no_loss")
    (bench / "configs" / "no-loss-smoke.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / f"{CELL}.json").read_text())
    wl.update(name="no-loss-chat", config="no-loss-smoke")
    (bench / "workloads" / "no-loss-chat.json").write_text(json.dumps(wl))
    with pytest.raises(ValueError) as err:
        load_cell("no-loss-chat", root)
    msg = str(err.value)
    assert "'no-loss-smoke'" in msg and "no_loss.py" in msg, msg
    assert msg.endswith("lacks loss_fn"), msg
