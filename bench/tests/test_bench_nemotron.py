"""The ``nemotron_h`` family joins the benchmark as new files: its module
meets the contract of a family, a served smoke cell of it (bf16, added to a
scratch root as files and ``BENCHMARK.json`` entries only) reads correct
while its fp8 control reads not correct, and its counts hold the shapes
of the full configuration: the decode step's grouped matmuls at
(128, 8, 2688) @ (128, 2688, 1856) and back, and model FLOPs of two a
parameter touched."""

import json
import time
from pathlib import Path

import pytest
import torch

from bench.harness import control, port
from bench.harness.cell import FAMILY, load_cell, load_family
from bench.harness.cli import run_cell
from bench.harness.record import emit
from bench.roofline import counts
from bench.tests.smoke import make_root

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CELL = "nemotron-smoke-chat"
# bf16 on the CPU, over seeds 2_600_000_201..210 and 301..303: the
# program's mean gap read at most 0.0526, the fp8 control's at least
# 0.109; the mean squared gap overlaps at this size (program up to 0.119,
# control from 0.095), so the smoke cell holds the mean alone
LIMITS = {"served_token_gap_mean": 0.08}


def full() -> dict:
    return json.loads((BENCH / "configs" / "nemotron-3-nano-30b-a3b.json")
                      .read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the smoke cell added as files and
    entries."""
    root = make_root(tmp_path_factory.mktemp("bench"))
    wl = {"name": CELL, "config": "nemotron-smoke-bf16", "driver": "serve",
          "chips": 1,
          "traffic": {"kind": "closed_static_batches", "batch": 8,
                      "cycle": [{"prompt": 24, "new": 16},
                                {"prompt": 16, "new": 16}]},
          "trace_seconds": 1.0, "judge": {"batches": 2}, "limits": LIMITS}
    (root / "bench" / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "nemotron-smoke-bf16",
                              "traffic": "smoke", "chips": 1,
                              "why": "CPU smoke cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("itl_p95_ms", "mfu.decode"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_the_family_meets_the_contract(root):
    cell = load_cell(CELL, root)
    assert Path(cell.family.__file__) == (root / "bench" / "families"
                                          / "nemotron_h.py")
    assert all(callable(getattr(cell.family, f)) for f in FAMILY)
    # the weight list is the program's parameters, name for name (fill
    # raises otherwise), the correction bias drawn N(0, 0.01^2)
    _, model = port.build_model(cell.config, cell.family, 0, CPU)
    w = port.draw_fn(cell.config, cell.family, 0, CPU)("layers.1")
    bias = w["layers.1.moe.e_score_correction_bias"]
    assert bias.dtype == torch.float32 and 0 < bias.abs().max() < 0.1
    assert torch.equal(bias, model.layers[1].moe.e_score_correction_bias)


@pytest.mark.parametrize("seed", [2_600_000_301, 2_600_000_302,
                                  2_600_000_303])
def test_the_cell_reads_correct_and_its_fp8_control_not(root, seed):
    cell = load_cell(CELL, root)
    run = run_cell(cell, seed, 0.3, False, CPU, time.time())
    run.device = {"platform": "cpu", "kind": "test", "count": 1,
                  "memory_peak_bytes": 0}
    line = emit(run)
    assert line["correct"] and line["attempted"] > 0, line
    assert {"itl_p95_ms", "setup_s"} <= set(line["metrics"])
    nums, _ = control.readings(run, CPU)
    verdict = control.verdicts(nums, LIMITS)
    assert verdict["program"]["correct"], verdict
    assert not verdict["control"]["correct"], verdict
    assert control.faults_caught(verdict)


def test_the_decode_steps_grouped_matmuls_at_the_full_widths():
    """A decode step of 32 tokens: 23 MoE blocks, each two grouped matmuls
    over every expert's 8 capacity slots; no flash or SSD call."""
    cfg = full()
    fam = load_family(cfg)
    calls = fam.layer_calls(cfg, 32, 256, "decode")
    assert calls["flash"] == [] and calls["ssd"] == []
    up = counts.gmm_call(128, 8, 2688, 1856, 2)
    down = counts.gmm_call(128, 8, 1856, 2688, 2)
    assert calls["gmm"] == [up, down] * 23
    # the experts' weights, 58.7e9 bytes, are nearly all of it
    assert 58.7e9 < sum(b for _, b in calls["gmm"]) < 59.3e9
    pre = fam.layer_calls(cfg, 32, 384, "prefill")
    assert (len(pre["flash"]), len(pre["ssd"]), len(pre["gmm"])) == (6, 23, 46)


def test_model_flops_are_two_a_parameter_touched():
    """One token at position 0 multiplies each active weight once (the
    input embedding is a lookup): decode FLOPs over 2 x the active
    parameters without it, within the few elementwise parameters (norm
    scales, biases) and the SSD recurrence's 5 P N a head."""
    from repro_torch.configs import get_config

    cfg = full()
    fam = load_family(cfg)
    pc = get_config(cfg["arch"])
    active = pc.active_param_count() - pc.vocab_size * pc.d_model
    ratio = fam.decode_flops(cfg, 1, 0) / (2.0 * active)
    assert 1.0 < ratio < 1.01, ratio
    assert fam.train_flops(cfg, 2, 64) == pytest.approx(
        3 * (fam.prefill_flops(cfg, 2, 64)
             + 2.0 * 2 * 63 * pc.d_model * pc.vocab_size))
