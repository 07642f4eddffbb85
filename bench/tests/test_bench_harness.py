"""The harness is driven by data: a cell, a configuration and a metric
added as new files and new ``BENCHMARK.json`` entries are found by name
with no file edited; the result line has exactly the contract's keys; a
measurement run without a card fails instead of falling back to the CPU,
and so does a checkout that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench.harness.cell import cell_metrics, load_cell
from bench.harness.cli import forbidden_modules, run_cell
from bench.harness.record import emit
from bench.tests.smoke import SMOKE_CELLS, make_root

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("bench"))
    # a metric of its own, added as a reader file and an entry
    (root / "bench" / "metrics" / "served_tokens_per_batch.py").write_text(
        "def read(run):\n"
        "    n = run.counts.get('batches')\n"
        "    return run.counts['served_tokens'] / n if n else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append(
        {"name": "served_tokens_per_batch", "unit": "tokens",
         "better": "higher", "bound": 0.01, "source": "host_clock",
         "workloads": ["danube-smoke-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_added_files_are_found_by_name(root):
    original = {p.relative_to(ROOT / "bench"): p.read_bytes()
                for p in (ROOT / "bench").rglob("*") if p.is_file()
                and "__pycache__" not in p.parts}
    for rel, data in original.items():  # nothing that exists was edited
        assert (root / "bench" / rel).read_bytes() == data, rel
    for name in SMOKE_CELLS:
        cell = load_cell(name, root)
        assert cell.name == name and cell.metrics
    names = [m.name for m in load_cell("danube-smoke-chat", root).metrics]
    assert "served_tokens_per_batch" in names and "itl_p95_ms" in names


def test_the_result_line_has_the_contract_keys(root, capsys):
    cell = load_cell("danube-smoke-chat", root)
    run = run_cell(cell, 3_000_000_007, 0.3, False, torch.device("cpu"),
                   time.time())
    run.device = {"platform": "cpu", "kind": "test", "count": 1,
                  "memory_peak_bytes": 0}
    emit(run)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert set(line["metrics"]) == {"itl_p95_ms", "ttft_p95_ms", "setup_s",
                                    "served_tokens_per_batch"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert list(line["checks"]) == ["served_token_gap"]
    assert err.strip().splitlines()[-1].startswith("[check] served_token_gap")


def test_traced_result_line(root, capsys):
    cell = load_cell("danube-smoke-train", root)
    run = run_cell(cell, 3_000_000_009, 0.3, True, torch.device("cpu"),
                   time.time())
    run.device = {"platform": "cpu", "kind": "test", "count": 1,
                  "memory_peak_bytes": 0, **run.device}
    line = emit(run)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device ran: no device metric is read from a CPU run
    assert line["metrics"] == {}


def _bench_run(cwd: Path, env_extra: dict) -> subprocess.CompletedProcess:
    env = dict(os.environ, **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "danube-chat",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(proc) -> bool:
    return not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_a_per_layer_metric_names_its_cells():
    """Every per-layer entry lists the cells it is read in; one that lists
    none is refused, not spread over the cells that report what it moves."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert all(m["workloads"] for m in bench["per_layer"])
    entry = dict(bench["per_layer"][0])
    del entry["workloads"]
    with pytest.raises(KeyError):
        cell_metrics({"end_to_end": bench["end_to_end"], "per_layer": [entry]},
                     "danube-chat", ROOT / "bench")


def test_no_card_no_result():
    proc = _bench_run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and _no_result(proc), proc.stdout


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _bench_run(tmp_path, {})
    assert proc.returncode != 0 and _no_result(proc), proc.stdout


def test_no_jax_in_the_process():
    assert forbidden_modules() == [] or "jax" not in sys.modules
    before = set(sys.modules)
    import repro_torch.serve  # noqa: F401  the whole serve path
    import repro_torch.train  # noqa: F401
    new = {m.split(".")[0] for m in set(sys.modules) - before}
    assert not new & {"jax", "jaxlib", "flax", "repro"}
