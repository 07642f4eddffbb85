"""A copy of the benchmark in a scratch root with smoke-sized cells added
as files and ``BENCHMARK.json`` entries only: what a later PR that adds a
cell does."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"

SERVE = {
    "danube-smoke-chat": ("danube-smoke", 2, [{"prompt": 8, "new": 6},
                                              {"prompt": 12, "new": 4}]),
    "jamba-smoke-rag": ("jamba-smoke", 2, [{"prompt": 40, "new": 3},
                                           {"prompt": 24, "new": 4}]),
    # bf16, whose fp8 control flips tokens at this size (TF32 flips none)
    "danube-smoke-bf16-chat": ("danube-smoke-bf16", 8,
                               [{"prompt": 24, "new": 16},
                                {"prompt": 16, "new": 16}]),
}
TRAIN = {"danube-smoke-train": ("danube-smoke", 2, 16)}
SMOKE_CELLS = (*SERVE, *TRAIN)


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """A root under ``tmp`` holding BENCHMARK.json and bench/, with the
    smoke configurations and cells added. ``limits`` overrides the
    cells' limits (default: generous ones, so sound runs pass)."""
    root = tmp / "root"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for cfg in (DATA / "configs").glob("*.json"):
        shutil.copy(cfg, root / "bench" / "configs" / cfg.name)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl_dir = root / "bench" / "workloads"
    for name, (config, batch, cycle) in SERVE.items():
        wl = {"name": name, "config": config, "driver": "serve", "chips": 1,
              "traffic": {"kind": "closed_static_batches", "batch": batch,
                          "cycle": cycle},
              "trace_seconds": 1.0, "judge": {"batches": 2},
              "limits": (limits or {}).get(name, {"served_token_gap": 0.5})}
        (wl_dir / f"{name}.json").write_text(json.dumps(wl))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": "smoke", "chips": 1,
                                   "why": "CPU smoke cell"})
    for name, (config, batch, seq) in TRAIN.items():
        wl = json.loads((wl_dir / "danube-train.json").read_text())
        wl.update(name=name, config=config,
                  traffic={"kind": "uniform_tokens", "batch": batch,
                           "seq": seq},
                  limits=(limits or {}).get(name, {
                      "loss_gap": 1e-4, "grad_norm_gap": 1e-3,
                      "change_norm_gap": 1e-3}))
        (wl_dir / f"{name}.json").write_text(json.dumps(wl))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": "smoke", "chips": 1,
                                   "why": "CPU smoke cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads")
        if cells is None:
            continue
        for kind, names in (("serve", SERVE), ("train", TRAIN)):
            real = {"serve": ("danube-chat", "jamba-rag"),
                    "train": ("danube-train",)}[kind]
            if any(c in cells for c in real):
                cells += list(names)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
