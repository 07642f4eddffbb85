"""A cell and everything it is made of, found by name.

``workloads/<cell>.json`` names the configuration, the driver and the
traffic; ``configs/<config>.json`` holds the configuration as it is run
and names its model family (``family_module``); ``families/<family>.py``
is the family's weight list, plain reference and counts (``FAMILY``);
``drivers/<driver>.py`` is the window loop for one kind of work; each
metric that ``BENCHMARK.json`` assigns to the cell is read by
``metrics/<metric>.py`` (a function ``read(run) -> float | None``). A
later cell, configuration, family or metric is new files and new entries
in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

#: what a family module defines (``bench/families/lm.py`` documents each);
#: it may add ``INITS``, init kinds of its own (``harness.weights``)
FAMILY = ("groups", "group_specs", "served_logits", "loss_fn",
          "prefill_flops", "decode_flops", "train_flops", "layer_calls")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" | "per_layer"
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    family: ModuleType
    driver: ModuleType
    metrics: list[Metric]

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))


def _module(path: Path, kind: str, name: str) -> ModuleType:
    """The file ``path`` imported afresh as a module of its own."""
    mod_name = f"bench_{kind}_" + "".join(c if c.isalnum() else "_"
                                          for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(bench: Path, name: str) -> Callable:
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    return _module(path, "metric", name).read


def load_family(config: dict, root: Path = ROOT) -> ModuleType:
    """The module ``bench/families/<family_module>.py`` under ``root``;
    raises, naming the configuration, the module and what it lacks,
    unless it defines every function of ``FAMILY``."""
    name = config.get("family_module")
    if not isinstance(name, str):
        raise ValueError(f"configuration {config.get('name')!r} names no "
                         f"family_module")
    path = root / "bench" / "families" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config.get('name')!r} "
                                f"names the family {name!r}: no {path}")
    mod = _module(path, "family", name)
    missing = [f for f in FAMILY if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"configuration {config.get('name')!r}: the family "
                         f"module {path} lacks {', '.join(missing)}")
    return mod


def cell_metrics(benchmark: dict, cell: str, bench: Path) -> list[Metric]:
    """The metrics ``BENCHMARK.json`` gives this cell: an end-to-end one
    where it lists the cell or lists none; a per-layer one where it lists
    the cell (every per-layer metric lists its cells)."""
    e2e = [m for m in benchmark["end_to_end"]
           if cell in m.get("workloads", [cell])]
    per = [m for m in benchmark["per_layer"] if cell in m["workloads"]]
    return ([Metric(m["name"], m["unit"], "end_to_end",
                    _reader(bench, m["name"])) for m in e2e]
            + [Metric(m["name"], m["unit"], "per_layer",
                      _reader(bench, m["name"])) for m in per])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = root / "bench"
    path = bench / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no workload {name!r} ({path})")
    workload = load_json(path)
    if workload.get("name") != name:
        raise ValueError(f"{path} names the cell {workload.get('name')!r}")
    config = load_json(bench / "configs" / f"{workload['config']}.json")
    driver = importlib.import_module(f"bench.drivers.{workload['driver']}")
    benchmark = load_json(root / "BENCHMARK.json")
    return Cell(name, workload, config, load_family(config, root), driver,
                cell_metrics(benchmark, name, bench))
