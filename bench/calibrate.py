#!/usr/bin/env python3
"""Readings that set a cell's limits, held against them: the program on
many seeds, and beside each the control and the faults, in one process on
the card.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 20 \
        [--gaps <file.jsonl>]

For every seed the cell runs as ``bench/run.py`` runs it (set-up, a window
of ``--seconds``, the judge); then, on the same inputs, the control and
the faults (``harness.control``). Each reading is held against the cell's
``limits`` by the rule that decides ``correct``, and its line says whether
it reads correct. ``--gaps`` keeps every judged token's gap of a served
cell, one JSON line a seed. The last line is one JSON object with the
lower readings (the program's largest), the upper ones (the smallest of
each control and fault) and the verdicts. The exit code is 1 where any
control or fault reads correct, or the program reads not correct. The
benchmark's own runs never run this.
"""

import time

T_START = time.time()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import argparse  # noqa: E402
import gc  # noqa: E402

import torch  # noqa: E402

from bench.harness import control  # noqa: E402
from bench.harness.cell import load_cell  # noqa: E402
from bench.harness.cli import run_cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--gaps", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    limits = cell.workload["limits"]
    rows, sound = [], True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = run_cell(cell, seed, args.seconds, False, device, t0)
        nums, gaps = control.readings(run, device)
        verdict = control.verdicts(nums, limits)
        sound &= verdict["program"]["correct"] and control.faults_caught(
            verdict)
        row = {"seed": seed, "readings": nums,
               "correct": {k: v["correct"] for k, v in verdict.items()},
               "counts": {k: v for k, v in run.counts.items()
                          if not isinstance(v, list) or len(v) < 8},
               "setup_s": run.setup_s,
               "seconds": round(time.time() - t0, 1)}
        print(json.dumps(row), flush=True)
        if args.gaps and gaps:
            with open(args.gaps, "a") as f:
                f.write(json.dumps({"seed": seed, **gaps}) + "\n")
        rows.append(row)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    kinds = rows[0]["readings"]
    lower = {k: max(r["readings"]["program"][k] for r in rows)
             for k in kinds["program"]}
    upper = {f"{kind}.{k}": min(r["readings"][kind][k] for r in rows)
             for kind in kinds if kind != "program" for k in kinds[kind]}
    caught = {kind: sum(not r["correct"][kind] for r in rows)
              for kind in kinds}
    print(json.dumps({"workload": cell.name, "limits": limits,
                      "lower": lower, "upper": upper,
                      "runs_not_correct": caught, "n": len(rows),
                      "every_fault_caught_and_program_correct": sound}))
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
