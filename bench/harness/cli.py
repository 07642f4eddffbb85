"""``bench/run.py``: one run of one cell on this machine's card(s).

Exits non-zero, printing no result, without enough CUDA devices, when a
file the cell needs is missing, or when the process holds JAX or the JAX
package once the window has closed. Otherwise the last stdout line is the
result (``harness.record.result``), ``correct`` false included.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that this process must not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float):
    """Drive the cell once on ``device`` (the CLI passes a card; tests the
    CPU) and return its ``Run``."""
    from bench.harness.record import Run

    run = Run(cell, seed, seconds, traced)
    cell.driver.run(run, device, t_start)
    if run.traced and run.trace is not None:
        run.device.update(busy_s=run.trace.busy_s,
                          window_s=run.trace.window_s)
    return run


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch

    from bench.harness.cell import load_cell
    from bench.harness.record import emit

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   t_start)
    print(f"[bench] {cell.name} seed {args.seed} on {power_limit()}, torch "
          f"{torch.__version__}", file=sys.stderr)
    run.device = {"platform": "gpu",
                  "kind": torch.cuda.get_device_name(device),
                  "count": cell.chips, **run.device}
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process holds {bad} after the window: no result",
              file=sys.stderr)
        return 3
    emit(run)
    return 0
