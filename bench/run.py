#!/usr/bin/env python3
"""One run of one cell of the benchmark of the PyTorch/CUDA port.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA
device(s). Set-up (building the kernels, the weights from the seed, a
warm-up of every shape) counts from this process's start; the window then
measures for ``--seconds``; the timed path's outputs are judged against
the plain reference. The last stdout line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (and ``breakdown``
with ``--trace 1``), then ``checks``: each compared number and its limit.
The kernels build into ``build/repro_torch/`` of the checkout; other
caches stay under ``build/bench-cache/``.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from bench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
