"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one cell a
run, ``python3 bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``. See ``BENCHMARK.json`` at the root and ``PERF.md``."""
