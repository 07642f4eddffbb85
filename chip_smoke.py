#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile] [--seed N]

``--profile`` adds a torch.profiler breakdown of device time by kernel
over one warm prefill and the decode steps of each served path (the model
branches' too) (the top
kernels, and every SSD sub-kernel by name), and of one warm ``xregion``
and one ``temporal_joint`` route of the decide half, and of one warm rolling
re-plan and one warm queue run of the serving loop, of one warm
``steady_diurnal/temporal-defer`` scenario cell and of one warm 1M
``serve_stream(plan=...)`` (top ops, busy share).
``--seed`` (default 0) seeds the fleet handoff's weights and prompts.

Phases (any failure ends the script with a non-zero exit):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source, all started together) and print the build time and
   one line per kernel with its registers and spill bytes (ptxas).
2. Hold each kernel against its plain PyTorch version on the card, and
   time kernel, plain version and one PyTorch library call (where one
   computes the same function) with CUDA events, the L2 cache flushed
   before every launch: flash attention (danube f32/bf16, a window, ragged
   S=96, qwen3's D=128 bf16; timed: danube f32 and bf16, qwen3 bf16),
   RMSNorm (prefill, decode and odd widths; timed: every served prefill
   shape and one decode shape, ``NORM_TIMED``; nemotron's groups of 512,
   ``NORM_NEMOTRON``), the SSD scan (mamba2-780m's prefill, the reference
   sweep in f32 and bf16, ragged S, an initial state, nemotron's 8 B/C
   groups, ``SSD_NEMOTRON``; timed: the prefill and a 4096-token prompt,
   ``SSD_TIMED``) and the grouped matmul (qwen3's prefill and decode
   shapes in bf16 and f32, jamba's and nemotron's, the reference sweep;
   timed: every bf16 prefill and decode shape but the sweep).
   Tolerances are those of tests/test_kernels.py.
3. Drive the three served paths through ``repro_torch.launch.serve.main``,
   each at full width, routing one request and generating (4, 16) tokens
   from (4, 512) prompts, the launch counters set to 0 just before each
   and read just after; each count must equal ``kernel_launches``:
   - ``h2o-danube-1.8b`` f32 (24 layers): 24 flash, 49 x 16 RMSNorm; its
     prefill logits through the kernels match the plain versions;
   - ``mamba2-780m`` f32 (48 layers): 48 SSD scans, 97 x 16 RMSNorm; its
     prefill logits through the kernels match the plain versions;
   - ``qwen3-moe-30b-a3b`` bf16 (48 layers): 48 flash, 97 x 16 RMSNorm,
     3 x 48 x 16 grouped matmuls; logits finite, each layer's attention
     and MoE through the kernels match the plain versions on the same
     input (``layers_vs_plain``).
4. Check the card against the CPU on small inputs: the three smoke
   configs' logits and greedy tokens, and the full config's routing
   decision.
5. ``[fleet]``: the decide half on the card at the sizes of the repo's
   routing results (``FLEET``): ``FleetRouter`` with the Table-1 oracle,
   tier-only and cross-region ``PlacementPolicy``, the joint
   ``TemporalPolicy`` and the 128-site sparse mesoscale grid, routing 1M
   requests (200k deferrable for the temporal one). One line each after a
   warm-up call: routed and total gCO2, shed / spilled / deferred counts,
   admission rounds, warm wall time and requests per second. On each
   configuration's first 50,000 requests the card's decisions (target,
   executing region and hour, shed mask, counts) must equal the CPU's
   exactly and carbon agree within rtol 1e-5. Then the handoff:
   ``admit_windows`` for an engine pinned to the edge-DC tier picks the
   first hourly window of ``xregion`` that admitted at least 4 requests,
   and 4 of them are served through the full-width danube f32 engine
   (prompt 512, 16 new tokens, counters exact: 24 flash, 49 x 16 RMSNorm).
6. ``[shard]``: sharded routing over ``torch.distributed``
   (``repro_torch.serve.distributed``), a FileStore rendezvous. World 1
   over NCCL in this process: every ``FLEET`` configuration at its size
   through ``FleetRouter(mesh=data_mesh(1))``, its target, feasibility,
   executing region and hour, shed mask, counts, carbon and routed gCO2
   bit-identical to the unsharded card route's (warm wall, req/s); the
   ``[serve]`` queue run at 1M through the meshed router, equal to the
   meshless run; the sharded ``xregion`` route's edge-DC admissions
   handed to the danube engine as in ``[fleet]`` (24 flash, 49 x 16
   RMSNorm). Then worlds 2 and 4 as spawned ranks sharing the card over
   gloo (NCCL takes one rank a card): ``xregion``, ``temporal_joint`` and
   ``mesoscale`` at full size, every rank the same result, decisions,
   carbon and routed gCO2 bit-identical to world 1 (sha256 of the
   arrays); the warm wall of the slowest rank, not a scaling figure.
7. ``[serve]``: the serving loop on the card, rebuilt from the port's own
   modules at the sizes of the repo's results (``benchmarks/
   policy_throughput.py``'s forecast, queue and refit rows), routing
   ``h2o-danube-1.8b`` requests. ``forecast``: a 1M ``forecast_scenario``
   stream (sigma_h 0.03) routed immediately (cross-region placement),
   one-shot error-blind (``TemporalPolicy(max_defer_h=12)``) and by the
   rolling risk-aware re-planner (``risk_lambda=1.0``, 6-hour steps, an
   ``EmissionsLedger``); the gate: rolling routes less carbon than
   immediate. ``queue``: 1M ``diurnal_stream`` requests through
   ``serve_stream`` on the fully connected grid, placement with unit caps
   and a pool of 2 workers per (region, DC tier) at 30,000 slots each.
   ``refit``: a 30k two-day deferrable stream under DC caps of
   0.6 n / (R 48), ``TemporalPolicy(max_defer_h=16)``, 2-hour steps: the
   static learned policy (classification without the carbon head, fitted on
   the host on the design space at hours 0, 4, ..., 20), the same with an
   ``OnlineRefitter``, and the oracle; the gate: refit <= static x 1.001.
   One line each (routed gCO2, shed/deferred, steps or refits, warm wall,
   req/s). Card against CPU on whole streams (50k for the rolling and
   queue runs, the refit's own 30k): decisions identical, carbon within
   rtol 1e-5. Then ``admit_windows(queue=...)`` for an engine pinned to the
   edge-DC tier picks the first serve step of the queue run that admitted
   4 requests, and they are served through the full-width danube f32 engine
   (counters exact: 24 flash, 49 x 16 RMSNorm).
8. ``[scenarios]``: the scenario matrix (``repro_torch.serve.scenarios``)
   on the card at 1M requests a scenario (the flash crowd draws ~2.36M):
   every (scenario, policy) cell of the seven scenarios x three policies,
   one line each (total, routed and latency-optimal gCO2, shed / spill /
   defer rates, mean defer, warm wall after one warm-up route); card ==
   CPU on every cell built at 20,000 requests (each side routes the same
   whole stream: decisions identical, carbon within rtol 1e-5); the three
   gates of ``repro_torch.launch.scenario_matrix`` (curtailment chase and
   spike-aware provisioning at 1M, watt caps at 200,000 x 3 seeds x 2
   policies).
9. ``[provision]``: the README's mesoscale provisioning table (20,000
   requests, ``from_sites(128, 8)``, paper fleet) exactly and card == CPU;
   the four plans of a 1M ``multi_region_stream`` on the same grid;
   ``serve_stream(plan=)`` with the greedy and the static plan at 1M under
   unit-capped placement (shed, routed and standing gCO2, warm wall; gate:
   provisioned standing + routed < static's); card == CPU on a 50,000-
   request stream with its own plan.
10. ``[tour]``: ``repro_torch.launch.tour`` (the ten acts of the serving
   tour) at its default 1M requests with ``--learned`` and the full
   ``h2o-danube-1.8b`` engine in f32, the counters set to 0 just before
   and read just after: 24 flash and 49 x 8 RMSNorm (one prefill, eight
   forward passes), no SSD scan, no grouped matmul.
11. ``[branches]``: the model branches at full width, batch 4, 16 new
   tokens, the counters set to 0 just before each run and read just
   after, each count exact (``kernel_launches``): ``whisper-base`` f32
   through the launcher (prompt 128, stub encoder frames (4, 1500, 512);
   the encoder's, the decoder's and the cross attention take the flash
   kernel at prefill, a decode step's single query the plain einsums),
   its prefill logits through the kernels against the plain versions
   within 2e-3; ``qwen2-vl-7b`` bf16 through the launcher text-only, then
   through ``ServeEngine`` with 1024 patch embeddings over the first 1024
   of a 1280-token prompt at 32 x 32 grid M-RoPE positions, its attention
   layer by layer against the plain versions (2e-2) on both runs;
   ``jamba-v0.1-52b`` bf16 at 16 of its 32 layers
   (the full model's 103 GB do not fit the card) through ``ServeEngine``,
   its attention and MoE (2e-2) and SSD scans (y 5e-2, state 5e-3) layer
   by layer; ``nemotron-3-nano-30b-a3b`` bf16 whole (63.2 GB) through
   ``ServeEngine``, layer by layer likewise; warm prefill and decode times with the card's name and power
   limit; then card == CPU on the three smoke configs (logits within 1e-4,
   greedy tokens equal). ``--profile`` adds each path's prefill and decode
   breakdown.
12. ``[train]``: training through ``repro_torch.launch.train.main`` at full
   width, f32, TF32 off, 1 cold and 5 warm steps each (``TRAIN_FULL``):
   ``h2o-danube-1.8b`` at (4, 512) (dense attention) and at (1, 4096)
   (the reference's train_4k length: blocked causal attention) with remat
   ``dots``, ``mamba2-780m`` at (4, 512) (``ssd_chunked`` at chunk 256),
   ``whisper-base`` at
   (4, 128) over 1500 stub frames (the encoder and the cross attention);
   one line each of losses and grad norms (all finite), one of the warm
   step (ms, tokens/s, peak memory, the bound: ``dryrun.device_cost``'s
   FLOPs of the step at 67 TFLOP/s, the roofline's compute term, and the
   share of it) with the card's name and power limit.
   On danube, at one state and batch, remat ``dots`` / ``minimal`` /
   ``none`` and 2 microbatches give the same loss and grad norm within
   1e-5. Then the six smoke configs take 3 steps on the card and on the
   CPU (losses within 1e-4), the reference's Markov-language recipe
   (deepseek-7b smoke, 25 steps) ends below 0.85 ln V, an elastic run
   that fails at step 12 resumes from step 10 and ends within 1e-6 of the
   uninterrupted one, and 2 spawned ranks sharing the card over gloo train
   3 steps in the int8 and bf16 modes, every rank ending with the same
   parameters, equal to an in-process model of the per-rank arithmetic.
   The training path runs no kernel (the kernels have no backward, nor
   have the reference's): the launch counters must not move.
13. ``[dryrun]``: ``python -m repro_torch.launch.dryrun --all
   --both-meshes`` in a spawned process (8 worker processes over the
   (arch, shape) pairs, meta tensors over fake process groups of 256 and
   512 ranks): one row per cell of the ten full configs x four shapes x
   both production meshes, 0 failures, SKIPs exactly where
   ``cell_supported`` puts them, every cell's FLOPs equal to the closed
   form ``flop_terms`` (printed term by term) and the phase's time. Then
   danube-1.8b f32 at (4, 512), remat dots: one real step on the card
   with its AdamW update (``dryrun.device_step``) under
   ``launch.costs.DeviceCostMode`` counts the meta count's FLOPs (and the
   closed form's), and ``state_bytes_per_device`` on a (1, 1) mesh over
   NCCL equals the live ``TrainState`` plus the step's gradients, printed
   beside ``[train]``'s peak (the gap: activations).
14. ``[roofline]``: ``repro_torch.launch.roofline`` over ``[dryrun]``'s
   matrix, priced at the H100's spec-sheet rates (``roofline.H100_SXM``,
   which every bound in this script uses). ``[dryrun]``'s card step held
   to ``dryrun.device_cost`` on meta tensors on a (1, 1) mesh: FLOPs and
   bytes accessed equal, ``max_memory_allocated`` within 0.9–1.1 x
   ``peak_mem_per_device``; ``[train]``'s warm steps of the same config
   against the compute, memory and collective terms (each at least the
   compute term, the roofline fraction printed); the rendered 16x16
   roofline table, one bound for every runnable cell and no FAIL row.
15. ``[examples]``: ``launch.quickstart``, ``launch.lm_design_space``,
   ``launch.fault_tolerant_training`` and ``launch.carbon_aware_training``
   (its default 300 steps of (8, 128), an 80M-parameter model) with
   ``--device cuda``, each against a CPU run: decisions and ledgers card
   == CPU, losses finite and falling, the launch counters 0 around each
   training run.

The second-last line is one JSON object ``{"kernels": [...]}`` with each
kernel's launches on the served paths (none on the training path),
error, times and bound; the line
before it is the card's name and power limit from nvidia-smi; the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA
device or without the repository beside this file.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 5e-4, "bfloat16": 2e-2}  # tests/test_kernels.py _tol
SSD_Y_TOL = {"float32": 5e-4, "bfloat16": 5e-2}  # tests/test_kernels.py SSD
SSD_STATE_TOL = 5e-3
LOGITS_TOL = 2e-3  # kernels vs plain versions through 24-48 f32 layers
BATCH, PROMPT, NEW = 4, 512, 16
DANUBE, MAMBA, QWEN3 = "h2o-danube-1.8b", "mamba2-780m", "qwen3-moe-30b-a3b"
# Timed RMSNorm shapes: (2048, 2560) f32 is the kernels line's own row;
# the others are the remaining served prefill shapes (mamba2 f32 d_model
# and gated d_inner, qwen3 bf16) and one decode shape.
NORM_TIMED = [((2048, 2560), "float32"), ((2048, 1536), "float32"),
              ((2048, 3072), "float32"), ((2048, 2048), "bfloat16"),
              ((4, 2560), "float32"),
              # the model branches: whisper's encoder and decoder prefill
              # (f32), qwen2-vl's text-only and patch prefills, jamba's
              # d_model and gated d_inner (bf16)
              ((6000, 512), "float32"), ((512, 512), "float32"),
              ((2048, 3584), "bfloat16"), ((5120, 3584), "bfloat16"),
              ((2048, 4096), "bfloat16"),
              ((2048, 8192), "bfloat16")]
# Timed SSD scans (label, B, S, H, P, N, chunk), f32, mamba2-780m's A and
# dt: the served prefill (the kernels line's own row) and a long prompt,
# whose 64 chunks show the chunk parallelism that S = 512 hides.
SSD_TIMED = [("main", BATCH, PROMPT, 48, 64, 128, 256),
             ("long prompt", 1, 4096, 48, 64, 128, 256)]
# jamba-v0.1-52b's Mamba layers at prefill, bf16: H 128, P 64, N 16
SSD_JAMBA = ("jamba", BATCH, PROMPT, 128, 64, 16, 128)
# nemotron-3-nano's at nemotron-reasoning's largest prefill (label, B, S,
# H, P, N, chunk, B/C groups), and its grouped gated norm's shapes there
# and at a decode step
SSD_NEMOTRON = ("nemotron", 32, 384, 64, 64, 128, 128, 8)
NORM_NEMOTRON = [(32, 4096), (12288, 4096)]
# Timed flash shapes of the model branches (label, B, Sq, Sk, H, Hkv, D,
# causal, dtype name): whisper's encoder self-attention, its cross
# attention at prefill (Sk 1500: a ragged last key tile) and, off the path,
# at one query (a decode step takes the plain einsums, which this row
# times against the kernel), its decoder self-attention; qwen2-vl's
# text-only and patch prefills (GQA group 7); jamba's.
FLASH_BRANCHES = [
    ("whisper encoder", BATCH, 1500, 1500, 8, 8, 64, False, "float32"),
    ("whisper cross", BATCH, 128, 1500, 8, 8, 64, False, "float32"),
    ("whisper cross Sq 1", BATCH, 1, 1500, 8, 8, 64, False, "float32"),
    ("whisper decoder", BATCH, 128, 128, 8, 8, 64, True, "float32"),
    ("qwen2-vl text", BATCH, PROMPT, PROMPT, 28, 4, 128, True, "bfloat16"),
    ("qwen2-vl patches", BATCH, 1280, 1280, 28, 4, 128, True, "bfloat16"),
    ("jamba", BATCH, PROMPT, PROMPT, 32, 8, 128, True, "bfloat16"),
]


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output:
    the kernel (demangled where c++filt exists), its registers and its
    spill bytes; source headers (``== file``) kept."""
    out, kernels, name, spill = [], [], None, "?"
    for line in log.splitlines():
        if line.startswith("=="):
            out.append(line)
        elif m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            kernels.append(name)
            out.append((len(kernels) - 1, f"{m.group(1)} registers, {spill}"))
            name, spill = None, "?"
    try:
        demangled = subprocess.run(["c++filt"], input="\n".join(kernels),
                                   capture_output=True, text=True,
                                   check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        demangled = kernels
    short = [re.sub(r"^void |\(anonymous namespace\)::|\(.*\)$", "", k)
             for k in demangled]
    return [x if isinstance(x, str) else f"{short[x[0]]}: {x[1]}"
            for x in out]


def profile_path(torch, engine, prompt, label: str, extras=None) -> None:
    """Device time by kernel over one warm prefill and the decode steps of
    one batch (torch.profiler); ``extras`` go to the prefill. Only
    device-side events count: an aten op's own device time repeats the
    kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    def report(part, prof, wall_us):
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        busy = sum(r[0] for r in rows)
        print(f"[profile] {label} {part}: wall {wall_us / 1e3:.1f} ms, kernels "
              f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%} busy)")
        for k, (us, count, key) in enumerate(rows):
            if k < 12 or "ssd_" in key:  # the top, and each SSD sub-kernel
                print(f"[profile]   {us / 1e3:9.3f} ms {us / busy:6.1%} "
                      f"x{count:<5} {key[:90]}")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, state = engine.prefill_batch(prompt, **(extras or {}))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    report("prefill", prof, wall)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(NEW - 1):
            logits, state = engine.serve_step(
                state, logits.argmax(-1, keepdim=True))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    report(f"{NEW - 1} decode steps", prof, wall)


def device_profile(torch, fn, label: str) -> None:
    """Device time by op over one call of ``fn`` (torch.profiler): the top
    device-side events and the share of the wall time the card was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] {label}: wall {wall / 1e3:.1f} ms, device "
          f"{busy / 1e3:.1f} ms ({busy / wall:.1%} busy)")
    for us, count, key in rows[:12]:
        print(f"[profile]   {us / 1e3:9.3f} ms {us / max(busy, 1e-9):6.1%} "
              f"x{count:<5} {key[:90]}")


# The decide half's configurations (benchmarks/policy_throughput.py's
# placement, temporal and mesoscale rows): name, stream, requests, regions,
# grid, policy, DC-tier cap fraction of n / (R * 24) per cell.
FLEET = [
    ("uncapped", "multi_region", 1_000_000, 4, "default", "oracle", None),
    ("tier_spill", "multi_region", 1_000_000, 4, "default", "placement", 0.4),
    ("xregion", "multi_region", 1_000_000, 4, "fully_connected", "placement",
     0.4),
    ("temporal_joint", "deferrable", 200_000, 4, "fully_connected",
     "temporal", 0.6),
    ("mesoscale", "multi_region", 1_000_000, 128, "sites", "placement", 0.4),
]
FLEET_CHECK_N = 50_000  # card against CPU on each stream's first requests
FLEET_RTOL = 1e-5


def fleet_stream(kind: str, n: int, n_regions: int):
    """The numpy stream of a ``FLEET`` configuration."""
    from repro_torch.serve.streams import (deferrable_stream,
                                           multi_region_stream)

    if kind == "deferrable":
        return deferrable_stream(n, n_regions)
    return multi_region_stream(n, n_regions, seed=1 if n_regions > 4 else 0)


def fleet_router(spec, n: int, device, mesh=None):
    """The ``FleetRouter`` of a ``FLEET`` configuration at ``n`` requests on
    ``device``, sharded over ``mesh`` when given."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.carbon_intensity import CarbonGrid
    from repro_torch.core.infrastructure import pack_infra, tpu_fleet
    from repro_torch.serve import (FleetRouter, OraclePolicy,
                                   PlacementPolicy, TemporalPolicy)

    _, _, _, n_regions, grid_kind, pol, frac = spec
    if grid_kind == "sites":
        grid = CarbonGrid.from_sites(n_regions, 8, seed=0, device=device)
    elif grid_kind == "fully_connected":
        grid = CarbonGrid.fully_connected(latency_penalty=1.05, device=device)
    else:
        grid = CarbonGrid.from_regions(device=device)
    infra = pack_infra(tpu_fleet(), device=device)
    caps = np.full((n_regions, 3), np.inf)
    if frac is not None:
        caps[:, 1] = caps[:, 2] = max(1.0, frac * n / (n_regions * 24))
    policy = {"oracle": lambda: OraclePolicy(infra),
              "placement": lambda: PlacementPolicy(OraclePolicy(infra),
                                                   caps),
              "temporal": lambda: TemporalPolicy(OraclePolicy(infra), caps,
                                                 max_defer_h=12),
              }[pol]()
    return FleetRouter(get_config(DANUBE), grid=grid, policy=policy,
                       device=device, mesh=mesh)


def fleet_decisions(res, state, t_hours, horizon) -> dict:
    """A route's decisions as host arrays: target, executing region and
    hour, shed mask, counts."""
    import numpy as np

    host = lambda x: x.cpu().numpy()
    hour = np.floor(t_hours).astype(np.int64) % horizon
    ex_h = getattr(state, "exec_hour", None)
    shed = getattr(state, "shed", None)
    return {"target": host(res.target),
            "exec_region": host(res.exec_region),
            "exec_hour": hour if ex_h is None else host(ex_h),
            "shed": (np.zeros(len(t_hours), bool) if shed is None
                     else host(shed)),
            "counts": host(res.counts)}


def fleet_handoff(torch, dev, results, seed: int, fr, res, t_hours,
                  tag: str, path: str) -> None:
    """``admit_windows`` for an engine pinned to the edge-DC tier picks the
    first hourly window of the route ``res`` that admitted at least 4
    requests, and 4 of them are served through the full-width danube f32
    engine, the counters set to 0 just before and read just after (24
    flash, 49 x 16 RMSNorm). ``path`` names the run in the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.core.constants import Target
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer
    from repro_torch.serve import ServeEngine

    cfg = get_config(DANUBE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg, device=dev, dtype=torch.float32, generator=gen)
    engine = ServeEngine(cfg, model, max_seq=PROMPT + NEW + 8,
                         tier=int(Target.EDGE_DC), device=dev)
    windows = fr.admit_windows(res, t_hours, engine)
    hour = next((h for h, idx in enumerate(windows) if len(idx) >= 4), None)
    check(hour is not None, f"{tag}: no hourly window admitted 4 edge-DC "
          f"requests")
    picked = windows[hour][:4]
    tgt = res.target.cpu().numpy()[picked]
    check(bool((tgt == int(Target.EDGE_DC)).all()),
          f"{tag}: admitted requests are not routed to the edge DC")
    prompt = torch.randint(0, cfg.vocab_size, (4, PROMPT), generator=gen,
                           device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    tokens = engine.generate(prompt, max_new_tokens=NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = dict({k: 0 for k in launches}, flash_attention=cfg.n_layers,
                fused_rmsnorm=(2 * cfg.n_layers + 1) * NEW)
    check(launches == want, f"{tag} handoff: launch counts {launches}, "
          f"expected {want}")
    check(tuple(tokens.shape) == (4, NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
        f"{tag} handoff: tokens")
    for name, r in results.items():
        r["launches_by_path"][path] = launches[name]
    print(f"[{tag}] handoff: window {hour} admitted {len(windows[hour])} "
          f"edge-DC requests of {path.split(' -> ')[0]}; served requests "
          f"{picked.tolist()} (exec regions "
          f"{res.exec_region.cpu().numpy()[picked].tolist()}) through "
          f"{DANUBE} f32, prompt ({len(picked)}, {PROMPT}), {NEW} new tokens "
          f"in {wall:.3f} s; launches {launches}")
    del model, engine
    torch.cuda.empty_cache()


def fleet_phase(torch, dev, results, profile: bool, seed: int) -> None:
    """Phase 5: route the configurations of ``FLEET`` on the card, hold
    their decisions against the CPU, and hand ``xregion``'s admitted
    requests to the danube engine."""
    import dataclasses

    import numpy as np

    def head(batch, region, t_hours, n):
        cut = {f.name: (None if getattr(batch, f.name) is None
                        else getattr(batch, f.name)[:n])
               for f in dataclasses.fields(batch)}
        return dataclasses.replace(batch, **cut), region[:n], t_hours[:n]

    xregion = None
    for spec in FLEET:
        name, kind, n, n_regions = spec[:4]
        t0 = time.perf_counter()
        batch, region, t_hours = fleet_stream(kind, n, n_regions)
        t_stream = time.perf_counter() - t0
        fr = fleet_router(spec, n, dev)
        fr.route_stream(batch, region, t_hours)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, state = fr.route_stream_with_state(batch, region, t_hours)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = getattr(fr.policy, "last_rounds", 0)
        routed, total = float(res.routed_carbon_g), float(res.total_carbon_g)
        check(np.isfinite(routed) and np.isfinite(total) and routed > 0,
              f"{name}: non-finite or zero routed carbon")
        check(tuple(res.target.shape) == (n,)
              and res.target.device.type == dev.type,
              f"{name}: targets not (N,) on the card")
        check(int(res.counts.sum()) + int(res.shed_count) == n,
              f"{name}: counts and shed do not partition the stream")
        print(f"[fleet] {name}: {n} requests, {n_regions} regions, policy "
              f"{fr.policy.name}: routed {routed:.6g} g, total {total:.6g} "
              f"g, shed {int(res.shed_count)}, spilled "
              f"{int(res.spilled_count)}, deferred {int(res.deferred_count)}"
              f", rounds {rounds}; warm {wall:.4f} s ({n / wall:.0f} req/s)"
              f"; stream made in {t_stream:.2f} s")
        if name == "xregion":
            xregion = (fr, res, t_hours)
        if profile and name in ("xregion", "temporal_joint"):
            device_profile(torch, lambda: fr.route_stream(batch, region,
                                                          t_hours),
                           f"fleet {name} route")
        del res, state

        # card against CPU on the stream's first requests
        sub = head(batch, region, t_hours, FLEET_CHECK_N)
        got = {}
        for d in (dev, "cpu"):
            frd = fleet_router(spec, FLEET_CHECK_N, d)
            r, st = frd.route_stream_with_state(*sub)
            got[str(d)] = (fleet_decisions(r, st, sub[2], frd.grid.horizon_h),
                           r.carbon_g.cpu().numpy(), float(r.routed_carbon_g))
        card, cpu = got[str(dev)], got["cpu"]
        for k, v in cpu[0].items():
            bad = int((card[0][k] != v).sum())
            check(bad == 0, f"{name}: {k} differs card vs CPU on the first "
                  f"{FLEET_CHECK_N} requests ({bad} entries)")
        check(np.allclose(card[1], cpu[1], rtol=FLEET_RTOL, atol=0),
              f"{name}: per-request carbon differs card vs CPU")
        check(abs(card[2] - cpu[2]) <= FLEET_RTOL * abs(cpu[2]),
              f"{name}: routed carbon differs card vs CPU")
        err = np.max(np.abs(card[1] - cpu[1])
                     / np.maximum(np.abs(cpu[1]), 1e-30))
        print(f"[fleet] {name} card == CPU on the first {FLEET_CHECK_N}: "
              f"target, exec region/hour, shed, counts identical; carbon "
              f"max rel err {err:.2e} (rtol {FLEET_RTOL:g})")
        torch.cuda.empty_cache()

    # --- the handoff: decide -> execute ---------------------------------------
    fleet_handoff(torch, dev, results, seed, *xregion, "fleet",
                  f"xregion -> {DANUBE}")


# The sharded phase: worlds 2 and 4 route these FLEET configurations as
# spawned ranks sharing the one card over gloo; world 1 (NCCL, in this
# process) routes every FLEET configuration.
SHARD_WORLDS = (2, 4)
SHARD_SPAWNED = ("xregion", "temporal_joint", "mesoscale")
SHARD_TIMEOUT_S = 600


def shard_digest(np, res, state, t_hours, horizon) -> dict:
    """sha256 of each decision array, the per-request carbon and the
    routed gCO2 (float32 bytes) of a route: equal digests are equal bits."""
    import hashlib

    arrays = fleet_decisions(res, state, t_hours, horizon)
    arrays["feasible"] = res.feasible.cpu().numpy()
    arrays["carbon_g"] = res.carbon_g.cpu().numpy()
    arrays["routed_carbon_g"] = res.routed_carbon_g.cpu().numpy()
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def shard_rank(rank: int, world: int, store: str, out: str,
               device: str) -> None:
    """One spawned rank of a gloo world: route ``SHARD_SPAWNED`` at full
    size with the whole stream under ``data_mesh(world)``, all ranks'
    tensors on ``device``, and write each route's digests, warm wall and
    counts to ``<out>/rank<rank>.json``."""
    import datetime
    import os

    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.serve import data_mesh

    dev = torch.device(device)
    if dev.type == "cuda":  # every rank on the same card
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=SHARD_TIMEOUT_S))
    try:
        mesh = data_mesh(world, device=dev.type)
        record = {}
        for spec in FLEET:
            name, kind, n, n_regions = spec[:4]
            if name not in SHARD_SPAWNED:
                continue
            batch, region, t_hours = fleet_stream(kind, n, n_regions)
            fr = fleet_router(spec, n, dev, mesh=mesh)
            fr.route_stream(batch, region, t_hours)  # warm-up
            sync(torch, dev)
            dist.barrier()
            t0 = time.perf_counter()
            res, state = fr.route_stream_with_state(batch, region, t_hours)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            record[name] = dict(
                digest=shard_digest(np, res, state, t_hours,
                                    fr.grid.horizon_h),
                wall=wall, routed=float(res.routed_carbon_g),
                shed=int(res.shed_count), spilled=int(res.spilled_count),
                deferred=int(res.deferred_count))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def spawn_world(world: int, tmp: str, device: str, fn=shard_rank,
                timeout_s: float = SHARD_TIMEOUT_S) -> list[dict]:
    """Run ``world`` ranks of ``fn`` (``shard_rank`` or ``train_rank``;
    start method spawn, a FileStore under ``tmp``) and return their
    records; a rank that fails or outlives ``timeout_s`` fails the phase,
    and none is left running."""
    import os

    import torch.multiprocessing as mp

    out = os.path.join(tmp, f"world{world}")
    os.makedirs(out)
    ctx = mp.start_processes(fn, args=(world, os.path.join(
        out, "store"), out, device), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline, f"{fn.__name__} world "
                  f"{world}: ranks still running after {timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    records = []
    for rank in range(world):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            records.append(json.load(f))
    return records


def shard_phase(torch, dev, results, seed: int) -> None:
    """Phase 6, ``[shard]``: sharded routing over ``torch.distributed``.
    World 1 over NCCL in this process (a FileStore, no TCP port): every
    ``FLEET`` configuration through ``FleetRouter(mesh=data_mesh(1))``
    against the unsharded card route of the same stream, the ``[serve]``
    queue run through the meshed router against the meshless one, and the
    sharded ``xregion`` route's edge-DC admissions handed to the danube
    engine.
    Then worlds 2 and 4 as spawned ranks sharing the card over gloo:
    ``SHARD_SPAWNED`` at full size, every rank the same result, decisions
    and routed gCO2 bit-identical to world 1."""
    import datetime
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch.serve import data_mesh

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":  # the mesh's communicator binds the current card
        torch.cuda.set_device(dev.index or 0)
    tmp_dir = tempfile.TemporaryDirectory(prefix="shard-")
    tmp = tmp_dir.name
    dist.init_process_group(backend, init_method=f"file://{tmp}/world1",
                            rank=0, world_size=1, timeout=datetime.timedelta(
                                seconds=SHARD_TIMEOUT_S))
    try:
        mesh = data_mesh(1, device=dev.type)
        digests, xregion = {}, None
        for spec in FLEET:
            name, kind, n, n_regions = spec[:4]
            batch, region, t_hours = fleet_stream(kind, n, n_regions)
            plain = fleet_router(spec, n, dev)
            ref, ref_state = plain.route_stream_with_state(batch, region,
                                                           t_hours)
            horizon = plain.grid.horizon_h
            want = fleet_decisions(ref, ref_state, t_hours, horizon)
            want["feasible"] = ref.feasible.cpu().numpy()
            want["carbon_g"] = ref.carbon_g.cpu().numpy()
            want["routed_carbon_g"] = ref.routed_carbon_g.cpu().numpy()
            routed_ref = float(ref.routed_carbon_g)
            del plain, ref, ref_state
            fr = fleet_router(spec, n, dev, mesh=mesh)
            fr.route_stream(batch, region, t_hours)  # warm-up
            sync(torch, dev)
            t0 = time.perf_counter()
            res, state = fr.route_stream_with_state(batch, region, t_hours)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            got = fleet_decisions(res, state, t_hours, horizon)
            got["feasible"] = res.feasible.cpu().numpy()
            got["carbon_g"] = res.carbon_g.cpu().numpy()
            got["routed_carbon_g"] = res.routed_carbon_g.cpu().numpy()
            for k, v in want.items():  # the same bits, carbon included
                check(got[k].dtype == v.dtype
                      and got[k].tobytes() == v.tobytes(),
                      f"shard {name}: {k} differs world 1 vs the unsharded "
                      f"route ({int((got[k] != v).sum())} entries)")
            routed = float(res.routed_carbon_g)
            print(f"[shard] world 1 ({backend}) {name}: {n} requests, routed "
                  f"{routed:.9g} g (unsharded {routed_ref:.9g} g), shed "
                  f"{int(res.shed_count)}, spilled {int(res.spilled_count)}, "
                  f"deferred {int(res.deferred_count)}; target, feasible, "
                  f"exec region/hour, shed, counts, carbon and routed gCO2 "
                  f"bit-identical to the unsharded route; warm {wall:.4f} s "
                  f"({n / wall:.0f} req/s)")
            if name in SHARD_SPAWNED:
                digests[name] = shard_digest(np, res, state, t_hours,
                                             horizon)
            if name == "xregion":
                xregion = (fr, res, t_hours)
            del res, state
            torch.cuda.empty_cache()

        # --- the [serve] queue run through the meshed router ---------------
        want_q = queue_run(SERVE_N, dev)[1]()
        run_q = queue_run(SERVE_N, dev, mesh=mesh)[1]
        t0 = time.perf_counter()
        got_q = run_q()
        sync(torch, dev)
        wall = time.perf_counter() - t0
        for f in SERVE_FIELDS + ("step", "defer_hours"):
            bad = int((getattr(got_q, f) != getattr(want_q, f)).sum())
            check(bad == 0, f"shard queue: {f} differs meshed vs meshless "
                  f"({bad} rows)")
        check(got_q.carbon_g.tobytes() == want_q.carbon_g.tobytes()
              and got_q.routed_carbon_g == want_q.routed_carbon_g,
              "shard queue: carbon differs meshed vs meshless")
        check([s.drafted for s in got_q.steps]
              == [s.drafted for s in want_q.steps],
              "shard queue: the step ledgers differ meshed vs meshless")
        print(f"[shard] world 1 ({backend}) queue: {SERVE_N} requests through "
              f"serve_stream with the meshed router: routed "
              f"{got_q.routed_carbon_g:.9g} g (meshless "
              f"{want_q.routed_carbon_g:.9g} g), shed {got_q.shed_count}, "
              f"steps {len(got_q.steps)}; decisions, carbon and routed gCO2 "
              f"identical to the meshless run; {wall:.4f} s")
        del want_q, got_q

        # --- the sharded xregion route -> danube -----------------------------
        fleet_handoff(torch, dev, results, seed, *xregion, "shard",
                      f"sharded xregion -> {DANUBE}")
        del xregion
    finally:
        dist.destroy_process_group()

    # --- worlds 2 and 4: spawned ranks sharing the card over gloo ----------
    for world in SHARD_WORLDS:
        t0 = time.perf_counter()
        records = spawn_world(world, tmp, str(dev))
        t_world = time.perf_counter() - t0
        for name in SHARD_SPAWNED:
            recs = [r[name] for r in records]
            for rank, r in enumerate(recs):
                check(r["digest"] == recs[0]["digest"],
                      f"shard world {world} {name}: rank {rank} returned "
                      f"another result than rank 0")
            bad = [k for k, v in digests[name].items()
                   if recs[0]["digest"][k] != v]
            check(not bad, f"shard world {world} {name}: {bad} differ from "
                  f"world 1")
            wall = max(r["wall"] for r in recs)
            print(f"[shard] world {world} (gloo, {world} ranks share one "
                  f"card, so the wall is not a scaling figure) {name}: "
                  f"routed {recs[0]['routed']:.9g} g, shed {recs[0]['shed']}"
                  f", spilled {recs[0]['spilled']}, deferred "
                  f"{recs[0]['deferred']}; every rank the same result; "
                  f"decisions, carbon and routed gCO2 bit-identical to world "
                  f"1; warm {wall:.4f} s (slowest rank)")
        print(f"[shard] world {world}: spawned, routed and joined in "
              f"{t_world:.1f} s")
    tmp_dir.cleanup()


# The serving loop's configurations (benchmarks/policy_throughput.py's
# forecast, queue and refit rows): 1M requests for the forecast and queue
# rows, the refit row's own 30k; card against CPU on whole streams of
# SERVE_CHECK_N (a serve loop is stateful: a prefix of a longer run is not
# the same run).
SERVE_N = 1_000_000
REFIT_N = 30_000
SERVE_CHECK_N = 50_000
SERVE_RTOL = 1e-5
SERVE_FIELDS = ("target", "exec_region", "exec_hour", "shed")


def queue_run(n: int, device, mesh=None):
    """The ``[serve]`` queue row: ``(router, run)``, where ``run()`` serves
    ``n`` ``diurnal_stream`` requests through ``serve_stream`` on the fully
    connected grid, placement with unit caps and a fresh pool of 2 workers
    per (region, DC tier) at 30,000 slots each; the router is sharded over
    ``mesh`` when given."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.carbon_intensity import DEFAULT_REGIONS, CarbonGrid
    from repro_torch.core.infrastructure import pack_infra, tpu_fleet
    from repro_torch.serve import (FleetRouter, OraclePolicy,
                                   PlacementPolicy, WorkerPool, serve_stream)
    from repro_torch.serve.streams import diurnal_stream

    R = len(DEFAULT_REGIONS)
    batch, region, t_hours = diurnal_stream(n, R)
    fr = FleetRouter(get_config(DANUBE), device=device, mesh=mesh,
                     grid=CarbonGrid.fully_connected(latency_penalty=1.05,
                                                     device=device),
                     policy=PlacementPolicy(OraclePolicy(
                         pack_infra(tpu_fleet(), device=device)),
                         np.ones((R, 3))))

    def run():
        pool = WorkerPool(R, slots_per_worker=30_000.0, launch_delay_steps=0)
        for r in range(R):
            for tier in (1, 2):
                pool.launch(r, tier, n=2)
        return serve_stream(fr, batch, region, t_hours, pool=pool)
    return fr, run


def serve_phase(torch, dev, results, profile: bool, seed: int) -> None:
    """Phase 7: the serving loop on the card, rebuilt from the port's own
    modules at the sizes of the repo's own results, held against the CPU on
    whole streams, then one queue step's edge-DC admissions served by the
    danube engine."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import (ALL_PAPER_WORKLOADS, ScenarioAxes,
                                  build_scenarios, explore, paper_fleet)
    from repro_torch.core.carbon_intensity import DEFAULT_REGIONS, CarbonGrid
    from repro_torch.core.constants import Target
    from repro_torch.core.infrastructure import pack_infra, tpu_fleet
    from repro_torch.core.schedulers import (ClassificationScheduler,
                                             build_dataset)
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer
    from repro_torch.serve import (EmissionsLedger, FleetRouter,
                                   LearnedPolicy, OnlineRefitter,
                                   OraclePolicy, PlacementPolicy,
                                   ServeEngine, TemporalPolicy, serve_stream)
    from repro_torch.serve.streams import (deferrable_stream_multiday,
                                           forecast_scenario)

    cfg = get_config(DANUBE)
    cpu = torch.device("cpu")
    R = len(DEFAULT_REGIONS)
    free = np.full((R, 3), np.inf)
    infra = lambda d: pack_infra(tpu_fleet(), device=d)

    def warm(fn):
        """(result, warm wall) of ``fn`` after one warm-up call."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same(name, got, want, fields=SERVE_FIELDS):
        """Card == CPU: every decision exactly, carbon within rtol."""
        for f in fields:
            bad = int((getattr(got, f) != getattr(want, f)).sum())
            check(bad == 0, f"{name}: {f} differs card vs CPU ({bad} rows)")
        check(np.allclose(got.carbon_g, want.carbon_g, rtol=SERVE_RTOL,
                          atol=0), f"{name}: carbon differs card vs CPU")
        err = np.max(np.abs(got.carbon_g - want.carbon_g)
                     / np.maximum(np.abs(want.carbon_g), 1e-30))
        print(f"[serve] {name} card == CPU on a whole {len(got.target)}-"
              f"request stream: {', '.join(fields)} identical; carbon max "
              f"rel err {err:.2e} (rtol {SERVE_RTOL:g})")

    # --- forecast: immediate vs one-shot blind vs rolling risk-aware -------
    def forecast(n, d):
        batch, region, t_hours, grid = forecast_scenario(
            n, DEFAULT_REGIONS, sigma_h=0.03, seed=0, device=d)
        mk = lambda pol: FleetRouter(cfg, grid=grid, policy=pol, device=d)
        return dict(
            immediate=lambda: mk(PlacementPolicy(OraclePolicy(infra(d)),
                                                 free)).route_stream(
                batch, region, t_hours),
            blind=lambda: mk(TemporalPolicy(OraclePolicy(infra(d)), free,
                                            max_defer_h=12)).route_stream(
                batch, region, t_hours),
            rolling=lambda: mk(TemporalPolicy(
                OraclePolicy(infra(d)), free, max_defer_h=12,
                risk_lambda=1.0)).route_stream_rolling(
                batch, region, t_hours, step_h=6, ledger=EmissionsLedger()))

    t0 = time.perf_counter()
    runs = forecast(SERVE_N, dev)
    t_stream = time.perf_counter() - t0
    g = {}
    for name, fn in runs.items():
        res, wall = warm(fn)
        routed = float(res.routed_carbon_g)
        check(np.isfinite(routed) and routed > 0,
              f"forecast {name}: non-finite or zero routed carbon")
        g[name] = routed
        steps = len(res.steps) if name == "rolling" else 1
        print(f"[serve] forecast {name}: {SERVE_N} requests, routed "
              f"{routed:.6g} g, deferred {int(res.deferred_count)}, shed "
              f"{int(res.shed_count)}, steps {steps}; warm {wall:.4f} s "
              f"({SERVE_N / wall:.0f} req/s); stream made in {t_stream:.2f} s")
        if profile and name == "rolling":
            device_profile(torch, fn, "serve forecast rolling")
    check(g["rolling"] < g["immediate"],
          f"rolling risk-aware deferral ({g['rolling']:.6g} g) failed to "
          f"beat immediate routing ({g['immediate']:.6g} g)")
    print(f"[serve] forecast gate: rolling {g['rolling']:.6g} g < immediate "
          f"{g['immediate']:.6g} g (saved {g['immediate'] - g['rolling']:.6g}"
          f" g; one-shot blind {g['blind']:.6g} g)")
    del runs
    same("forecast rolling", forecast(SERVE_CHECK_N, dev)["rolling"](),
         forecast(SERVE_CHECK_N, cpu)["rolling"](),
         SERVE_FIELDS + ("defer_hours",))
    torch.cuda.empty_cache()

    # --- queue: the continuous-batching loop through live worker slots -----
    fr_q, run_q = queue_run(SERVE_N, dev)
    res_q, wall = warm(run_q)
    check(np.isfinite(res_q.routed_carbon_g) and res_q.routed_carbon_g > 0,
          "queue: non-finite or zero routed carbon")
    check(sum(s.routed + s.shed for s in res_q.steps) == SERVE_N
          and res_q.steps[-1].queued_after == 0,
          "queue: the conservation ledger does not balance")
    print(f"[serve] queue: {SERVE_N} requests, routed "
          f"{res_q.routed_carbon_g:.6g} g, shed {res_q.shed_count}, steps "
          f"{len(res_q.steps)}, batches "
          f"{sum(s.n_batches for s in res_q.steps)}; warm {wall:.4f} s "
          f"({SERVE_N / wall:.0f} req/s)")
    if profile:
        device_profile(torch, run_q, "serve queue")
    same("queue", queue_run(SERVE_CHECK_N, dev)[1](),
         queue_run(SERVE_CHECK_N, cpu)[1](), SERVE_FIELDS + ("step",))

    # --- refit: static learned -> online refit -> oracle -------------------
    t0 = time.perf_counter()
    table = build_scenarios(paper_fleet(),
                            ScenarioAxes(hours=tuple(range(0, 24, 4))),
                            device=cpu)
    train = build_dataset(ALL_PAPER_WORKLOADS,
                          explore(ALL_PAPER_WORKLOADS, table),
                          table).split()[0]
    static = LearnedPolicy.fit(ClassificationScheduler(carbon_head=False),
                               train, device=cpu)
    t_fit = time.perf_counter() - t0
    bq, rq, tq = deferrable_stream_multiday(REFIT_N, R, n_days=2)
    caps = np.full((R, 3), np.inf)
    caps[:, 1] = caps[:, 2] = max(1.0, 0.6 * REFIT_N / (R * 48))

    def refit_run(kind, d):
        inner = (OraclePolicy(infra(d)) if kind == "oracle" else
                 dataclasses.replace(static.to(d), infra=infra(d)))
        fr = FleetRouter(cfg, device=d, grid=CarbonGrid.fully_connected(
            latency_penalty=1.05, n_days=2, device=d),
            policy=TemporalPolicy(inner, caps, max_defer_h=16))
        refitter = (OnlineRefitter(min_observations=max(256, REFIT_N // 12),
                                   refit_every=max(512, REFIT_N // 6))
                    if kind == "refit" else None)
        return serve_stream(fr, bq, rq, tq, step_h=2, refitter=refitter), \
            refitter

    g = {}
    for kind in ("static", "refit", "oracle"):
        (res, refitter), wall = warm(lambda: refit_run(kind, dev))
        g[kind] = res.routed_carbon_g
        check(np.isfinite(g[kind]) and g[kind] > 0,
              f"refit {kind}: non-finite or zero routed carbon")
        extra = f", refits {res.refits}" if kind == "refit" else ""
        print(f"[serve] refit {kind}: {REFIT_N} requests, routed "
              f"{g[kind]:.6g} g, shed {res.shed_count}, deferred "
              f"{res.deferred_count}{extra}; warm {wall:.4f} s "
              f"({REFIT_N / wall:.0f} req/s)")
        if kind == "refit":
            res_refit, router_refit = res, refitter.router
    gap = g["static"] - g["oracle"]
    closed = (g["static"] - g["refit"]) / max(gap, 1e-9)
    print(f"[serve] refit: static {g['static']:.6g} g -> refit "
          f"{g['refit']:.6g} g -> oracle {g['oracle']:.6g} g; {closed:.1%} "
          f"of the static-to-oracle gap closed; static fit on "
          f"{len(train.labels)} design-space rows in {t_fit:.2f} s (host)")
    check(g["refit"] <= g["static"] * 1.001,
          f"online refit ({g['refit']:.6g} g) routed dirtier than the static "
          f"learned policy ({g['static']:.6g} g)")
    res_cpu, _ = refit_run("refit", cpu)
    flipped = np.nonzero((res_refit.target != res_cpu.target)
                         | (res_refit.exec_region != res_cpu.exec_region)
                         | (res_refit.exec_hour != res_cpu.exec_hour))[0]
    if len(flipped):
        # the final refitted scorer's tier scores at the flipped rows'
        # arrival cells: how close to a tie each decision was
        sub = dataclasses.replace(bq, **{
            f: np.asarray(getattr(bq, f))[flipped]
            for f in ("prompt_tokens", "max_new_tokens", "latency_budget_s",
                      "bytes_per_token", "available", "slack_hours")})
        w = sub.workload(cfg, device=dev)
        env = router_refit.env_at(0, 0)
        hour = torch.as_tensor(np.floor(tq[flipped]).astype(np.int64),
                               device=dev)
        ci = router_refit._ci_table[torch.as_tensor(rq[flipped], device=dev)
                                    .long(), hour]
        s = router_refit.policy.inner._score_rows(
            w, ci, env.interference, env.net_slowdown, hour)
        top2 = torch.sort(s, dim=1).values[:, :2].cpu().numpy()
        print(f"[serve] refit card vs CPU: {len(flipped)} flipped "
              f"decisions; top-two score gaps "
              f"{np.round(top2[:, 1] - top2[:, 0], 9).tolist()[:20]}")
    check(len(flipped) == 0, f"refit: {len(flipped)} decisions flip card "
          f"vs CPU")
    same("refit", res_refit, res_cpu, SERVE_FIELDS + ("step",))
    check(res_refit.refits == res_cpu.refits,
          "refit: the refit count differs card vs CPU")
    torch.cuda.empty_cache()

    # --- the handoff: one queue step's edge-DC admissions -> danube ---------
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg, device=dev, dtype=torch.float32, generator=gen)
    engine = ServeEngine(cfg, model, max_seq=PROMPT + NEW + 8,
                         tier=int(Target.EDGE_DC), device=dev)
    batches = fr_q.admit_windows(None, None, engine, queue=res_q)
    step = next((i for i, idx in enumerate(batches) if len(idx) >= 4), None)
    check(step is not None, "no serve step admitted 4 edge-DC requests")
    picked = batches[step][:4]
    check(bool((res_q.target[picked] == int(Target.EDGE_DC)).all()
               and not res_q.shed[picked].any()),
          "admitted requests are not committed to the edge DC")
    prompt = torch.randint(0, cfg.vocab_size, (4, PROMPT), generator=gen,
                           device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    tokens = engine.generate(prompt, max_new_tokens=NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = dict({k: 0 for k in launches}, flash_attention=cfg.n_layers,
                fused_rmsnorm=(2 * cfg.n_layers + 1) * NEW)
    check(launches == want, f"serve handoff: launch counts {launches}, "
          f"expected {want}")
    check(tuple(tokens.shape) == (4, NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
        "serve handoff: tokens")
    for name, r in results.items():
        r["launches_by_path"][f"queue -> {DANUBE}"] = launches[name]
    print(f"[serve] handoff: serve step {int(res_q.step[picked[0]])} h "
          f"admitted {len(batches[step])} edge-DC requests of the queue run; "
          f"served requests {picked.tolist()} (exec regions "
          f"{res_q.exec_region[picked].tolist()}) through {DANUBE} f32, "
          f"prompt ({len(picked)}, {PROMPT}), {NEW} new tokens in "
          f"{wall:.3f} s; launches {launches}")
    del model, engine
    torch.cuda.empty_cache()


# The scenario matrix (the reference's benchmarks/scenario_matrix.py at
# 1M requests a scenario; the flash crowd draws ~2.36M), its card == CPU
# check on whole 20k streams, and the watt-caps gate's stream size.
SCEN_N = 1_000_000
SCEN_CHECK_N = 20_000
WATT_GATE_N = 200_000
SCEN_RTOL = 1e-5
# The README's mesoscale provisioning table (20k requests, 128-site sparse
# grid, paper fleet, 64 slots a server): (server-hours, total gCO2 rounded)
MESO_PIN = {"static-overprovision": (6144, 1_035_304),
            "oracle": (5788, 973_133), "provisioned": (5788, 973_133),
            "slo_0.02": (5257, 792_473)}
PROV_N = 1_000_000
PROV_CHECK_N = 50_000


def scenarios_phase(torch, dev, profile: bool) -> None:
    """Phase 8: the 21 (scenario, policy) cells of the scenario matrix on
    the card at SCEN_N requests a scenario (warm wall after one warm-up
    route), card == CPU on every cell at SCEN_CHECK_N, then the three
    gates."""
    import numpy as np

    from repro_torch.launch import scenario_matrix as sm
    from repro_torch.serve import scenarios as sc

    t0 = time.perf_counter()
    rows = sm.matrix_rows(SCEN_N, device=dev)
    print(f"[scenarios] {len(rows)} cells routed in "
          f"{time.perf_counter() - t0:.1f} s (streams built on the host, "
          f"one warm-up route a cell)")
    cells = [c for c, _ in rows]
    for c, wall in rows:
        check(all(np.isfinite(v) for v in (c.total_g, c.routed_g,
                                           c.latency_opt_g))
              and c.total_g > 0, f"{c.scenario}/{c.policy}: non-finite "
              f"carbon")
        print(f"[scenarios] {c.scenario}/{c.policy}: n {c.n}, total "
              f"{c.total_g:.6g} g, routed {c.routed_g:.6g} g, "
              f"latency-optimal {c.latency_opt_g:.6g} g, shed "
              f"{c.shed_rate:.4f}, spill {c.spill_rate:.4f}, defer "
              f"{c.defer_rate:.4f}, mean defer {c.mean_defer_h:.3f} h; "
              f"warm {wall:.4f} s ({c.n / wall:.0f} req/s)")
    if profile:
        run = sc.default_scenarios()["steady_diurnal"].build(SCEN_N)
        fr = sc.scenario_router(run, sc.default_policies()["temporal-defer"],
                                device=dev)
        route = lambda: fr.route_stream(run.batch, run.region, run.t_hours)
        route()  # warm-up
        device_profile(torch, route,
                       "scenarios steady_diurnal/temporal-defer")
        del run, fr
    torch.cuda.empty_cache()

    # card against CPU: each package routes the same whole 20k stream
    host = lambda x: x.cpu().numpy()
    worst, flips = 0.0, 0
    for sname, scenario in sc.default_scenarios().items():
        for pname, factory in sc.default_policies().items():
            got = {}
            for d in (dev, "cpu"):
                res, state, run = sc.route_scenario(
                    scenario, factory, n=SCEN_CHECK_N, device=d)
                check(res.target.device.type == torch.device(d).type,
                      f"{sname}/{pname}: targets not on {d}")
                ex_h = getattr(state, "exec_hour", None)
                got[str(d)] = (
                    {"target": host(res.target),
                     "exec_region": host(res.exec_region),
                     "exec_hour": (np.floor(run.t_hours).astype(np.int64)
                                   if ex_h is None else host(ex_h)),
                     "shed": host(state.shed), "counts": host(res.counts)},
                    host(res.carbon_g), sc._cell(sname, pname,
                                                 len(run.batch), res))
            card, cpu = got[str(dev)], got["cpu"]
            for k, v in cpu[0].items():
                bad = int((card[0][k] != v).sum())
                flips += bad
                check(bad == 0, f"{sname}/{pname}: {k} differs card vs CPU "
                      f"at {SCEN_CHECK_N} ({bad} entries)")
            check(np.allclose(card[1], cpu[1], rtol=SCEN_RTOL, atol=0),
                  f"{sname}/{pname}: carbon differs card vs CPU")
            a, b = card[2], cpu[2]
            check((a.n, a.shed_rate, a.spill_rate, a.defer_rate)
                  == (b.n, b.shed_rate, b.spill_rate, b.defer_rate),
                  f"{sname}/{pname}: rates differ card vs CPU")
            for f in ("total_g", "routed_g", "latency_opt_g",
                      "mean_defer_h"):
                x, y = getattr(a, f), getattr(b, f)
                check(abs(x - y) <= SCEN_RTOL * abs(y),
                      f"{sname}/{pname}: {f} differs card vs CPU")
            worst = max(worst, float(np.max(
                np.abs(card[1] - cpu[1]) / np.maximum(np.abs(cpu[1]),
                                                      1e-30))))
    print(f"[scenarios] card == CPU on all {len(cells)} cells at "
          f"{SCEN_CHECK_N} requests a scenario: target, exec region/hour, "
          f"shed, counts identical ({flips} flips); carbon max rel err "
          f"{worst:.2e} (rtol {SCEN_RTOL:g})")

    # the three gates, which raise when they fail
    for name, fn in (
            ("curtailment_chase",
             lambda: sm.curtailment_gate(cells, SCEN_N, device=dev)),
            ("spike_aware", lambda: sm.spike_aware_gate(SCEN_N, device=dev)),
            ("watt_caps",
             lambda: sm.watt_caps_gate(WATT_GATE_N, device=dev))):
        t0 = time.perf_counter()
        try:
            out = fn()
        except AssertionError as e:
            fail(f"scenario gate {name}: {e}")
        derived = ", ".join(f"{k} {v:.6g}" if isinstance(v, float)
                            else f"{k} {v}" for k, v in out.items())
        print(f"[scenarios] gate {name}: PASS ({derived}) in "
              f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()


def provision_phase(torch, dev, profile: bool) -> None:
    """Phase 9: provisioning on the 128-site sparse grid: the README's 20k
    pin exactly (card == CPU), the four plans of a PROV_N stream and the
    plan-driven serve loop at PROV_N (warm wall after one warm-up run),
    then card == CPU on a PROV_CHECK_N stream with its own plan."""
    import numpy as np

    from repro_torch.launch import scenario_matrix as sm
    from repro_torch.serve import serve_stream

    # --- the README's pin --------------------------------------------------
    try:
        pin = {d: sm.mesoscale_pin(device=d) for d in (dev, "cpu")}
    except AssertionError as e:
        fail(f"mesoscale provisioning gate: {e}")
    card, cpu = pin[dev], pin["cpu"]
    for p, q in zip(card["plans"], cpu["plans"]):
        hours, total = MESO_PIN[p.name]
        print(f"[provision] pin {sm.MESO_N} {p.name}: server-hours "
              f"{p.server_hours}, total {p.total_carbon_g:.6f} g "
              f"(operational {p.operational_g:.6g}, embodied "
              f"{p.embodied_g:.6g}), forecast shed {p.shed_rate:.4f}")
        check((p.server_hours, round(p.total_carbon_g)) == (hours, total),
              f"mesoscale pin {p.name}: ({p.server_hours}, "
              f"{round(p.total_carbon_g)}) is not the README's "
              f"({hours}, {total})")
        check(np.array_equal(p.servers, q.servers)
              and p.total_carbon_g == q.total_carbon_g,
              f"mesoscale pin {p.name}: plan differs card vs CPU")
    a, b = card["serve"], cpu["serve"]
    for f in ("target", "exec_region", "exec_hour", "shed", "step"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"mesoscale pin serve: {f} differs card vs CPU")
    print(f"[provision] pin: README table exact; serve_stream(plan="
          f"provisioned) on {sm.MESO_N} requests: shed {a.shed_count}, routed "
          f"{a.routed_carbon_g:.6g} g; card == CPU")

    # --- PROV_N: four plans and the plan-driven serve loop ------------------
    t0 = time.perf_counter()
    m = sm.mesoscale_plans(PROV_N, device=dev)
    prov, slo, stat, orac = m.provisioned, m.slo, m.static, m.oracle
    fr, stream = m.router, m.stream
    t_plan = time.perf_counter() - t0
    for p in (prov, slo, stat, orac):
        print(f"[provision] {PROV_N} plan {p.name}: server-hours "
              f"{p.server_hours}, total {p.total_carbon_g:.6g} g "
              f"(operational {p.operational_g:.6g}, embodied "
              f"{p.embodied_g:.6g}), forecast shed {p.shed_rate:.4f}")
    check(prov.total_carbon_g < stat.total_carbon_g
          and prov.shed_rate <= stat.shed_rate + 1e-12,
          "provisioned plan does not beat static over-provisioning")
    check(slo.total_carbon_g <= orac.total_carbon_g,
          "the 2% SLO plan is dirtier than the oracle")
    print(f"[provision] plans built in {t_plan:.2f} s (stream, demand, four "
          f"plans, host numpy)")
    served = {}
    for plan in (prov, stat):
        run = lambda: serve_stream(fr, *stream, plan=plan)
        run()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        served[plan.name] = res
        check(np.isfinite(res.routed_carbon_g) and res.routed_carbon_g > 0,
              f"serve with {plan.name}: non-finite or zero routed carbon")
        check(sum(s.routed + s.shed for s in res.steps) == PROV_N
              and res.steps[-1].queued_after == 0,
              f"serve with {plan.name}: the conservation ledger does not "
              f"balance")
        print(f"[provision] serve_stream(plan={plan.name}): {PROV_N} "
              f"requests, shed {res.shed_count}, routed "
              f"{res.routed_carbon_g:.6g} g, standing "
              f"{plan.total_carbon_g:.6g} g, steps {len(res.steps)}, "
              f"batches {sum(s.n_batches for s in res.steps)}; warm "
              f"{wall:.4f} s ({PROV_N / wall:.0f} req/s)")
        if profile and plan is prov:
            device_profile(torch, run, "provision serve_stream(plan=)")
    qp, qs = served[prov.name], served[stat.name]
    check(prov.total_carbon_g + qp.routed_carbon_g
          < stat.total_carbon_g + qs.routed_carbon_g,
          "provisioned standing + routed carbon is not below static's")
    print(f"[provision] gate: provisioned standing + routed "
          f"{prov.total_carbon_g + qp.routed_carbon_g:.6g} g < static "
          f"{stat.total_carbon_g + qs.routed_carbon_g:.6g} g")
    del m, fr, served, qp, qs
    torch.cuda.empty_cache()

    # --- card == CPU on a PROV_CHECK_N stream with its own plan -------------
    got = {}
    for d in (dev, "cpu"):
        m = sm.mesoscale_plans(PROV_CHECK_N, device=d)
        got[str(d)] = (m.provisioned, serve_stream(m.router, *m.stream,
                                                   plan=m.provisioned))
    (pc, a), (pp, b) = got[str(dev)], got["cpu"]
    check(np.array_equal(pc.servers, pp.servers)
          and pc.total_carbon_g == pp.total_carbon_g,
          "provisioned plan differs card vs CPU")
    for f in ("target", "exec_region", "exec_hour", "shed", "step"):
        bad = int((getattr(a, f) != getattr(b, f)).sum())
        check(bad == 0, f"plan-driven serve: {f} differs card vs CPU "
              f"({bad} rows)")
    check(np.allclose(a.carbon_g, b.carbon_g, rtol=SCEN_RTOL, atol=0),
          "plan-driven serve: carbon differs card vs CPU")
    err = np.max(np.abs(a.carbon_g - b.carbon_g)
                 / np.maximum(np.abs(b.carbon_g), 1e-30))
    print(f"[provision] card == CPU on a whole {PROV_CHECK_N}-request "
          f"stream with its own plan ({pc.server_hours} server-hours): "
          f"plan, target, exec region/hour, shed, step identical; carbon "
          f"max rel err {err:.2e} (rtol {SCEN_RTOL:g})")
    torch.cuda.empty_cache()


def tour_phase(torch, results) -> None:
    """Phase 10: the ten-act tour at its default 1M requests with the full
    danube engine in f32, the launch counters set to 0 just before it and
    read just after: one prefill (24 flash) and 8 forward passes (49
    RMSNorm each) in act 3, no SSD scan, no grouped matmul."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import tour

    ops.reset_launches()
    t0 = time.perf_counter()
    run = tour.main(["--device", "cuda", "--no-smoke", "--learned"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cfg = get_config(DANUBE)
    tokens = run.acts[3]["tokens"]
    passes = tokens.shape[1]  # one prefill + (new tokens - 1) decode steps
    want = dict({k: 0 for k in launches}, flash_attention=cfg.n_layers,
                fused_rmsnorm=(2 * cfg.n_layers + 1) * passes)
    check(launches == want, f"tour: launch counts {launches}, expected "
          f"{want}")
    check(run.acts[3]["engine"] == DANUBE, "tour: the engine is not the "
          "full config")
    check(tokens.shape == (4, 8) and bool(((tokens >= 0)
                                            & (tokens < cfg.vocab_size))
                                           .all()), "tour: tokens")
    check(sorted(run.acts) == list(range(1, 11)), "tour: acts missing")
    a2 = run.acts[2]
    check(np.isfinite(a2["total_carbon_g"]) and a2["total_carbon_g"] > 0
          and int(a2["counts"].sum()) == run.requests,
          "tour act 2: routed counts or carbon")
    a9 = run.acts[9]
    check(a9["refit_g"] <= a9["static_g"] * 1.001,
          "tour act 9: the online refit routed dirtier than the static "
          "learned policy")
    for name, r in results.items():
        r["launches_by_path"][f"tour -> {DANUBE}"] = launches[name]
    print(f"[tour] ten acts at {run.requests} requests in {wall:.1f} s: act 2 "
          f"{a2['total_carbon_g']:.6g} g in {a2['wall_s']:.4f} s warm; act 3 "
          f"engine {DANUBE} f32 generated {tokens.shape} tokens in "
          f"{run.acts[3]['generate_s']:.3f} s; act 9 static "
          f"{a9['static_g']:.6g} g -> refit {a9['refit_g']:.6g} g "
          f"(oracle {a9['oracle_g']:.6g} g, {a9['refits']} refits); "
          f"launches {launches}")
    torch.cuda.empty_cache()


# The model branches (phase 10): whisper-base f32 through the launcher at
# a 128-token prompt against 1500 encoder frames; qwen2-vl-7b bf16 through
# the launcher (text-only, as the reference launcher runs it), then with
# 1024 patch embeddings over the first 1024 of a 1280-token prompt at
# grid positions; jamba-v0.1-52b bf16 through the engine at 16 of its 32
# layers (two whole 8-layer super-blocks, ~26 B params, ~52 GB: the full
# 103 GB does not fit the card, three super-blocks leave no room for
# activations and caches).
WHISPER, QWEN2VL, JAMBA = "whisper-base", "qwen2-vl-7b", "jamba-v0.1-52b"
NEMOTRON = "nemotron-3-nano-30b-a3b"
WHISPER_PROMPT = 128
VLM_PROMPT, VLM_GRID = 1280, 32  # 32 x 32 = 1024 patches, then 256 text
JAMBA_LAYERS = 16


def grid_positions(torch, batch: int, seq: int, side: int, device):
    """(3, B, S) M-RoPE positions of a side x side patch grid followed by
    text: patch i at (t 0, h i // side, w i % side), text token j at
    t = h = w = side + j."""
    n = side * side
    i = torch.arange(n, device=device)
    text = side + torch.arange(seq - n, device=device)
    pos = torch.stack([torch.cat([torch.zeros_like(i), text]),
                       torch.cat([i // side, text]),
                       torch.cat([i % side, text])])
    return pos[:, None].expand(3, batch, seq).contiguous()


def layers_vs_plain(torch, run, label: str, tag: str) -> None:
    """A bf16 model's kernels against the plain versions layer by layer:
    the plain path's prefill, recording what enters each attention layer
    (its norm1 output), each MoE layer and each SSD scan; then each through
    the kernels and through the plain versions on that same input. With one
    input the routing is one, so the MoE outputs compare at the bf16
    tolerance (whole-model bf16 logits do not: one flipped top-k choice
    upstream moves them far)."""
    import dataclasses

    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.moe import moe_forward

    model = run.engine.model
    cfg = model.cfg
    normed, moe_in, ssd_in = {}, {}, []
    hooks = []
    for i, layer in enumerate(model.layers):
        if layer.kind.mixer == "attn":
            hooks.append(layer.norm1.register_forward_hook(
                lambda mod, args, out, i=i: normed.__setitem__(i, out)))
        if layer.kind.ff == "moe":
            hooks.append(layer.moe.register_forward_pre_hook(
                lambda mod, args, i=i: moe_in.__setitem__(
                    i, args[0].clone())))

    def ssd_recorded(*args, **kw):
        ssd_in.append((args, kw))
        return ref.ssd_ref(*args, **kw)

    with torch.no_grad():
        lp, _ = model.prefill(
            run.prompt, max_seq=run.engine.max_seq, **run.extras,
            kernels=dataclasses.replace(ops.PLAIN, ssd_scan=ssd_recorded))
    for h in hooks:
        h.remove()
    check(bool(torch.isfinite(lp).all()), f"{label}: plain prefill")
    del lp
    kinds = [(layer.kind.mixer, layer.kind.ff) for layer in model.layers]
    check((len(normed), len(moe_in), len(ssd_in)) == (
        sum(m == "attn" for m, _ in kinds), sum(f == "moe" for _, f in kinds),
        sum(m == "mamba" for m, _ in kinds)),
        f"{label}: a layer's input was not recorded")
    positions = model._positions(run.prompt, run.extras.get("positions"))
    tol = TOL["bfloat16"]
    worst = {"attention": 0.0, "MoE": 0.0, "SSD y": 0.0, "SSD state": 0.0}

    def held(kind, i, got, want, tol_):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst[kind] = max(worst[kind], err)
        check(torch.allclose(got.float(), want.float(), atol=tol_,
                             rtol=tol_),
              f"{label} layer {i}: {kind} through the kernels disagrees "
              f"with the plain versions (max_abs_err {err:.3e})")

    with torch.no_grad():
        for i, h in normed.items():
            layer = model.layers[i]
            held("attention", i, *(attn_mod.attention(
                layer.attn, cfg, h, positions, ks)[0]
                for ks in (ops.KERNELS, ops.PLAIN)), tol)
        for i, h in moe_in.items():
            held("MoE", i, *(moe_forward(model.layers[i].moe, cfg, h,
                                         kernels=ks)[0]
                             for ks in (ops.KERNELS, ops.PLAIN)), tol)
        for j, (args, kw) in enumerate(ssd_in):
            (y, st), (yr, sr) = (ops.ssd_scan(*args, **kw),
                                 ref.ssd_ref(*args, **kw))
            held("SSD y", j, y, yr, SSD_Y_TOL[dtype_name(y.dtype)])
            held("SSD state", j, st, sr, SSD_STATE_TOL)
    print(f"[{tag}] {label} layer by layer, kernels vs plain on the "
          f"plain path's inputs: {len(normed)} attention, {len(moe_in)} "
          f"MoE, {len(ssd_in)} SSD layers; worst max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (atol = rtol = {tol:g}; SSD y "
          f"{SSD_Y_TOL['bfloat16']:g}, state {SSD_STATE_TOL:g})")


def branches_phase(torch, dev, results, profile: bool, seed: int, card: str,
                   drive, warm, kernels_vs_plain) -> None:
    """Phase 11: serve the model branches at full width on the card with
    exact launch counters, hold their kernels against the plain versions
    (whisper's prefill logits whole; qwen2-vl's, jamba's and nemotron's
    attention, MoE and SSD layer by layer), then card == CPU on the smoke
    configs of the first three."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import Transformer, kernel_launches
    from repro_torch.serve import ServeEngine

    def engine_run(label, model, prompt, extras):
        """A ServeEngine batch with the counters set to 0 just before it
        and read just after; the counts must equal ``kernel_launches``."""
        engine = ServeEngine(model.cfg, model, device=dev,
                             max_seq=prompt.shape[1] + NEW + 8)
        ops.reset_launches()
        t0 = time.perf_counter()
        tokens = engine.generate(prompt, max_new_tokens=NEW, **extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        want = dict({k: 0 for k in launches},
                    **kernel_launches(model.cfg, NEW - 1))
        check(launches == want, f"{label}: launch counts {launches}, "
              f"expected {want}")
        check(tuple(tokens.shape) == (BATCH, NEW) and bool(
            ((tokens >= 0) & (tokens < model.cfg.vocab_size)).all()),
            f"{label}: tokens")
        print(f"[branches] {label}: prompt {tuple(prompt.shape)}, {NEW} new "
              f"tokens in {wall:.3f} s; launches {launches}")
        for name, r in results.items():
            r["launches_by_path"][label] = launches[name]
        run = serve.ServeRun(cfg=model.cfg, decision=None, engine=engine,
                             prompt=prompt, tokens=tokens, extras=extras)
        warm(run, label, tag="branches", card=f" [{card}]")
        return run

    # --- whisper-base, f32, through the launcher ---------------------------
    cfg_w = get_config(WHISPER)
    run = drive(WHISPER, "float32", kernel_launches(cfg_w, NEW - 1),
                prompt=WHISPER_PROMPT)
    warm(run, WHISPER, tag="branches", card=f" [{card}]")
    kernels_vs_plain(run, WHISPER)
    run = None
    torch.cuda.empty_cache()

    # --- qwen2-vl-7b, bf16: launcher text-only, then patches on a grid -----
    cfg_v = get_config(QWEN2VL)
    run = drive(QWEN2VL, "bfloat16", kernel_launches(cfg_v, NEW - 1))
    warm(run, QWEN2VL, tag="branches", card=f" [{card}]")
    layers_vs_plain(torch, run, f"{QWEN2VL} text", "branches")
    model = run.engine.model
    run = None
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg_v.vocab_size, (BATCH, VLM_PROMPT),
                           generator=gen, device=dev)
    extras = {"patch_embeds": (torch.randn(
        (BATCH, VLM_GRID * VLM_GRID, cfg_v.d_model), generator=gen,
        device=dev) * 0.02).to(torch.bfloat16),
        "positions": grid_positions(torch, BATCH, VLM_PROMPT, VLM_GRID, dev)}
    run = engine_run(f"{QWEN2VL} patches", model, prompt, extras)
    layers_vs_plain(torch, run, f"{QWEN2VL} patches", "branches")
    del model
    run = None
    torch.cuda.empty_cache()

    # --- jamba-v0.1-52b, bf16, 16 layers, through the engine --------------
    cfg_j = dataclasses.replace(get_config(JAMBA), n_layers=JAMBA_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg_j, device=dev, dtype=torch.bfloat16,
                        generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg_j.param_count(), "jamba parameter count")
    print(f"[branches] {JAMBA}: depth cut to {JAMBA_LAYERS} of "
          f"{get_config(JAMBA).n_layers} layers (two 8-layer super-blocks; "
          f"the full model's {get_config(JAMBA).param_count() * 2 / 1e9:.1f}"
          f" GB of bf16 weights exceed the card), {n_params / 1e9:.3f} B "
          f"bf16 params, {torch.cuda.memory_allocated() / 1e9:.1f} GB "
          f"allocated; built in {time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg_j.vocab_size, (BATCH, PROMPT),
                           generator=gen, device=dev)
    label = f"{JAMBA} ({JAMBA_LAYERS} layers)"
    run = engine_run(label, model, prompt, {})
    layers_vs_plain(torch, run, label, "branches")
    del model
    run = None
    torch.cuda.empty_cache()

    # --- nemotron-3-nano-30b-a3b, bf16, whole, through the engine ---------
    cfg_n = get_config(NEMOTRON)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg_n, device=dev, dtype=torch.bfloat16,
                        generator=gen)
    with torch.no_grad():  # the correction bias, drawn as the cell draws it
        for name, p in model.named_parameters():
            if name.endswith("e_score_correction_bias"):
                p.normal_(0.0, 0.01, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg_n.param_count(), "nemotron parameter count")
    print(f"[branches] {NEMOTRON}: {cfg_n.n_layers} single-kind blocks "
          f"{cfg_n.layer_pattern}, {n_params / 1e9:.3f} B bf16 params, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated; built in "
          f"{time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg_n.vocab_size, (BATCH, PROMPT),
                           generator=gen, device=dev)
    run = engine_run(NEMOTRON, model, prompt, {})
    layers_vs_plain(torch, run, NEMOTRON, "branches")
    del model
    run = None
    torch.cuda.empty_cache()

    # --- card against CPU on the smoke configs -----------------------------
    for arch in (WHISPER, QWEN2VL, JAMBA):
        smoke = get_config(arch, smoke=True)
        cpu_model = Transformer(smoke, device="cpu",
                                generator=torch.Generator().manual_seed(1))
        gpu_model = Transformer(smoke, device=dev)
        gpu_model.load_state_dict(cpu_model.state_dict())
        g = torch.Generator().manual_seed(2)
        toks = torch.randint(0, smoke.vocab_size, (2, 40), generator=g)
        extras = {}
        if smoke.is_encoder_decoder:
            extras["encoder_frames"] = torch.randn(
                (2, smoke.encoder_seq, smoke.d_model), generator=g) * 0.02
        if smoke.mrope:
            extras["patch_embeds"] = torch.randn(
                (2, 16, smoke.d_model), generator=g) * 0.02
            extras["positions"] = grid_positions(torch, 2, 40, 4, "cpu")
        on_dev = {k: v.to(dev) for k, v in extras.items()}
        lc, _ = cpu_model.prefill(toks, max_seq=64, **extras)
        lg, _ = gpu_model.prefill(toks.to(dev), max_seq=64, **on_dev)
        err = (lg.cpu() - lc).abs().max().item()
        check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4),
              f"{smoke.name} logits on the card disagree with the CPU "
              f"(max_abs_err {err:.3e})")
        eng = {d: ServeEngine(smoke, m, max_seq=64, device=d)
               for d, m in (("cpu", cpu_model), ("cuda", gpu_model))}
        tc = eng["cpu"].generate(toks, max_new_tokens=12, **extras)
        tg = eng["cuda"].generate(toks, max_new_tokens=12, **extras)
        check(torch.equal(tc, tg.cpu()),
              f"{smoke.name} greedy tokens differ card vs CPU")
        print(f"[branches] {smoke.name} card vs CPU: prefill logits "
              f"max_abs_err {err:.3e} (atol = rtol = 1e-4); greedy tokens "
              f"equal")
    torch.cuda.empty_cache()


# --- [train]: the training path ------------------------------------------
# Full-width training through the launcher (arch, batch, seq, remat), f32,
# TF32 off: 1 cold step and TRAIN_STEPS - 1 warm ones each. danube's 1.8 B
# params, grads and AdamW moments take ~29 GB; at (1, 4096), the
# reference's train_4k length, its attention takes the blocked causal
# form (Sq > 2 x attn_block_q; its 4096 window covers every key, so it is
# dropped); at 512 the dense one. mamba2's state takes ~12.5 GB; whisper
# trains its encoder over 1500 stub frames and the cross attention.
TRAIN_FULL = [(DANUBE, 4, 512, "dots"), (DANUBE, 1, 4096, "dots"),
              (MAMBA, 4, 512, "dots"), (WHISPER, 4, 128, "dots")]
TRAIN_EQ_RUN = (DANUBE, 4, 512)  # where remat and microbatches are compared
TRAIN_STEPS = 6
TRAIN_EQ_RTOL = 1e-5  # remat policies and microbatches on danube
TRAIN_CPU_RTOL = 1e-4  # smoke losses, card against CPU
TRAIN_RESUME_ATOL = 1e-6  # embedding backward on CUDA may use atomics
TRAIN_SMOKE = (DANUBE, MAMBA, QWEN3, WHISPER, QWEN2VL, JAMBA)
TRAIN_DP_WORLD = 2
TRAIN_DP_MODES = ("int8", "bf16")
TRAIN_DP_STEPS = 3
TRAIN_TIMEOUT_S = 300


def train_rank(rank: int, world: int, store: str, out: str,
               device: str) -> None:
    """One spawned rank of a gloo world: for each of ``TRAIN_DP_MODES``,
    ``TRAIN_DP_STEPS`` compressed data-parallel steps of the danube smoke
    model on this rank's shard, on ``device``; writes the sha256 of the
    final parameters, the losses and (rank 0) the parameters themselves
    under ``out``."""
    import datetime
    import hashlib
    import os

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":  # every rank on the same card
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=TRAIN_TIMEOUT_S))
    try:
        record = {}
        for mode in TRAIN_DP_MODES:
            model, state, step, make_batch = dp_setup(
                torch, dev, mode, mesh=dist.group.WORLD)
            losses = []
            for i in range(TRAIN_DP_STEPS):
                state, m = step(state, make_batch(i, rank, world))
                losses.append(float(m["loss"]))
            flat = torch.cat([p.detach().reshape(-1).cpu()
                              for p in state.params.values()])
            record[mode] = dict(losses=losses, digest=hashlib.sha256(
                flat.numpy().tobytes()).hexdigest())
            if rank == 0:
                torch.save({k: v.detach().cpu() for k, v in
                            state.params.items()},
                           os.path.join(out, f"params_{mode}.pt"))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()


def dp_setup(torch, dev, mode: str, mesh=None):
    """The danube smoke model (seeded on the host, so every process
    builds the same one), AdamW, its state, the step (compression
    ``mode`` over ``mesh``, none without one) and the batch of
    (step, shard, n_shards): 32 tokens, a global batch of 8."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, ShapeKind
    from repro_torch.data import batch_for
    from repro_torch.models import Transformer
    from repro_torch.train import adamw, constant_lr, init_train_state
    from repro_torch.train import make_train_step

    cfg = get_config(DANUBE, smoke=True)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(5)).to(dev)
    opt = adamw(constant_lr(1e-3))
    state = init_train_state(dict(model.named_parameters()), opt,
                             compression=mode if mesh is not None else "none")
    step = make_train_step(model, opt, mesh=mesh, compression=(
        mode if mesh is not None else "none"))
    shape = ShapeConfig("dp", ShapeKind.TRAIN, 32, 8)

    def make_batch(i, shard, n_shards):
        return batch_for(cfg, shape, step=i, shard=shard, n_shards=n_shards,
                         device=dev)

    return model, state, step, make_batch


def dp_model(torch, dev, mode: str) -> tuple[dict, list]:
    """The reference's per-rank ``compress_and_reduce`` arithmetic, written
    out for ``TRAIN_DP_WORLD`` ranks in this one process: each rank's
    gradient on its shard plus its residual; bf16: the bf16 values summed
    (one add for two ranks); int8: the largest |value| of each tensor over
    the ranks, / 127, the rounded values clipped to +-127 and summed
    exactly; the mean to AdamW, each residual the value minus what it
    sent. Returns (final parameters, mean losses)."""
    from repro_torch.train import adamw, constant_lr
    from repro_torch.train.train_step import grads_over_microbatches

    model, state, _, make_batch = dp_setup(torch, dev, mode)
    opt_update = adamw(constant_lr(1e-3)).update
    n = TRAIN_DP_WORLD
    ef = [{k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in state.params.items()} for _ in range(n)]
    losses = []
    for i in range(TRAIN_DP_STEPS):
        per = [grads_over_microbatches(model, state.params,
                                       make_batch(i, r, n), remat="dots")
               for r in range(n)]
        losses.append(sum(float(m["loss"]) for _, m in per) / n)
        mean = {}
        for k in state.params:
            comp = [g[k].float() + e[k] for (g, _), e in zip(per, ef)]
            if mode == "bf16":
                sent = [c.to(torch.bfloat16).float() for c in comp]
                summed = (comp[0].to(torch.bfloat16)
                          + comp[1].to(torch.bfloat16)).float()
            else:
                amax = torch.stack([c.abs().max() for c in comp]).max()
                scale = amax.clamp_min(1e-12) / 127.0
                q = [torch.clamp(torch.round(c / scale), -127, 127)
                     for c in comp]
                sent = [qi * scale for qi in q]
                summed = sum(qi.to(torch.int32) for qi in q).float() * scale
            mean[k] = summed / n
            for e, c, sv in zip(ef, comp, sent):
                e[k] = c - sv
        params, opt, _ = opt_update(mean, state.opt, state.params)
        state = type(state)(params, opt, None)
    return {k: v.detach().cpu() for k, v in state.params.items()}, losses


def train_phase(torch, dev, results, card: str,
                profile: bool = False) -> dict:
    """Phase 12, ``[train]``: full-width training through the launcher,
    the remat and microbatch equivalences, card == CPU on the six smoke
    configs, the reference's Markov-language recipe, elastic resume and
    compressed data parallelism over gloo. The launch counters are set to
    0 before each full-width run and at the start of the rest, and read
    after each run, after the remat and microbatch comparison and after a
    profiled step: every count must stay 0 (recorded in ``results``).
    ``profile``: device time by op over one more warm step of each
    full-width model. Returns each full-width run's peak memory and warm
    step seconds by (arch, batch, seq)."""
    import dataclasses
    import math
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, ShapeKind
    from repro_torch.data import batch_for
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.roofline import H100_SXM
    from repro_torch.models import Transformer
    from repro_torch.train import (
        ElasticRunner,
        adamw,
        constant_lr,
        global_norm,
        init_train_state,
        make_train_step,
        warmup_cosine,
    )
    from repro_torch.train.train_step import grads_over_microbatches

    def no_launches(label):
        counts = dict(ops.LAUNCHES)
        check(not any(counts.values()), f"{label}: the training path "
              f"launched kernels: {counts}")
        for name, r in results.items():
            r["launches_by_path"][label] = counts[name]

    runs = {}
    print(f"[train] torch {torch.__version__}; selective checkpointing: "
          f"{hasattr(torch.utils.checkpoint, 'create_selective_checkpoint_contexts')}")

    def finite(xs):
        return all(math.isfinite(x) for x in xs)

    # --- full width through the launcher -------------------------------------
    for arch, batch, seq, remat in TRAIN_FULL:
        label = f"train {arch} ({batch}, {seq})"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        run = train.main(["--arch", arch, "--full", "--device", "cuda",
                          "--dtype", "float32", "--batch", str(batch),
                          "--seq-len", str(seq), "--steps", str(TRAIN_STEPS),
                          "--remat", remat, "--lr", "1e-4", "--warmup", "2",
                          "--log-every", str(TRAIN_STEPS)])
        peak = torch.cuda.max_memory_allocated()
        no_launches(label)
        losses = [h["loss"] for h in run.history]
        gnorms = [h["grad_norm"] for h in run.history]
        check(finite(losses) and finite(gnorms),
              f"{arch}: non-finite loss or grad norm {losses} {gnorms}")
        warm = run.step_seconds[1:]
        runs[(arch, batch, seq)] = dict(peak=peak, warm=warm)
        ms = sum(warm) / len(warm) * 1e3
        # the roofline's compute term: the step's counted FLOPs at the f32
        # peak ([roofline] holds the count to a step on the card)
        flops = dryrun.device_cost(
            dataclasses.replace(run.cfg, dtype="float32"),
            ShapeConfig("t", ShapeKind.TRAIN, seq, batch),
            {"data": 1, "model": 1}, remat=remat)["flops_per_device"]
        bound_ms = flops / H100_SXM.peak("float32") * 1e3
        n_params = sum(p.numel() for p in run.model.parameters())
        print(f"[train] {arch} f32 ({batch}, {seq}), remat {remat}, "
              f"{n_params / 1e9:.3f} B params: losses "
              f"{[round(x, 4) for x in losses]}, grad norms "
              f"{[round(x, 4) for x in gnorms]}")
        print(f"[train] {arch}: cold step {run.step_seconds[0] * 1e3:.1f} "
              f"ms, warm {ms:.1f} ms/step (min {min(warm) * 1e3:.1f}, max "
              f"{max(warm) * 1e3:.1f}), {run.tokens_per_step / ms * 1e3:.0f}"
              f" tokens/s, peak {peak / 1e9:.2f} GB; bound {bound_ms:.1f} ms"
              f" ({flops / 1e12:.2f} TFLOP counted, at 67 TFLOP/s f32), "
              f"{bound_ms / ms:.1%} of it [{card}]")
        if profile:
            state = run.state
            step = make_train_step(run.model, adamw(constant_lr(1e-4)),
                                   remat=remat)
            b = batch_for(run.cfg, ShapeConfig("t", ShapeKind.TRAIN, seq,
                                               batch), step=TRAIN_STEPS,
                          device=dev)

            def one_step():
                nonlocal state
                state, _ = step(state, b)

            device_profile(torch, one_step,
                           f"{arch} ({batch}, {seq}) warm train step")
            state = step = None
            no_launches(f"{label}, profiled step")
        if (arch, batch, seq) != TRAIN_EQ_RUN:
            run = None
            continue
        # the same state and batch under each remat policy, and in two
        # microbatches: loss and grad norm
        model, cfg = run.model, run.cfg
        run = None  # drops the moments; the model keeps its weights
        torch.cuda.empty_cache()
        params = dict(model.named_parameters())
        b0 = batch_for(cfg, ShapeConfig("t", ShapeKind.TRAIN, seq, batch),
                       step=0, device=dev)
        seen = {}
        for how, policy, k in (("dots", "dots", 1),
                               ("minimal", "minimal", 1),
                               ("none", "none", 1),
                               ("dots, 2 microbatches", "dots", 2)):
            g, m = grads_over_microbatches(model, params, b0, remat=policy,
                                           microbatches=k)
            seen[how] = (float(m["loss"]), float(global_norm(g)))
            del g
        ref = seen["dots"]
        for how, (loss, gn) in seen.items():
            rel = max(abs(loss - ref[0]) / abs(ref[0]),
                      abs(gn - ref[1]) / abs(ref[1]))
            print(f"[train] {arch} step-1 state, remat {how}: loss "
                  f"{loss:.7f}, grad norm {gn:.7f}, rel. diff to dots "
                  f"{rel:.2e} (rtol {TRAIN_EQ_RTOL:g})")
            check(rel <= TRAIN_EQ_RTOL, f"{arch}: remat {how} moves the "
                  f"loss or grad norm by {rel:.2e}")
        no_launches(f"{label}, remat and microbatches")
        del model, params, b0
        torch.cuda.empty_cache()

    # --- card against CPU on the smoke configs ---------------------------------
    ops.reset_launches()
    for arch in TRAIN_SMOKE:
        smoke = get_config(arch, smoke=True)
        cpu_model = Transformer(smoke, device="cpu", max_positions=64,
                                generator=torch.Generator().manual_seed(1))
        gpu_model = Transformer(smoke, device=dev, max_positions=64)
        gpu_model.load_state_dict(cpu_model.state_dict())
        shape = ShapeConfig("t", ShapeKind.TRAIN, 64, 4)
        got = {}
        for label, d, m in (("cpu", "cpu", cpu_model),
                            ("cuda", dev, gpu_model)):
            opt = adamw(constant_lr(1e-3))
            st = init_train_state(dict(m.named_parameters()), opt)
            step = make_train_step(m, opt)
            got[label] = []
            for i in range(3):
                st, met = step(st, batch_for(smoke, shape, step=i, device=d))
                got[label].append(float(met["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["cuda"], got["cpu"]))
        print(f"[train] {smoke.name} 3 steps card vs CPU: losses "
              f"{[round(x, 6) for x in got['cuda']]}, max rel. diff "
              f"{rel:.2e} (rtol {TRAIN_CPU_RTOL:g})")
        check(rel <= TRAIN_CPU_RTOL, f"{smoke.name}: training losses on the "
              f"card disagree with the CPU by {rel:.2e}")

    # --- the reference's Markov-language recipe --------------------------------
    cfg = get_config("deepseek-7b", smoke=True)
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    opt = adamw(warmup_cosine(3e-3, 10, 60))
    st = init_train_state(dict(model.named_parameters()), opt)
    step = make_train_step(model, opt)
    shape = ShapeConfig("t", ShapeKind.TRAIN, 64, 8)
    losses = []
    for i in range(25):
        st, m = step(st, batch_for(cfg, shape, step=i, device=dev))
        losses.append(float(m["loss"]))
    bar = 0.85 * math.log(cfg.vocab_size)
    print(f"[train] {cfg.name} Markov language, 25 steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (bar 0.85 ln V = {bar:.4f})")
    check(losses[-1] < bar and losses[-1] < losses[0],
          f"{cfg.name}: the loss did not drop below 0.85 ln V")

    # --- elastic resume ---------------------------------------------------------
    opt = adamw(constant_lr(1e-3))
    step = make_train_step(model, opt)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    shape = ShapeConfig("t", ShapeKind.TRAIN, 32, 8)

    def fresh():
        return init_train_state({k: v.clone() for k, v in p0.items()}, opt)

    def make_batch(i):
        return batch_for(cfg, shape, step=i, device=dev)

    s_ref = fresh()
    for i in range(20):
        s_ref, _ = step(s_ref, make_batch(i))
    with tempfile.TemporaryDirectory() as root:
        def failure(state):
            restored = ckpt.restore(root, ckpt.latest_step(root), state,
                                    device=dev)
            return restored, step

        s_run, _ = ElasticRunner(ckpt_root=root, save_every=10).run(
            fresh(), 20, make_batch=make_batch, step_fn=step,
            failures={12: failure})
    err = max((s_run.params[k] - s_ref.params[k]).abs().max().item()
              for k in p0)
    print(f"[train] elastic resume: failed at 12, restored step 10, reached "
          f"step {int(s_run.step)}; params vs the uninterrupted run "
          f"max_abs_err {err:.3e} (atol {TRAIN_RESUME_ATOL:g})")
    check(int(s_run.step) == 20 and err <= TRAIN_RESUME_ATOL,
          "elastic resume does not reproduce the uninterrupted run")
    del model, st, s_ref, s_run
    torch.cuda.empty_cache()

    # --- compressed data parallelism: 2 ranks over gloo ------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        records = spawn_world(TRAIN_DP_WORLD, tmp, str(dev), fn=train_rank,
                              timeout_s=TRAIN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for mode in TRAIN_DP_MODES:
            digests = {r[mode]["digest"] for r in records}
            check(len(digests) == 1, f"{mode}: ranks end with different "
                  f"parameters")
            want, want_losses = dp_model(torch, dev, mode)
            got = torch.load(f"{tmp}/world{TRAIN_DP_WORLD}/params_{mode}.pt")
            err = max((got[k] - want[k]).abs().max().item() for k in want)
            exact = all(torch.equal(got[k], want[k]) for k in want)
            print(f"[train] compressed DP {mode}, {TRAIN_DP_WORLD} ranks "
                  f"over gloo, {TRAIN_DP_STEPS} steps: losses "
                  f"{[round(x, 6) for x in records[0][mode]['losses']]} "
                  f"(in-process model {[round(x, 6) for x in want_losses]}),"
                  f" parameters equal across ranks; vs the in-process model "
                  f"of the per-rank arithmetic: max_abs_err {err:.3e}"
                  f"{' (bit-identical)' if exact else ''}")
            check(err <= TRAIN_RESUME_ATOL, f"{mode}: the ranks' parameters "
                  f"disagree with the per-rank model")
        print(f"[train] the world spawned, trained and joined in {wall:.1f} s")
    no_launches("train smoke, Markov, resume, DP")
    print("[train] kernel launches on the training paths: none")
    return runs


# --- [dryrun]: shape, sharding and FLOP accounting ------------------------
DRYRUN_WORKERS = 8
DRYRUN_TIMEOUT_S = 300
DRYRUN_CARD = (DANUBE, 4, 512, "dots")  # [train]'s first run


def dryrun_phase(torch, dev, card: str, runs: dict) -> tuple[list, dict]:
    """Phase 13, ``[dryrun]``: the reference's dry-run matrix on the port.
    ``python -m repro_torch.launch.dryrun --all --both-meshes`` in a
    spawned process (a pool of ``DRYRUN_WORKERS`` over the (arch, shape)
    pairs, each mesh in a fake world of 256 or 512 ranks, meta tensors):
    one row per cell, 0 failures, SKIPs exactly where ``cell_supported``
    puts them, every cell's FLOPs equal to ``flop_terms``' closed form.
    Then the accounting is grounded on the card for danube-1.8b f32 at
    (4, 512), remat dots: ``DeviceCostMode`` over one real step with its
    AdamW update (``dryrun.device_step``) counts the meta count's FLOPs,
    and ``state_bytes_per_device`` on a (1, 1) mesh over NCCL equals the
    live ``TrainState`` plus the step's gradients; the step's peak memory
    and ``[train]``'s (``runs``) beside it, the gap being activations.
    Returns the matrix's records (its ``--json``) and the card step's
    counts and peak memory, for ``[roofline]``."""
    import dataclasses
    import datetime
    import os
    import signal
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import (ARCH_IDS, SHAPE_IDS, batch_specs,
                                     cell_supported, get_config, get_shape)
    from repro_torch.configs.base import ShapeConfig, ShapeKind
    from repro_torch.data import batch_for
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.costs import DeviceCostMode
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Transformer
    from repro_torch.train import init_train_state

    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        out = os.path.join(tmp, "matrix.json")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--both-meshes", "--workers", str(DRYRUN_WORKERS), "--json",
             out], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            fail(f"the dry run outlived {DRYRUN_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        rows = [r for r in text.splitlines()
                if r.split(" ", 1)[0] in ARCH_IDS]
        for r in rows:
            print(f"[dryrun] {r}")
        check(proc.returncode == 0, f"the dry run failed (exit "
              f"{proc.returncode}):\n{text[-3000:]}")
        with open(out) as f:
            cells = json.load(f)
    check(len(cells) == 2 * len(ARCH_IDS) * len(SHAPE_IDS),
          f"{len(cells)} cells, not the full matrix")
    n_skip = 0
    for c in cells:
        ok, why = cell_supported(get_config(c["arch"]), get_shape(c["shape"]))
        check(c["ok"] == ok and (ok or c["error"] == "SKIP: " + why),
              f"{c['arch']} {c['shape']} {c['mesh']}: {c['error']}")
        n_skip += not ok
    print(f"[dryrun] {len(cells)} cells on 16x16 and 2x16x16, 0 failures, "
          f"{n_skip} SKIPs as cell_supported puts them, in {wall:.1f} s "
          f"({DRYRUN_WORKERS} processes) [{card}]")
    for c in cells:
        if not c["ok"] or c["mesh"] != "16x16":
            continue
        cfg, shape = get_config(c["arch"]), get_shape(c["shape"])
        terms = dryrun.flop_terms(cfg, shape)
        check(sum(terms.values()) == c["flops"],
              f"{c['arch']} {c['shape']}: count {c['flops']:.6e} is not "
              f"the closed form {sum(terms.values()):.6e} {terms}")
        print(f"[dryrun] {c['arch']} {c['shape']}: {c['flops']:.6e} FLOPs "
              f"= closed form " + ", ".join(
                  f"{k} {v:.4e}" for k, v in terms.items() if v))

    # --- the card: one real step against the meta count -------------------
    arch, batch, seq, remat = DRYRUN_CARD
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    shape = ShapeConfig("card", ShapeKind.TRAIN, seq, batch)
    meta_flops = dryrun.count_flops(cfg, shape, remat=remat)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = Transformer(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(dev).manual_seed(0))
    opt = dryrun.step_optimizer()
    state = init_train_state(dict(model.named_parameters()), opt)
    spec = batch_specs(cfg, shape)  # the dtypes the meta count takes
    b = {k: v.to(spec[k].dtype)
         for k, v in batch_for(cfg, shape, step=0, device=dev).items()}
    check(b.keys() == spec.keys(), f"batch {list(b)} is not {list(spec)}")
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with DeviceCostMode() as cost:
        grads = dryrun.device_step(model, "train", b, state=state, opt=opt,
                                   remat=remat)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    check(not any(ops.LAUNCHES.values()), "the counted step launched kernels")
    closed = sum(dryrun.flop_terms(cfg, shape, remat=remat).values())
    print(f"[dryrun] {arch} f32 ({batch}, {seq}) remat {remat}: one step on "
          f"the card with its AdamW update {cost.flops:.6e} FLOPs, meta "
          f"count {meta_flops:.6e}, closed form {closed:.6e}")
    check(cost.flops == meta_flops == closed,
          "the card step's FLOPs differ from the meta count")

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    live = (nbytes(state.params.values()) + nbytes(state.opt.mu.values())
            + nbytes(state.opt.nu.values()) + nbytes([state.opt.count]))
    live_grads = nbytes(grads.values())
    del grads
    torch.cuda.set_device(dev.index or 0)
    with tempfile.TemporaryDirectory(prefix="dryrun-nccl-") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh(1, 1, device="cuda")
            dry = dryrun.state_bytes_per_device(cfg, shape, mesh)
        finally:
            dist.destroy_process_group()
    train_peak = runs[(arch, batch, seq)]["peak"]
    print(f"[dryrun] {arch} f32 on a (1, 1) mesh over NCCL: "
          f"state_bytes_per_device {dry / 1e9:.4f} GB = live TrainState "
          f"{live / 1e9:.4f} GB + the step's gradients {live_grads / 1e9:.4f}"
          f" GB; the step's peak {step_peak / 1e9:.2f} GB, [train]'s "
          f"{train_peak / 1e9:.2f} GB: activations and temporaries "
          f"{(train_peak - dry) / 1e9:.2f} GB [{card}]")
    check(dry == live + live_grads, "state_bytes_per_device differs from "
          "the live state and gradients")
    del model, state, b
    torch.cuda.empty_cache()
    return cells, dict(flops=cost.flops, bytes=cost.bytes_accessed,
                       live=cost.peak_live_bytes, peak=step_peak - before,
                       before=before)


# --- [roofline]: the dry run's per-device counts, priced and held to a step ----
ROOFLINE_PEAK_RATIO = (0.9, 1.1)  # max_memory_allocated / peak_mem_per_device


def roofline_phase(card: str, cells: list, step: dict, warm: list) -> None:
    """Phase 14, ``[roofline]``: ``repro_torch.launch.roofline`` over
    ``[dryrun]``'s matrix, and its counts held to ``[dryrun]``'s step on
    the card (``step``). ``dryrun.device_cost`` counts danube-1.8b f32 at
    (4, 512), remat dots, with its AdamW update, on meta tensors on a
    (1, 1) mesh: the card step's FLOPs and bytes accessed must equal it,
    and its ``torch.cuda.max_memory_allocated()`` (less what was allocated
    before the model) must lie within ``ROOFLINE_PEAK_RATIO`` of
    ``peak_mem_per_device``. ``[train]``'s warm steps of the same config
    (``warm``, seconds) are set against the three terms at the H100's
    spec-sheet rates: each must take at least the compute term. Then
    ``roofline.render`` of the matrix: no FAIL row, one bound for every
    runnable 16x16 cell, and its 16x16 table is printed."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, ShapeKind
    from repro_torch.launch import dryrun, roofline

    arch, batch, seq, remat = DRYRUN_CARD
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    shape = ShapeConfig("card", ShapeKind.TRAIN, seq, batch)
    t0 = time.perf_counter()
    meta = dryrun.device_cost(cfg, shape, {"data": 1, "model": 1},
                              remat=remat)
    t_meta = time.perf_counter() - t0
    rates = roofline.H100_SXM
    t_c = meta["flops_per_device"] / rates.peak(cfg.dtype)
    t_m = meta["bytes_accessed"] / rates.hbm
    terms = {"compute": t_c, "eager-memory": t_m, "collective": 0.0}
    print(f"[roofline] {arch} f32 ({batch}, {seq}) remat {remat} with "
          f"AdamW, (1, 1) mesh, meta count in {t_meta:.1f} s: "
          f"{meta['flops_per_device']:.6e} FLOPs, {meta['bytes_accessed']} "
          f"bytes accessed, peak_mem_per_device "
          f"{meta['peak_mem_per_device'] / 1e9:.4f} GB; terms at "
          f"{rates.name} spec-sheet rates: compute {t_c * 1e3:.1f} ms, "
          f"memory {t_m * 1e3:.1f} ms (eager bytes, a ceiling), "
          f"collective 0")
    ratio = step["peak"] / meta["peak_mem_per_device"]
    print(f"[roofline] [dryrun]'s step on the card: {step['flops']:.6e} "
          f"FLOPs, {step['bytes']} bytes accessed (meta "
          f"{meta['bytes_accessed']}); max_memory_allocated "
          f"{step['peak'] / 1e9:.4f} GB over the {step['before'] / 1e9:.4f}"
          f" GB allocated before = {ratio:.4f} x peak_mem_per_device (the "
          f"mode's own peak: {step['live'] / 1e9:.4f} GB live) [{card}]")
    check(step["bytes"] == meta["bytes_accessed"]
          and step["flops"] == meta["flops_per_device"],
          "the card step's counts differ from the meta count")
    check(ROOFLINE_PEAK_RATIO[0] <= ratio <= ROOFLINE_PEAK_RATIO[1],
          f"max_memory_allocated is {ratio:.4f} x peak_mem_per_device")

    top = max(terms, key=terms.get)
    med = sorted(warm)[len(warm) // 2]
    steps = [round(w * 1e3, 1) for w in warm]
    print(f"[roofline] [train]'s warm steps {steps} ms: median "
          f"{med * 1e3:.1f} ms against compute {t_c * 1e3:.1f}, "
          f"memory {t_m * 1e3:.1f}, collective 0 ms; bound by {top}, "
          f"roofline fraction (largest term / measured) "
          f"{terms[top] / med:.4f} [{card}]")
    check(min(warm) >= t_c, f"a warm step ({min(warm) * 1e3:.1f} ms) beat "
          f"the compute term ({t_c * 1e3:.1f} ms)")

    text = roofline.render(cells)
    check("| FAIL" not in text, "the rendered matrix has a FAIL row")
    table = text[text.index("### Roofline terms"):].splitlines()
    rows = [r for r in table if r.startswith("| ") and not
            r.startswith("| arch")]
    runnable = [c for c in cells if c["ok"] and c["mesh"] == "16x16"]
    check(len(rows) == len(runnable) and all(
        r.split(" | ")[5] in terms for r in rows),
        f"{len(rows)} roofline rows for {len(runnable)} runnable 16x16 cells")
    for r in table:
        print(f"[roofline] {r}")
    print(f"[roofline] {len(rows)} runnable 16x16 cells, each with its "
          f"bound [{card}]")


# --- [examples]: the user entry points ----------------------------------------
EXAMPLES_RTOL = 1e-5


def examples_phase(torch, dev, card: str) -> None:
    """Phase 15, ``[examples]``: ``launch.quickstart``,
    ``launch.lm_design_space``, ``launch.fault_tolerant_training`` and
    ``launch.carbon_aware_training`` (its default 300 steps of (8, 128))
    with ``--device cuda``, each also on the CPU: decisions and ledgers
    card == CPU (integers exact, carbon within rtol 1e-5); the
    fault-tolerant runs from the same weights, their first loss within
    ``TRAIN_CPU_RTOL``; the training runs' losses finite and falling; the
    launch counters 0 around each training run."""
    import math
    import tempfile

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import (carbon_aware_training,
                                    fault_tolerant_training, lm_design_space,
                                    quickstart)
    from repro_torch.models import Transformer

    def close(a, b):
        return np.allclose(a, b, rtol=EXAMPLES_RTOL, atol=0)

    def same_ledger(got, want, label):
        check(len(got) == len(want) and all(
            (g.hour, g.pod, g.action, g.steps) == (w.hour, w.pod, w.action,
                                                   w.steps)
            and close([g.dp_frac, g.op_g, g.emb_g, g.ci],
                      [w.dp_frac, w.op_g, w.emb_g, w.ci])
            for g, w in zip(got, want)), f"{label}: ledgers differ card vs "
            "CPU")

    t0 = time.perf_counter()
    q = {d: quickstart.main(["--device", d]) for d in ("cuda", "cpu")}
    check(q["cuda"].picks == q["cpu"].picks
          and q["cuda"].optimal == q["cpu"].optimal
          and close(q["cuda"].total_cf, q["cpu"].total_cf),
          "quickstart: card and CPU differ")
    print(f"[examples] quickstart card == CPU: {q['cuda'].n_points} cells, "
          f"picks equal, ResNet-50 carbon within rtol {EXAMPLES_RTOL:g} "
          f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    lm = {d: lm_design_space.main(["--device", d]) for d in ("cuda", "cpu")}
    for g, w in zip(lm["cuda"], lm["cpu"]):
        check(g.name == w.name and g.derived == w.derived,
              f"{g.name}: card {g.derived} vs CPU {w.derived}")
        if "ledger" in g.values:
            same_ledger(g.values["ledger"], w.values["ledger"], g.name)
            check(close(g.values["aware_g"], w.values["aware_g"]),
                  f"{g.name}: carbon differs")
    print(f"[examples] lm_design_space card == CPU: {len(lm['cuda'])} rows; "
          f"route {np.mean([r.us_per_call for r in lm['cuda'][:10]]):.1f} "
          f"us/call on the card, "
          f"{np.mean([r.us_per_call for r in lm['cpu'][:10]]):.1f} on the "
          f"CPU ({time.perf_counter() - t0:.1f} s)")

    # both runs from the same weights, drawn on the CPU
    params = {k: v.detach() for k, v in Transformer(
        fault_tolerant_training.CFG, device="cpu",
        generator=torch.Generator().manual_seed(0)).named_parameters()}
    runs = {}
    for d in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory(prefix="ft-") as root:
            ops.reset_launches()
            t0 = time.perf_counter()
            runs[d] = fault_tolerant_training.main(
                ["--device", d, "--ckpt-dir", root], params=params)
            runs[d].wall = time.perf_counter() - t0
            check(not any(ops.LAUNCHES.values()),
                  "fault-tolerant training launched kernels")
    losses = {d: [m["loss"] for m in r.phase1 + r.phase2]
              for d, r in runs.items()}
    alive = {d: [m["n_alive"] for m in r.phase1] for d, r in runs.items()}
    check(alive["cuda"] == alive["cpu"] and runs["cuda"].restored
          == runs["cpu"].restored == 12 and int(runs["cuda"].state.step)
          == 20, "fault-tolerant training: masks or restart differ")
    check(all(map(math.isfinite, losses["cuda"]))
          and losses["cuda"][-1] < losses["cuda"][0],
          f"fault-tolerant losses do not fall: {losses['cuda']}")
    rel = [abs(a / b - 1) for a, b in zip(losses["cuda"], losses["cpu"])]
    check(rel[0] <= TRAIN_CPU_RTOL, f"fault-tolerant training: the first "
          f"step's loss card vs CPU differs by {rel[0]:.2e}")
    print(f"[examples] fault_tolerant_training: masks and restart card == "
          f"CPU, loss {losses['cuda'][0]:.4f} -> {losses['cuda'][-1]:.4f} "
          f"over 20 steps from the same weights (rel. diff to the CPU run: "
          f"first step {rel[0]:.2e}, at most {max(rel):.2e}); "
          f"{runs['cuda'].wall:.1f} s on the card, {runs['cpu'].wall:.1f} s "
          f"on the CPU; 0 launches")

    with tempfile.TemporaryDirectory(prefix="ca-") as root:
        ops.reset_launches()
        t0 = time.perf_counter()
        ca = carbon_aware_training.main(["--device", "cuda", "--ckpt", root])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(ops.LAUNCHES.values()),
              "carbon-aware training launched kernels")
    tr = carbon_aware_training.trainer(300, "cpu")
    same_ledger(ca.ledger, tr.run(total_steps=300, start_hour=6),
                "carbon_aware_training")
    check(len(ca.losses) == 300 and all(map(math.isfinite, ca.losses))
          and ca.losses[-1] < ca.losses[0],
          f"carbon-aware losses: {ca.losses[:3]} ... {ca.losses[-3:]}")
    print(f"[examples] carbon_aware_training: 300 steps of (8, 128) on the "
          f"card, ledger of {len(ca.ledger)} hours card == CPU, "
          f"{ca.aware_g / 1e3:.2f} kg vs always-on {ca.base_g / 1e3:.2f} kg, "
          f"loss {ca.losses[0]:.3f} -> {ca.losses[-1]:.3f}, {wall:.1f} s "
          f"with checkpoints; 0 launches [{card}]")


def main() -> None:
    args = sys.argv[1:]
    profile = "--profile" in args
    seed = int(args[args.index("--seed") + 1]) if "--seed" in args else 0
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.launch.roofline import H100_SXM
    from repro_torch.models import Transformer, kernel_launches
    from repro_torch.serve import GreenScaleRouter, Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # --- phase 1: build --------------------------------------------------------
    info = build.build()
    print(f"[build] {info.path.name}: {info.seconds:.1f} s"
          f"{' (cached)' if info.cached else ''}")
    for line in ptxas_summary(info.log):
        print(f"[build]   {line}")
    build.library()

    # --- phase 2: kernels against their plain versions ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def time_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(reps):
            flush.zero_()  # evict L2 (50 MB) so every launch reads HBM
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / reps

    def compare(name, got, want, tol):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        print(f"[kernel] {name}: max_abs_err {err:.3e} (atol = rtol = {tol:g}) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} disagrees with its plain version")
        return err

    def bound(nbytes, flops, dtype):
        t_bytes = nbytes / H100_SXM.hbm * 1e3
        t_ops = flops / H100_SXM.peak(dtype_name(dtype)) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    results = {}

    def timed(name, shape, err, fn, plain, library, nbytes, flops, dtype,
              plain_reps=20, plain_warmup=3, copy=None):
        """Kernel, plain and library times, the bound, and for a kernel
        bound by bytes optionally ``copy_ms``: a device-to-device copy of
        the same bytes, timed the same way, as what this timing can reach."""
        b_ms, b_by = bound(nbytes, flops, dtype)
        r = dict(name=name, shape=shape, max_abs_err=err, ms=time_ms(fn),
                 plain_ms=time_ms(plain, reps=plain_reps,
                                  warmup=plain_warmup),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=None if library is None else time_ms(library))
        if copy is not None:
            r["copy_ms"] = time_ms(copy)
        return r

    # flash attention
    flash_cases = [  # (label, B, S, H, Hkv, D, window, dtype)
        ("main f32", BATCH, PROMPT, 32, 8, 80, None, torch.float32),
        ("main bf16", BATCH, PROMPT, 32, 8, 80, None, torch.bfloat16),
        ("window 256", 2, 1024, 32, 8, 80, 256, torch.float32),
        ("ragged S=96 D=16", 2, 96, 4, 2, 16, 16, torch.float32),
        ("ragged S=96 D=16 bf16", 2, 96, 4, 2, 16, 16, torch.bfloat16),
        ("qwen3 bf16", BATCH, PROMPT, 32, 4, 128, None, torch.bfloat16),
    ]
    flash_more = []
    for label, B, S, H, Hkv, D, window, dtype in flash_cases:
        q, k, v = (randn((B, S, h, D), dtype) for h in (H, Hkv, Hkv))
        err = compare(f"flash_attention {label} q{(B, S, H, D)}",
                      ops.flash_attention(q, k, v, causal=True, window=window),
                      ref.flash_attention_ref(q, k, v, causal=True,
                                              window=window),
                      TOL[dtype_name(dtype)])
        if label not in ("main f32", "main bf16", "qwen3 bf16"):
            continue
        pos = torch.arange(S)
        pairs = int((pos[None, :] <= pos[:, None]).sum())  # visible (q, k)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        r = timed(
            "flash_attention",
            f"q{(B, S, H, D)} kv{(B, S, Hkv, D)} causal {dtype_name(dtype)}",
            err, lambda: ops.flash_attention(q, k, v, causal=True),
            lambda: ref.flash_attention_ref(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True),
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
            4 * B * H * D * pairs, dtype)
        if label == "main f32":
            results["flash_attention"] = dict(
                r, route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:27")
        else:
            flash_more.append(r)
    for label, B, Sq, Sk, H, Hkv, D, causal, dname in FLASH_BRANCHES:
        dtype = getattr(torch, dname)
        q = randn((B, Sq, H, D), dtype)
        k, v = randn((B, Sk, Hkv, D), dtype), randn((B, Sk, Hkv, D), dtype)
        err = compare(f"flash_attention {label} q{(B, Sq, H, D)} "
                      f"kv{(B, Sk, Hkv, D)} causal={causal} {dname}",
                      ops.flash_attention(q, k, v, causal=causal),
                      ref.flash_attention_ref(q, k, v, causal=causal),
                      TOL[dname])
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flash_more.append(timed(
            "flash_attention", f"{label} q{(B, Sq, H, D)} kv{(B, Sk, Hkv, D)}"
            f" {'causal' if causal else 'non-causal'} {dname}", err,
            lambda: ops.flash_attention(q, k, v, causal=causal),
            lambda: ref.flash_attention_ref(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True),
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
            4 * B * H * D * pairs, dtype))
    results["flash_attention"]["other_shapes"] = flash_more

    # RMSNorm
    norm_cases = [((2048, 2560), torch.float32), ((2048, 2560), torch.bfloat16),
                  ((4, 2560), torch.float32), ((4, 2560), torch.bfloat16),
                  ((4, 37, 96), torch.float32), ((4, 37, 96), torch.bfloat16),
                  # qwen3 (bf16) and mamba2 (f32: d_model, gated d_inner)
                  ((2048, 2048), torch.bfloat16), ((4, 2048), torch.bfloat16),
                  ((2048, 1536), torch.float32), ((2048, 3072), torch.float32),
                  ((4, 1536), torch.float32), ((4, 3072), torch.float32),
                  # whisper (f32), qwen2-vl and jamba (bf16)
                  ((6000, 512), torch.float32), ((512, 512), torch.float32),
                  ((4, 512), torch.float32), ((2048, 3584), torch.bfloat16),
                  ((5120, 3584), torch.bfloat16), ((4, 3584), torch.bfloat16),
                  ((2048, 4096), torch.bfloat16), ((4, 4096), torch.bfloat16),
                  ((2048, 8192), torch.bfloat16), ((4, 8192), torch.bfloat16)]
    norm_more = []
    for shape, dtype in norm_cases:
        x = randn(shape, dtype)
        scale = randn(shape[-1:])
        err = compare(f"fused_rmsnorm {shape} {dtype_name(dtype)}",
                      ops.fused_rmsnorm(x, scale), ref.rmsnorm_ref(x, scale),
                      TOL[dtype_name(dtype)])
        if (shape, dtype_name(dtype)) not in NORM_TIMED:
            continue
        out = torch.empty_like(x)
        r = timed(
            "fused_rmsnorm", f"x{shape} {dtype_name(dtype)}", err,
            lambda: ops.fused_rmsnorm(x, scale),
            lambda: ref.rmsnorm_ref(x, scale),
            lambda: F.rms_norm(x, (shape[-1],), scale, 1e-5),
            2 * x.numel() * x.element_size() + scale.numel() * 4,
            4 * x.numel(), dtype, copy=lambda: out.copy_(x))
        if (shape, dtype_name(dtype)) == NORM_TIMED[0]:
            results["fused_rmsnorm"] = dict(
                r, route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:19")
        else:
            norm_more.append(r)
    results["fused_rmsnorm"]["other_shapes"] = norm_more
    # nemotron's grouped gated norm: d_inner 4096 in 8 groups of 512, at a
    # decode step of batch 32 and at the cell's largest prefill (32 x 384)
    for shape in NORM_NEMOTRON:
        x = randn(shape, torch.bfloat16)
        scale = randn(shape[-1:])
        compare(f"fused_rmsnorm {shape} groups of 512 bf16",
                ops.fused_rmsnorm(x, scale, group=512),
                ref.rmsnorm_ref(x, scale, group=512), TOL["bfloat16"])

    # SSD scan
    def ssd_inputs(B, S, H, P, N, dtype, init, model_like=False, G=1):
        x = randn((B, S, H, P), dtype)
        if model_like:  # mamba2's A = -(1..H), dt = softplus(.) ~ 0.1-1
            A = -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
        else:  # tests/test_kernels.py
            A = -torch.exp(randn((H,)) * 0.5)
        dt = F.softplus(randn((B, S, H)))
        bc = randn((B, S, 2 * G * N), dtype)
        # strided, as the model passes them: B's groups, then C's
        Bm, Cm = (t.unflatten(-1, (G, N)) for t in bc.chunk(2, dim=-1))
        D = randn((H,))
        s0 = randn((B, H, P, N)) if init else None
        return x, dt, A, Bm, Cm, D, s0

    def ssd_work(B, S, H, P, N, L, elt, init):
        """Least operations and bytes that compute the function on these
        inputs. Operations: the fewer of two ways. Chunked at L: the
        lower-triangle C.B^T and W.x per chunk, C.state where a state
        enters the chunk (not the first one without an initial state), the
        deposit. The token recurrence: per token and head a decay multiply,
        a deposit FMA and a C.h FMA over P x N, 5 P N. Bytes: each input
        read once, y and the state written once."""
        chunked = 0
        for c0 in range(0, S, L):
            Lc = min(L, S - c0)
            chunked += Lc * (Lc + 1) // 2 * 2 * (N + P) + 2 * Lc * P * N
            if c0 > 0 or init:
                chunked += 2 * Lc * P * N
        flops = B * H * min(chunked, 5 * S * P * N)
        nbytes = (2 * B * S * H * P * elt + 2 * B * S * N * elt
                  + 4 * B * S * H + 8 * H + 4 * B * H * P * N * (2 if init else 1))
        return nbytes, flops

    ssd_cases = [  # (label, B, S, H, P, N, chunk, dtype, initial state)
        *((c[0], *c[1:], torch.float32, False) for c in SSD_TIMED),
        (*SSD_JAMBA, torch.bfloat16, False),
        (*SSD_JAMBA, torch.float32, False),
        ("main, initial state", BATCH, PROMPT, 48, 64, 128, 256,
         torch.float32, True),
        ("ragged S=100", 2, 100, 8, 64, 128, 32, torch.float32, False),
        ("ragged S=96 chunk 64", 1, 96, 4, 16, 16, 64, torch.bfloat16, True),
        ("initial state", 1, 32, 4, 8, 16, 8, torch.float32, True),
    ] + [(f"sweep {dtype_name(dt_)}", b, s, h, p, n, L, dt_, False)
         for dt_ in (torch.float32, torch.bfloat16)
         for b, s, h, p, n, L in ((2, 64, 8, 16, 16, 16),
                                  (1, 128, 16, 32, 32, 32),
                                  (2, 96, 4, 8, 8, 24),
                                  (1, 64, 8, 64, 128, 16))]
    timed_labels = [c[0] for c in SSD_TIMED] + [SSD_JAMBA[0]]
    ssd_more = []
    for label, B, S, H, P, N, L, dtype, init in ssd_cases:
        args = ssd_inputs(B, S, H, P, N, dtype, init,
                          model_like=label.startswith("main")
                          or label in timed_labels)
        x, dt, A, Bm, Cm, D, s0 = args
        y, sf = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=L, initial_state=s0)
        yr, sr = ref.ssd_ref(x, dt, A, Bm, Cm, D, s0)
        name = f"ssd_scan {label} x{(B, S, H, P)} N={N} chunk {L}"
        err = compare(f"{name} {dtype_name(dtype)} y", y, yr,
                      SSD_Y_TOL[dtype_name(dtype)])
        compare(f"{name} final state", sf, sr, SSD_STATE_TOL)
        if label not in timed_labels or (label == SSD_JAMBA[0]
                                         and dtype != torch.bfloat16):
            continue
        nbytes, flops = ssd_work(B, S, H, P, N, L, x.element_size(), init)
        # float32 operations: the kernels compute in float32 whatever x is
        r = timed(
            "ssd_scan", f"{label} x{(B, S, H, P)} B/C{(B, S, 1, N)} chunk {L}"
            f" {dtype_name(dtype)}",
            err, lambda: ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=L),
            lambda: ref.ssd_ref(x, dt, A, Bm, Cm, D), None, nbytes, flops,
            torch.float32, plain_reps=3 if S <= PROMPT else 1,
            plain_warmup=3 if S <= PROMPT else 1)
        if label == timed_labels[0]:
            results["ssd_scan"] = dict(
                r, route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:29")
        else:
            ssd_more.append(r)
    results["ssd_scan"]["other_shapes"] = ssd_more
    # nemotron's prefill at the cell's largest prompt: 64 heads of 64 read
    # B/C in 8 groups of state 128
    label, B, S, H, P, N, L, G = SSD_NEMOTRON
    x, dt, A, Bm, Cm, D, _ = ssd_inputs(B, S, H, P, N, torch.bfloat16, False,
                                        model_like=True, G=G)
    y, sf = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=L)
    yr, sr = ref.ssd_ref(x, dt, A, Bm, Cm, D)
    name = f"ssd_scan {label} x{(B, S, H, P)} B/C{(B, S, G, N)} chunk {L}"
    compare(f"{name} bf16 y", y, yr, SSD_Y_TOL["bfloat16"])
    compare(f"{name} final state", sf, sr, SSD_STATE_TOL)

    # grouped matmul: qwen3's expert FF at prefill (G=2 groups of 1024
    # tokens, C=80) and at decode (C=8), gate/up and down, then the sweep
    gmm_cases = [  # (label, E, C, d, f, dtype)
        ("prefill gate/up", 128, 160, 2048, 768, torch.bfloat16),
        ("prefill down", 128, 160, 768, 2048, torch.bfloat16),
        ("decode gate/up", 128, 8, 2048, 768, torch.bfloat16),
        ("prefill gate/up", 128, 160, 2048, 768, torch.float32),
        ("decode down", 128, 8, 768, 2048, torch.bfloat16),
        ("decode down", 128, 8, 768, 2048, torch.float32),
        # jamba-v0.1-52b's experts: 16 of width 14336, C = 2 x 160 at
        # prefill, 8 at decode
        ("jamba prefill gate/up", 16, 320, 4096, 14336, torch.bfloat16),
        ("jamba prefill down", 16, 320, 14336, 4096, torch.bfloat16),
        ("jamba decode gate/up", 16, 8, 4096, 14336, torch.bfloat16),
        ("jamba decode down", 16, 8, 14336, 4096, torch.bfloat16),
        # nemotron-3-nano's relu^2 experts: 128 of width 1856, up then
        # down, C = 12 groups x 64 at the cell's largest prefill (32 x
        # 384), 8 at decode
        ("nemotron prefill up", 128, 768, 2688, 1856, torch.bfloat16),
        ("nemotron prefill down", 128, 768, 1856, 2688, torch.bfloat16),
        ("nemotron decode up", 128, 8, 2688, 1856, torch.bfloat16),
        ("nemotron decode down", 128, 8, 1856, 2688, torch.bfloat16),
    ] + [("sweep", e, c, d, f, dt_) for dt_ in (torch.float32, torch.bfloat16)
         for e, c, d, f in ((4, 32, 64, 48), (8, 16, 32, 32),
                            (2, 128, 128, 128), (16, 8, 16, 8))]
    gmm_more = []
    for label, E, C, d, f, dtype in gmm_cases:
        x, w = randn((E, C, d), dtype), randn((E, d, f), dtype)
        err = compare(f"grouped_matmul {label} {(E, C, d)}@{(E, d, f)} "
                      f"{dtype_name(dtype)}", ops.grouped_matmul(x, w),
                      ref.grouped_matmul_ref(x, w), TOL[dtype_name(dtype)])
        if dtype != torch.bfloat16 or label == "sweep":
            continue
        r = timed("grouped_matmul",
                  f"{label} {(E, C, d)}@{(E, d, f)} {dtype_name(dtype)}", err,
                  lambda: ops.grouped_matmul(x, w),
                  lambda: ref.grouped_matmul_ref(x, w),
                  lambda: torch.bmm(x, w),
                  (x.numel() + w.numel() + E * C * f) * x.element_size(),
                  2 * E * C * d * f, dtype)
        if label == "prefill gate/up":
            results["grouped_matmul"] = dict(
                r, route="cuda",
                source="src/repro_torch/kernels/csrc/grouped_matmul.cu",
                replaces="src/repro/kernels/moe_matmul.py:21")
        else:
            gmm_more.append(r)
    results["grouped_matmul"]["other_shapes"] = gmm_more

    def show(r):
        lib = "no single call" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x)"
        copy = f", copy of the bytes {r['copy_ms']:.4f} ms" \
            if "copy_ms" in r else ""
        print(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){copy}")

    for r in results.values():
        show(r)
        for more in r.get("other_shapes", []):
            show(more)
    del flush
    torch.cuda.empty_cache()
    print(f"[chip_smoke] kernels phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 3: the served paths at full width ------------------------------
    for r in results.values():
        r["launches_by_path"] = {}

    def drive(arch, dtype, want, prompt=PROMPT):
        """One launcher run with the counters set to 0 just before it and
        read just after; the counts must equal ``want``."""
        ops.reset_launches()
        t0 = time.perf_counter()
        run = serve.main(["--arch", arch, "--no-smoke", "--device", "cuda",
                          "--dtype", dtype, "--batch", str(BATCH),
                          "--prompt-len", str(prompt),
                          "--new-tokens", str(NEW)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        cfg = run.cfg
        n_params = sum(p.numel() for p in run.engine.model.parameters())
        print(f"[main] {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {n_params / 1e9:.3f} B {dtype} params; tokens "
              f"{tuple(run.tokens.shape)}; {wall:.1f} s including init; "
              f"launches {launches}")
        check(cfg.name == arch, "not the full config")
        # the launcher sizes a learned position table to the request
        n_pos = (run.engine.model.pos_embed.shape[0]
                 if cfg.is_encoder_decoder else cfg.max_position_embeddings)
        check(n_params == cfg.param_count() + (
            n_pos - cfg.max_position_embeddings) * cfg.d_model,
            "parameter count")
        check(tuple(run.tokens.shape) == (BATCH, NEW), "token shape")
        check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all()),
              "token ids out of range")
        want = dict({k: 0 for k in launches}, **want)
        check(launches == want, f"{arch}: launch counts {launches}, "
              f"expected {want}")
        for name, r in results.items():
            r["launches_by_path"][arch] = launches[name]
        return run

    def warm(run, label, tag="main", card=""):
        engine = run.engine
        t0 = time.perf_counter()
        logits, state = engine.prefill_batch(run.prompt, **run.extras)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = [logits]
        for _ in range(NEW - 1):
            logits, state = engine.serve_step(
                state, logits.argmax(-1, keepdim=True))
            outs.append(logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"[{tag}] {label} again, warm: prefill "
              f"{tuple(run.prompt.shape)} {t1 - t0:.4f} s{card}")
        print(f"[{tag}] {label} again, warm: {NEW - 1} decode steps "
              f"{t2 - t1:.4f} s ({(t2 - t1) / (NEW - 1) * 1e3:.2f} ms/step)"
              f"{card}")
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"{label}: non-finite logits")
        if profile:
            profile_path(torch, engine, run.prompt, label, run.extras)

    def kernels_vs_plain(run, label):
        model, max_seq = run.engine.model, run.engine.max_seq
        lk, _ = model.prefill(run.prompt, max_seq=max_seq, kernels=ops.KERNELS,
                              **run.extras)
        lp, _ = model.prefill(run.prompt, max_seq=max_seq, kernels=ops.PLAIN,
                              **run.extras)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lk).all()), f"{label}: non-finite logits")
        err = (lk - lp).abs().max().item()
        print(f"[main] {label} prefill logits {tuple(lk.shape)} kernels vs "
              f"plain: max_abs_err {err:.3e} (tol {LOGITS_TOL:g}), "
              f"logit std {lp.std().item():.3f}")
        check(torch.allclose(lk, lp, atol=LOGITS_TOL, rtol=LOGITS_TOL),
              f"{label}: prefill logits through the kernels disagree with "
              "the plain path")

    run = drive(DANUBE, "float32", kernel_launches(get_config(DANUBE),
                                                   NEW - 1))
    warm(run, DANUBE)
    kernels_vs_plain(run, DANUBE)
    run = None
    torch.cuda.empty_cache()

    run = drive(MAMBA, "float32", kernel_launches(get_config(MAMBA), NEW - 1))
    warm(run, MAMBA)
    kernels_vs_plain(run, MAMBA)
    run = None
    torch.cuda.empty_cache()

    run = drive(QWEN3, "bfloat16", kernel_launches(get_config(QWEN3),
                                                   NEW - 1))
    warm(run, QWEN3)
    layers_vs_plain(torch, run, QWEN3, "main")
    run = None
    torch.cuda.empty_cache()
    print(f"[chip_smoke] served paths done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 4: card against CPU on small inputs -----------------------------
    for arch in (DANUBE, MAMBA, QWEN3):
        smoke = get_config(arch, smoke=True)
        cpu_model = Transformer(smoke, device="cpu",
                                generator=torch.Generator().manual_seed(1))
        gpu_model = Transformer(smoke, device=dev)
        gpu_model.load_state_dict(cpu_model.state_dict())
        toks = torch.randint(0, smoke.vocab_size, (2, 40),
                             generator=torch.Generator().manual_seed(2))
        lc, _ = cpu_model.prefill(toks, max_seq=64)
        lg, _ = gpu_model.prefill(toks.to(dev), max_seq=64)
        err = (lg.cpu() - lc).abs().max().item()
        print(f"[small] {smoke.name} prefill logits card vs CPU: "
              f"max_abs_err {err:.3e}")
        check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4),
              f"{smoke.name} logits on the card disagree with the CPU")
        eng = {d: ServeEngine(smoke, m, max_seq=64, device=d)
               for d, m in (("cpu", cpu_model), ("cuda", gpu_model))}
        tc = eng["cpu"].generate(toks, max_new_tokens=12)
        tg = eng["cuda"].generate(toks, max_new_tokens=12)
        check(torch.equal(tc, tg.cpu()),
              f"{smoke.name} greedy tokens differ card vs CPU")
        print(f"[small] {smoke.name} greedy tokens card == CPU")
    full = get_config(DANUBE)
    req = Request(prompt_tokens=PROMPT, max_new_tokens=NEW)
    dec = {d: GreenScaleRouter(full, device=d).route(
        req, serve.env_at_hour(12, device=d)) for d in ("cpu", "cuda")}
    check(dec["cpu"].target == dec["cuda"].target, "routing target differs")
    check(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(
        dec["cuda"].per_target_carbon, dec["cpu"].per_target_carbon)),
        "routed carbon differs card vs CPU")
    print(f"[small] routing at hour 12 card == CPU: target "
          f"{serve.TARGETS[dec['cuda'].target]}")

    # --- phase 5: the decide half on the card, then the handoff ---------------
    fleet_phase(torch, dev, results, profile, seed)
    print(f"[chip_smoke] fleet phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 6: the sharded decide half, worlds 1 (NCCL), 2 and 4 (gloo) --
    shard_phase(torch, dev, results, seed)
    print(f"[chip_smoke] shard phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 7: the serving loop on the card, then the handoff ---------------
    serve_phase(torch, dev, results, profile, seed)
    print(f"[chip_smoke] serve phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 8: the scenario matrix and its gates ---------------------------
    scenarios_phase(torch, dev, profile)
    print(f"[chip_smoke] scenarios phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 9: provisioning and the plan-driven serve loop ----------------
    provision_phase(torch, dev, profile)
    print(f"[chip_smoke] provision phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 10: the ten-act tour with the full danube engine ---------------
    tour_phase(torch, results)
    print(f"[chip_smoke] tour phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 11: the model branches at full width ---------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    branches_phase(torch, dev, results, profile, seed, smi, drive, warm,
                   kernels_vs_plain)
    print(f"[chip_smoke] branches phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 12: training -----------------------------------------------------
    runs = train_phase(torch, dev, results, smi, profile)
    print(f"[chip_smoke] train phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 13: the dry run's accounting, grounded on the card ----------------
    cells, step = dryrun_phase(torch, dev, smi, runs)
    print(f"[chip_smoke] dryrun phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 14: the roofline, its counts held to a step on the card ---------
    roofline_phase(smi, cells, step, runs[DRYRUN_CARD[:3]]["warm"])
    print(f"[chip_smoke] roofline phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 15: the user entry points ----------------------------------------
    examples_phase(torch, dev, smi)
    print(f"[chip_smoke] examples phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- result lines ---------------------------------------------------------
    for name, r in results.items():
        r["launches"] = sum(r["launches_by_path"].values())
        check(r["launches"] > 0, f"{name} was never launched on a served path")
    print(f"[chip_smoke] done at {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "copy_ms",
            "shape", "launches_by_path", "other_shapes")
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
