#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile] [--seed N]

``--profile`` adds a torch.profiler breakdown of device time by kernel
over one warm prefill and the decode steps of each served path (the top
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
   shape and one decode shape, ``NORM_TIMED``), the SSD scan (mamba2-780m's
   prefill, the reference sweep in f32 and bf16, ragged S, an initial
   state; timed: the prefill and a 4096-token prompt, ``SSD_TIMED``) and
   the grouped matmul (qwen3's prefill and decode shapes in
   bf16 and f32, the reference sweep; timed: the four bf16 prefill and
   decode gate/up and down shapes).
   Tolerances are those of tests/test_kernels.py.
3. Drive the three served paths through ``repro_torch.launch.serve.main``,
   each at full width, routing one request and generating (4, 16) tokens
   from (4, 512) prompts, the launch counters set to 0 just before each
   and read just after; each count must be exact:
   - ``h2o-danube-1.8b`` f32 (24 layers): 24 flash, 49 x 16 RMSNorm; its
     prefill logits through the kernels match the plain versions;
   - ``mamba2-780m`` f32 (48 layers): 48 SSD scans, 97 x 16 RMSNorm; its
     prefill logits through the kernels match the plain versions;
   - ``qwen3-moe-30b-a3b`` bf16 (48 layers): 48 flash, 97 x 16 RMSNorm,
     3 x 48 x 16 grouped matmuls; logits finite, each layer's MoE through
     the kernels matches the plain versions on the same input.
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
6. ``[serve]``: the serving loop on the card, rebuilt from the port's own
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
7. ``[scenarios]``: the scenario matrix (``repro_torch.serve.scenarios``)
   on the card at 1M requests a scenario (the flash crowd draws ~2.36M):
   every (scenario, policy) cell of the seven scenarios x three policies,
   one line each (total, routed and latency-optimal gCO2, shed / spill /
   defer rates, mean defer, warm wall after one warm-up route); card ==
   CPU on every cell built at 20,000 requests (each side routes the same
   whole stream: decisions identical, carbon within rtol 1e-5); the three
   gates of ``repro_torch.launch.scenario_matrix`` (curtailment chase and
   spike-aware provisioning at 1M, watt caps at 200,000 x 3 seeds x 2
   policies).
8. ``[provision]``: the README's mesoscale provisioning table (20,000
   requests, ``from_sites(128, 8)``, paper fleet) exactly and card == CPU;
   the four plans of a 1M ``multi_region_stream`` on the same grid;
   ``serve_stream(plan=)`` with the greedy and the static plan at 1M under
   unit-capped placement (shed, routed and standing gCO2, warm wall; gate:
   provisioned standing + routed < static's); card == CPU on a 50,000-
   request stream with its own plan.
9. ``[tour]``: ``repro_torch.launch.tour`` (the ten acts of the serving
   tour) at its default 1M requests with ``--learned`` and the full
   ``h2o-danube-1.8b`` engine in f32, the counters set to 0 just before
   and read just after: 24 flash and 49 x 8 RMSNorm (one prefill, eight
   forward passes), no SSD scan, no grouped matmul.

The second-last line is one JSON object ``{"kernels": [...]}`` with each
kernel's launches on the served paths, error, times and bound; the line
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # no-TC f32, dense bf16 TC
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
              ((4, 2560), "float32")]
# Timed SSD scans (label, B, S, H, P, N, chunk), f32, mamba2-780m's A and
# dt: the served prefill (the kernels line's own row) and a long prompt,
# whose 64 chunks show the chunk parallelism that S = 512 hides.
SSD_TIMED = [("main", BATCH, PROMPT, 48, 64, 128, 256),
             ("long prompt", 1, 4096, 48, 64, 128, 256)]


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


def profile_path(torch, engine, prompt, label: str) -> None:
    """Device time by kernel over one warm prefill and the decode steps of
    one batch (torch.profiler). Only device-side events count: an aten
    op's own device time repeats the kernels it launched."""
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
        logits, state = engine.prefill_batch(prompt)
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


def fleet_phase(torch, dev, results, profile: bool, seed: int) -> None:
    """Phase 5: route the configurations of ``FLEET`` on the card, hold
    their decisions against the CPU, and hand ``xregion``'s admitted
    requests to the danube engine."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.carbon_intensity import CarbonGrid
    from repro_torch.core.constants import Target
    from repro_torch.core.infrastructure import pack_infra, tpu_fleet
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer
    from repro_torch.serve import (
        FleetRouter,
        OraclePolicy,
        PlacementPolicy,
        ServeEngine,
        TemporalPolicy,
    )
    from repro_torch.serve.streams import deferrable_stream, multi_region_stream

    cfg = get_config(DANUBE)

    def stream(kind, n, n_regions):
        if kind == "deferrable":
            return deferrable_stream(n, n_regions)
        return multi_region_stream(n, n_regions,
                                   seed=1 if n_regions > 4 else 0)

    def router(spec, n, device):
        _, _, _, n_regions, grid_kind, pol, frac = spec
        if grid_kind == "sites":
            grid = CarbonGrid.from_sites(n_regions, 8, seed=0, device=device)
        elif grid_kind == "fully_connected":
            grid = CarbonGrid.fully_connected(latency_penalty=1.05,
                                              device=device)
        else:
            grid = CarbonGrid.from_regions(device=device)
        infra = pack_infra(tpu_fleet(), device=device)
        caps = np.full((n_regions, 3), np.inf)
        if frac is not None:
            caps[:, 1] = caps[:, 2] = max(1.0, frac * n / (n_regions * 24))
        policy = {"oracle": lambda: OraclePolicy(infra),
                  "placement": lambda: PlacementPolicy(OraclePolicy(infra),
                                                       caps),
                  "temporal": lambda: TemporalPolicy(OraclePolicy(infra),
                                                     caps, max_defer_h=12),
                  }[pol]()
        return FleetRouter(cfg, grid=grid, policy=policy, device=device)

    def head(batch, region, t_hours, n):
        cut = {f.name: (None if getattr(batch, f.name) is None
                        else getattr(batch, f.name)[:n])
               for f in dataclasses.fields(batch)}
        return dataclasses.replace(batch, **cut), region[:n], t_hours[:n]

    def decisions(res, state, t_hours, horizon):
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

    xregion = None
    for spec in FLEET:
        name, kind, n, n_regions = spec[:4]
        t0 = time.perf_counter()
        batch, region, t_hours = stream(kind, n, n_regions)
        t_stream = time.perf_counter() - t0
        fr = router(spec, n, dev)
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
            frd = router(spec, FLEET_CHECK_N, d)
            r, st = frd.route_stream_with_state(*sub)
            got[str(d)] = (decisions(r, st, sub[2], frd.grid.horizon_h),
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
    fr, res, t_hours = xregion
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg, device=dev, dtype=torch.float32, generator=gen)
    engine = ServeEngine(cfg, model, max_seq=PROMPT + NEW + 8,
                         tier=int(Target.EDGE_DC), device=dev)
    windows = fr.admit_windows(res, t_hours, engine)
    hour = next((h for h, idx in enumerate(windows) if len(idx) >= 4), None)
    check(hour is not None, "no hourly window admitted 4 edge-DC requests")
    picked = windows[hour][:4]
    tgt = res.target.cpu().numpy()[picked]
    check(bool((tgt == int(Target.EDGE_DC)).all()),
          "admitted requests are not routed to the edge DC")
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
    check(launches == want, f"fleet handoff: launch counts {launches}, "
          f"expected {want}")
    check(tuple(tokens.shape) == (4, NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
        "fleet handoff: tokens")
    for name, r in results.items():
        r["launches_by_path"][f"xregion -> {DANUBE}"] = launches[name]
    print(f"[fleet] handoff: window {hour} admitted {len(windows[hour])} "
          f"edge-DC requests of xregion; served requests "
          f"{picked.tolist()} (exec regions "
          f"{res.exec_region.cpu().numpy()[picked].tolist()}) through "
          f"{DANUBE} f32, prompt ({len(picked)}, {PROMPT}), {NEW} new tokens "
          f"in {wall:.3f} s; launches {launches}")
    del model, engine
    torch.cuda.empty_cache()


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


def serve_phase(torch, dev, results, profile: bool, seed: int) -> None:
    """Phase 6: the serving loop on the card, rebuilt from the port's own
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
                                   ServeEngine, TemporalPolicy, WorkerPool,
                                   serve_stream)
    from repro_torch.serve.streams import (deferrable_stream_multiday,
                                           diurnal_stream, forecast_scenario)

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
    def queue(n, d):
        batch, region, t_hours = diurnal_stream(n, R)
        fr = FleetRouter(cfg, device=d,
                         grid=CarbonGrid.fully_connected(
                             latency_penalty=1.05, device=d),
                         policy=PlacementPolicy(OraclePolicy(infra(d)),
                                                np.ones((R, 3))))

        def run():
            pool = WorkerPool(R, slots_per_worker=30_000.0,
                              launch_delay_steps=0)
            for r in range(R):
                for tier in (1, 2):
                    pool.launch(r, tier, n=2)
            return serve_stream(fr, batch, region, t_hours, pool=pool)
        return fr, run

    fr_q, run_q = queue(SERVE_N, dev)
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
    same("queue", queue(SERVE_CHECK_N, dev)[1](),
         queue(SERVE_CHECK_N, cpu)[1](), SERVE_FIELDS + ("step",))

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
    """Phase 7: the 21 (scenario, policy) cells of the scenario matrix on
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
    """Phase 8: provisioning on the 128-site sparse grid: the README's 20k
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
    """Phase 9: the ten-act tour at its default 1M requests with the full
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
    from repro_torch.models import Transformer
    from repro_torch.models.moe import moe_forward
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
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name(dtype)] * 1e3
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
    results["flash_attention"]["other_shapes"] = flash_more

    # RMSNorm
    norm_cases = [((2048, 2560), torch.float32), ((2048, 2560), torch.bfloat16),
                  ((4, 2560), torch.float32), ((4, 2560), torch.bfloat16),
                  ((4, 37, 96), torch.float32), ((4, 37, 96), torch.bfloat16),
                  # qwen3 (bf16) and mamba2 (f32: d_model, gated d_inner)
                  ((2048, 2048), torch.bfloat16), ((4, 2048), torch.bfloat16),
                  ((2048, 1536), torch.float32), ((2048, 3072), torch.float32),
                  ((4, 1536), torch.float32), ((4, 3072), torch.float32)]
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

    # SSD scan
    def ssd_inputs(B, S, H, P, N, dtype, init, model_like=False):
        x = randn((B, S, H, P), dtype)
        if model_like:  # mamba2's A = -(1..H), dt = softplus(.) ~ 0.1-1
            A = -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
        else:  # tests/test_kernels.py
            A = -torch.exp(randn((H,)) * 0.5)
        dt = F.softplus(randn((B, S, H)))
        bc = randn((B, S, 1, 2 * N), dtype)
        Bm, Cm = bc[..., :N], bc[..., N:]  # strided, as the model passes them
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
    timed_labels = [c[0] for c in SSD_TIMED]
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
        if label not in timed_labels:
            continue
        nbytes, flops = ssd_work(B, S, H, P, N, L, x.element_size(), init)
        r = timed(
            "ssd_scan", f"x{(B, S, H, P)} B/C{(B, S, 1, N)} chunk {L} float32",
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

    # grouped matmul: qwen3's expert FF at prefill (G=2 groups of 1024
    # tokens, C=80) and at decode (C=8), gate/up and down, then the sweep
    gmm_cases = [  # (label, E, C, d, f, dtype)
        ("prefill gate/up", 128, 160, 2048, 768, torch.bfloat16),
        ("prefill down", 128, 160, 768, 2048, torch.bfloat16),
        ("decode gate/up", 128, 8, 2048, 768, torch.bfloat16),
        ("prefill gate/up", 128, 160, 2048, 768, torch.float32),
        ("decode down", 128, 8, 768, 2048, torch.bfloat16),
        ("decode down", 128, 8, 768, 2048, torch.float32),
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
                  f"{(E, C, d)}@{(E, d, f)} {dtype_name(dtype)}", err,
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

    def drive(arch, dtype, want):
        """One launcher run with the counters set to 0 just before it and
        read just after; the counts must equal ``want``."""
        ops.reset_launches()
        t0 = time.perf_counter()
        run = serve.main(["--arch", arch, "--no-smoke", "--device", "cuda",
                          "--dtype", dtype, "--batch", str(BATCH),
                          "--prompt-len", str(PROMPT),
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
        check(n_params == cfg.param_count(), "parameter count")
        check(tuple(run.tokens.shape) == (BATCH, NEW), "token shape")
        check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all()),
              "token ids out of range")
        want = dict({k: 0 for k in launches}, **want)
        check(launches == want, f"{arch}: launch counts {launches}, "
              f"expected {want}")
        for name, r in results.items():
            r["launches_by_path"][arch] = launches[name]
        return run

    def warm(run, label):
        engine = run.engine
        t0 = time.perf_counter()
        logits, state = engine.prefill_batch(run.prompt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = [logits]
        for _ in range(NEW - 1):
            logits, state = engine.serve_step(
                state, logits.argmax(-1, keepdim=True))
            outs.append(logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"[main] {label} again, warm: prefill ({BATCH}, {PROMPT}) "
              f"{t1 - t0:.4f} s, {NEW - 1} decode steps {t2 - t1:.4f} s "
              f"({(t2 - t1) / (NEW - 1) * 1e3:.2f} ms/step)")
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"{label}: non-finite logits")
        if profile:
            profile_path(torch, engine, run.prompt, label)

    def kernels_vs_plain(run, label):
        model, max_seq = run.engine.model, run.engine.max_seq
        lk, _ = model.prefill(run.prompt, max_seq=max_seq, kernels=ops.KERNELS)
        lp, _ = model.prefill(run.prompt, max_seq=max_seq, kernels=ops.PLAIN)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lk).all()), f"{label}: non-finite logits")
        err = (lk - lp).abs().max().item()
        print(f"[main] {label} prefill logits {tuple(lk.shape)} kernels vs "
              f"plain: max_abs_err {err:.3e} (tol {LOGITS_TOL:g}), "
              f"logit std {lp.std().item():.3f}")
        check(torch.allclose(lk, lp, atol=LOGITS_TOL, rtol=LOGITS_TOL),
              f"{label}: prefill logits through the kernels disagree with "
              "the plain path")

    L_D = get_config(DANUBE).n_layers
    run = drive(DANUBE, "float32", {"flash_attention": L_D,
                                    "fused_rmsnorm": (2 * L_D + 1) * NEW})
    warm(run, DANUBE)
    kernels_vs_plain(run, DANUBE)
    run = None
    torch.cuda.empty_cache()

    L_M = get_config(MAMBA).n_layers
    run = drive(MAMBA, "float32", {"ssd_scan": L_M,
                                   "fused_rmsnorm": (2 * L_M + 1) * NEW})
    warm(run, MAMBA)
    kernels_vs_plain(run, MAMBA)
    run = None
    torch.cuda.empty_cache()

    cfg_q = get_config(QWEN3)
    L_Q = cfg_q.n_layers
    run = drive(QWEN3, "bfloat16", {"flash_attention": L_Q,
                                    "fused_rmsnorm": (2 * L_Q + 1) * NEW,
                                    "grouped_matmul": 3 * L_Q * NEW})
    warm(run, QWEN3)
    # Each layer's MoE on the hidden state that enters it on the plain
    # path, through both kernel sets: with one input the routing is one,
    # so the outputs compare at the bf16 tolerance (whole-model bf16
    # logits do not: one flipped top-8 choice upstream moves them far).
    model = run.engine.model
    entering = []
    hooks = [layer.moe.register_forward_pre_hook(
        lambda mod, args: entering.append(args[0].clone()))
        for layer in model.layers]
    with torch.no_grad():
        lp, _ = model.prefill(run.prompt, max_seq=run.engine.max_seq,
                              kernels=ops.PLAIN)
    for h in hooks:
        h.remove()
    check(len(entering) == L_Q and bool(torch.isfinite(lp).all()),
          "plain prefill of qwen3")
    del lp
    worst = 0.0
    with torch.no_grad():
        for i, (layer, h) in enumerate(zip(model.layers, entering)):
            ok_, _ = moe_forward(layer.moe, cfg_q, h, kernels=ops.KERNELS)
            op_, _ = moe_forward(layer.moe, cfg_q, h, kernels=ops.PLAIN)
            torch.cuda.synchronize()
            err = (ok_.float() - op_.float()).abs().max().item()
            worst = max(worst, err)
            check(torch.allclose(ok_.float(), op_.float(), atol=TOL["bfloat16"],
                                 rtol=TOL["bfloat16"]),
                  f"{QWEN3} layer {i}: MoE through the kernels disagrees "
                  f"with the plain versions (max_abs_err {err:.3e})")
    print(f"[main] {QWEN3} each of {L_Q} layers' MoE, kernels vs plain on "
          f"the plain path's hidden state: worst max_abs_err {worst:.3e} "
          f"(atol = rtol = {TOL['bfloat16']:g})")
    del model, entering, hooks
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

    # --- phase 6: the serving loop on the card, then the handoff ---------------
    serve_phase(torch, dev, results, profile, seed)
    print(f"[chip_smoke] serve phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 7: the scenario matrix and its gates ---------------------------
    scenarios_phase(torch, dev, profile)
    print(f"[chip_smoke] scenarios phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 8: provisioning and the plan-driven serve loop ----------------
    provision_phase(torch, dev, profile)
    print(f"[chip_smoke] provision phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- phase 9: the ten-act tour with the full danube engine ---------------
    tour_phase(torch, results)
    print(f"[chip_smoke] tour phase done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # --- result lines ---------------------------------------------------------
    for name, r in results.items():
        r["launches"] = sum(r["launches_by_path"].values())
        check(r["launches"] > 0, f"{name} was never launched on a served path")
    print(f"[chip_smoke] done at {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
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
