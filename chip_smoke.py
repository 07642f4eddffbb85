#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile]

``--profile`` adds a torch.profiler breakdown of device time by kernel
over one warm ``generate`` of the main path.

Phases (any failure ends the script with a non-zero exit):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source) and print the build time and ptxas' resource lines.
2. Hold each kernel against its plain PyTorch version on the card at the
   main-path shapes (flash attention f32/bf16, with a window, ragged S=96;
   RMSNorm at prefill, decode and odd widths) within 5e-4 (f32) / 2e-2
   (bf16), and time kernel, plain version and one PyTorch library call
   with CUDA events, the L2 cache flushed before every launch.
3. Drive the main path: ``repro_torch.launch.serve.main`` on the full
   ``h2o-danube-1.8b`` (24 layers, d_model 2560, f32) routing one request
   and generating (4, 16) tokens from (4, 512) prompts; the launch counters
   must rise by exactly 24 (flash, prefill) and 49 x 16 (RMSNorm); the
   prefill logits through the kernels must match the same module's prefill
   through the plain versions.
4. Check the card against the CPU on small inputs: the smoke config's
   logits and greedy tokens, and the full config's routing decision.

The second-last line is one JSON object ``{"kernels": [...]}`` with each
kernel's launches on the main path, error, times and bound; the line before
it is the card's name and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device or
without the repository beside this file.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # no-TC f32, dense bf16 TC
TOL = {"float32": 5e-4, "bfloat16": 2e-2}  # tests/test_kernels.py _tol
LOGITS_TOL = 2e-3  # kernels vs plain versions through 24 f32 layers
ARCH = "h2o-danube-1.8b"
BATCH, PROMPT, NEW = 4, 512, 16


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def profile_generate(torch, engine, prompt) -> None:
    """Device time by kernel over one warm ``generate`` (torch.profiler).
    Only device-side events count: an aten op's own device time repeats
    the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=NEW)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] generate under the profiler: wall {wall_us / 1e3:.1f} ms, "
          f"kernels {busy / 1e3:.1f} ms ({busy / wall_us:.1%} busy)")
    for us, count, key in rows[:15]:
        print(f"[profile]   {us / 1e3:9.3f} ms {us / busy:6.1%} x{count:<5} "
              f"{key[:90]}")


def main() -> None:
    profile = "--profile" in sys.argv[1:]
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
    from repro_torch.serve import GreenScaleRouter, Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # --- phase 1: build --------------------------------------------------------
    info = build.build()
    print(f"[build] {info.path.name}: {info.seconds:.1f} s"
          f"{' (cached)' if info.cached else ''}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build]   {line.strip()}")
    build.library()

    # --- phase 2: kernels against their plain versions ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def randn(shape, dtype):
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

    def compare(name, got, want, dtype):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[str(dtype).split(".")[1]]
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        print(f"[kernel] {name}: max_abs_err {err:.3e} (atol = rtol = {tol:g}) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} disagrees with its plain version")
        return err

    def bound(nbytes, flops, dtype):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    results = {}
    flash_cases = [  # (label, B, S, H, Hkv, D, window, dtype)
        ("main f32", BATCH, PROMPT, 32, 8, 80, None, torch.float32),
        ("main bf16", BATCH, PROMPT, 32, 8, 80, None, torch.bfloat16),
        ("window 256", 2, 1024, 32, 8, 80, 256, torch.float32),
        ("ragged S=96 D=16", 2, 96, 4, 2, 16, 16, torch.float32),
        ("ragged S=96 D=16 bf16", 2, 96, 4, 2, 16, 16, torch.bfloat16),
    ]
    for label, B, S, H, Hkv, D, window, dtype in flash_cases:
        q, k, v = (randn((B, S, h, D), dtype) for h in (H, Hkv, Hkv))
        err = compare(f"flash_attention {label} q{(B, S, H, D)}",
                      ops.flash_attention(q, k, v, causal=True, window=window),
                      ref.flash_attention_ref(q, k, v, causal=True,
                                              window=window), dtype)
        if label != "main f32":
            continue
        pos = torch.arange(S)
        pairs = int((pos[None, :] <= pos[:, None]).sum())  # visible (q, k)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound(nbytes, 4 * B * H * D * pairs, dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        results["flash_attention"] = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:27",
            shape=f"q{(B, S, H, D)} kv{(B, S, Hkv, D)} causal float32",
            max_abs_err=err,
            ms=time_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                             causal=True)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)))

    norm_cases = [((2048, 2560), torch.float32), ((2048, 2560), torch.bfloat16),
                  ((4, 2560), torch.float32), ((4, 2560), torch.bfloat16),
                  ((4, 37, 96), torch.float32), ((4, 37, 96), torch.bfloat16)]
    for shape, dtype in norm_cases:
        x = randn(shape, dtype)
        scale = randn(shape[-1:], torch.float32)
        err = compare(f"fused_rmsnorm {shape} {str(dtype)[6:]}",
                      ops.fused_rmsnorm(x, scale), ref.rmsnorm_ref(x, scale),
                      dtype)
        if shape != (2048, 2560) or dtype != torch.float32:
            continue
        nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
        b_ms, b_by = bound(nbytes, 4 * x.numel(), dtype)
        results["fused_rmsnorm"] = dict(
            name="fused_rmsnorm", route="cuda",
            source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:19",
            shape="x(2048, 2560) float32",
            max_abs_err=err,
            ms=time_ms(lambda: ops.fused_rmsnorm(x, scale)),
            plain_ms=time_ms(lambda: ref.rmsnorm_ref(x, scale)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.rms_norm(x, (shape[-1],), scale,
                                                  1e-5)))
    for r in results.values():
        print(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    del flush

    # --- phase 3: the main path at full width ---------------------------------
    ops.reset_launches()
    t0 = time.perf_counter()
    run = serve.main(["--arch", ARCH, "--no-smoke", "--device", "cuda",
                      "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                      "--new-tokens", str(NEW)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cfg = run.cfg
    n_params = sum(p.numel() for p in run.engine.model.parameters())
    print(f"[main] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B f32 params; tokens {tuple(run.tokens.shape)}; "
          f"{wall:.1f} s including init; launches {launches}")
    check(cfg.n_layers == 24 and cfg.d_model == 2560, "not the full config")
    check(n_params == cfg.param_count(), "parameter count")
    check(tuple(run.tokens.shape) == (BATCH, NEW), "token shape")
    check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all()),
          "token ids out of range")
    want = {"flash_attention": cfg.n_layers,
            "fused_rmsnorm": (2 * cfg.n_layers + 1) * NEW}
    check(launches == want, f"launch counts {launches}, expected {want}")
    for name in results:
        results[name]["launches"] = launches[name]

    engine, model = run.engine, run.engine.model
    t0 = time.perf_counter()
    logits, state = engine.prefill_batch(run.prompt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(NEW - 1):
        logits, state = engine.serve_step(state, logits.argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[main] again, warm: prefill ({BATCH}, {PROMPT}) {t1 - t0:.4f} s, "
          f"{NEW - 1} decode steps {t2 - t1:.4f} s "
          f"({(t2 - t1) / (NEW - 1) * 1e3:.2f} ms/step)")
    if profile:
        profile_generate(torch, engine, run.prompt)
    max_seq = run.engine.max_seq
    lk, _ = model.prefill(run.prompt, max_seq=max_seq, kernels=ops.KERNELS)
    lp, _ = model.prefill(run.prompt, max_seq=max_seq, kernels=ops.PLAIN)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lk).all()), "non-finite prefill logits")
    err = (lk - lp).abs().max().item()
    print(f"[main] prefill logits {tuple(lk.shape)} kernels vs plain: "
          f"max_abs_err {err:.3e} (tol {LOGITS_TOL:g}), "
          f"logit std {lp.std().item():.3f}")
    check(torch.allclose(lk, lp, atol=LOGITS_TOL, rtol=LOGITS_TOL),
          "prefill logits through the kernels disagree with the plain path")
    del model, run, lk, lp
    torch.cuda.empty_cache()

    # --- phase 4: card against CPU on small inputs -----------------------------
    smoke = get_config(ARCH, smoke=True)
    cpu_model = Transformer(smoke, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    gpu_model = Transformer(smoke, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    toks = torch.randint(0, smoke.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    lc, _ = cpu_model.prefill(toks, max_seq=64)
    lg, _ = gpu_model.prefill(toks.to(dev), max_seq=64)
    err = (lg.cpu() - lc).abs().max().item()
    print(f"[small] smoke prefill logits card vs CPU: max_abs_err {err:.3e}")
    check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4),
          "smoke logits on the card disagree with the CPU")
    eng = {d: ServeEngine(smoke, m, max_seq=64, device=d)
           for d, m in (("cpu", cpu_model), ("cuda", gpu_model))}
    tc = eng["cpu"].generate(toks, max_new_tokens=12)
    tg = eng["cuda"].generate(toks, max_new_tokens=12)
    check(torch.equal(tc, tg.cpu()), "greedy tokens differ card vs CPU")
    print("[small] smoke greedy tokens card == CPU")
    full = get_config(ARCH)
    req = Request(prompt_tokens=PROMPT, max_new_tokens=NEW)
    dec = {d: GreenScaleRouter(full, device=d).route(
        req, serve.env_at_hour(12, device=d)) for d in ("cpu", "cuda")}
    check(dec["cpu"].target == dec["cuda"].target, "routing target differs")
    check(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(
        dec["cuda"].per_target_carbon, dec["cpu"].per_target_carbon)),
        "routed carbon differs card vs CPU")
    print(f"[small] routing at hour 12 card == CPU: target "
          f"{serve.TARGETS[dec['cuda'].target]}")

    # --- result lines ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
