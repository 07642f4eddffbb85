"""Shared arithmetic of the metric readers in ``bench/metrics/``: the
traced phases' model FLOPs and kernel bounds, from the counts of the
cell's family (``run.family``). A reader returns None where its phase or
kernel is absent from the trace."""

from __future__ import annotations

from bench.roofline import peaks


def phase(run, name: str):
    """The traced phase, None without a trace, without the phase, or
    without any device activity (a CPU run)."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    p = run.trace.phases.get(name)
    return p if p is not None and p.metas and p.wall_s > 0 else None


def phase_flops(run, name: str) -> float:
    cfg, p, fam = run.config, run.trace.phases[name], run.family
    if name == "prefill":
        return sum(fam.prefill_flops(cfg, x["batch"], x["prompt"])
                   for x in p.metas)
    if name == "decode":
        return sum(fam.decode_flops(cfg, x["batch"], x["prompt"] + x["start"] + s)
                   for x in p.metas for s in range(x["steps"]))
    if name == "train":
        return sum(x["steps"] * fam.train_flops(cfg, x["batch"], x["seq"])
                   for x in p.metas)
    raise ValueError(name)


def _dtype(cfg: dict) -> str:
    """The dtype whose peak the configuration runs at; no peak is tabled
    for TF32, which no configuration here turns on."""
    if cfg["tf32"]:
        raise ValueError(f"{cfg['name']}: no peak for TF32")
    return cfg["dtype"]


def mfu_pct(run, name: str) -> float | None:
    """Model FLOPs of the phase over its wall time at the dtype's peak."""
    p = phase(run, name)
    if p is None:
        return None
    rate = peaks.flops(_dtype(run.config))
    return 100.0 * phase_flops(run, name) / (p.wall_s * rate)


def idle_pct(run, name: str) -> float | None:
    p = phase(run, name)
    return None if p is None else p.idle_pct


def roofline_pct(run, name: str, kernel: str, prefix: str) -> float | None:
    """The least time of the phase's calls of ``kernel`` (frozen counts)
    over the device time of the kernels named ``prefix*`` in it."""
    p = phase(run, name)
    if p is None:
        return None
    cfg = run.config
    least, calls = 0.0, 0
    for x in p.metas:
        steps = x.get("steps", 1) if name == "decode" else 1
        per = run.family.layer_calls(cfg, x["batch"], x["prompt"],
                                     name)[kernel]
        least += steps * sum(peaks.least_seconds(f, b, _dtype(cfg))
                             for f, b in per)
        calls += steps * len(per)
    seconds, launches = p.kernels(prefix)
    if not calls or seconds <= 0:
        return None
    return 100.0 * least / seconds
