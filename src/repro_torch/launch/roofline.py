"""Roofline of the dry-run matrix, priced at one device's published rates:
port of ``benchmarks/roofline.py`` and ``tools/render_roofline.py``.

Reads the dry run's ``--json`` artifact (``python -m
repro_torch.launch.dryrun --all --both-meshes --json X.json``) and gives
each runnable (arch x shape x mesh) cell three per-device terms:

  compute    = flops_per_device / the peak FLOP/s of the cell's dtype
  memory     = bytes_accessed / the HBM bandwidth
  collective = each collective's bytes / the bandwidth of the link its
               process group spans, summed

Every count is per device (``launch.costs.DeviceCostMode`` over one
device's step on meta tensors). ``bytes_accessed`` is eager PyTorch's, op
by op with nothing fused, so the memory term is a ceiling on a fused
program's, not the floor a roofline's terms are: a cell whose largest term
is the memory term is bound ``eager-memory``, which says only that the
eager program moves more than the compute and collective terms allow for,
not that a fused one would be bound by memory. MODEL_FLOPS is the reference's 6·N·D (train), 2·N·D (prefill)
or 2·N·B (decode), N the active parameters; MODEL over the counted FLOPs
shows what remat and masked attention add.

Usage (one row per cell; ``--render`` adds the markdown tables of
``tools/render_roofline.py``):
  PYTHONPATH=src python -m repro_torch.launch.roofline [--artifact X.json] [--render]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path
from typing import NamedTuple

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ShapeKind

DEFAULT_ARTIFACT = (Path(__file__).resolve().parents[3] / "artifacts"
                    / "dryrun_torch.json")


@dataclasses.dataclass(frozen=True)
class Rates:
    """One device's peak rates, and the links between devices: a process
    group whose ranks all lie in one node of ``devices_per_node`` talks at
    ``intra_node`` B/s per direction, any other at ``inter_node``."""

    name: str
    bf16_flops: float  # FLOP/s, dense
    f32_flops: float  # FLOP/s
    hbm: float  # B/s
    intra_node: float  # B/s
    inter_node: float  # B/s
    devices_per_node: int

    def peak(self, dtype: str) -> float:
        return self.f32_flops if dtype == "float32" else self.bf16_flops

    def link(self, span: list[int]) -> float:
        """B/s of a group whose global ranks run from span[0] to span[1]."""
        lo, hi = span
        same = lo // self.devices_per_node == hi // self.devices_per_node
        return self.intra_node if same else self.inter_node


# NVIDIA's data sheet for the H100 SXM5 (80 GB HBM3), dense rates without
# sparsity, at its full 700 W: 989 TFLOP/s bf16 on the tensor cores,
# 67 TFLOP/s float32 without them (the port's parity runs keep TF32 off),
# 3.35 TB/s HBM3; NVLink 4 at 450 GB/s each way inside an 8-GPU HGX node;
# across nodes one 400 Gb/s NDR InfiniBand NIC per GPU, 50 GB/s.
# Spec-sheet figures, not measurements.
H100_SXM = Rates(name="NVIDIA H100 SXM5", bf16_flops=989e12,
                 f32_flops=67e12, hbm=3.35e12, intra_node=450e9,
                 inter_node=50e9, devices_per_node=8)


class Row(NamedTuple):
    """One result row, as ``benchmarks.common.BenchRow`` prints it."""

    name: str
    us_per_call: float
    derived: str


def model_flops(arch: str, shape_id: str) -> float:
    cfg = get_config(arch)
    shape = get_shape(shape_id)
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == ShapeKind.TRAIN:
        return 6.0 * n_active * tokens
    if shape.kind == ShapeKind.PREFILL:
        return 2.0 * n_active * tokens
    # decode: one new token per sequence
    return 2.0 * n_active * shape.global_batch


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    dtype: str
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    hlo_flops_total: float  # the counted FLOPs of every device
    useful_ratio: float
    peak_mem_gib: float

    def derived(self) -> str:
        return (f"compute={self.t_compute:.4f}s;memory={self.t_memory:.4f}s;"
                f"collective={self.t_collective:.4f}s;"
                f"bound={self.bottleneck};"
                f"useful={self.useful_ratio:.2f};"
                f"peak={self.peak_mem_gib:.1f}GiB")


def analyze(record: dict, rates: Rates = H100_SXM) -> RooflineRow | None:
    """The three terms of one dry-run record (None for a SKIP or FAIL)."""
    if not record.get("ok"):
        return None
    chips = 1
    for d in record["mesh"].split("x"):
        chips *= int(d)
    t_c = record["flops_per_device"] / rates.peak(record["dtype"])
    t_m = record["bytes_accessed"] / rates.hbm
    by_link = collections.Counter()
    for g in record["collective_groups"]:
        by_link[rates.link(g["span"])] += g["bytes"]
    t_x = sum(b / rate for rate, b in by_link.items())
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bound = max(terms, key=terms.get)
    if bound == "memory":  # the term is a ceiling (module docstring)
        bound = "eager-memory"
    mf = model_flops(record["arch"], record["shape"])
    total = record["flops_per_device"] * chips
    return RooflineRow(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        dtype=record["dtype"], chips=chips, t_compute=t_c, t_memory=t_m,
        t_collective=t_x, bottleneck=bound, model_flops=mf,
        hlo_flops_total=total, useful_ratio=mf / max(total, 1e-30),
        peak_mem_gib=record["peak_mem_per_device"] / 2 ** 30)


def run(artifact: str | Path = DEFAULT_ARTIFACT) -> list[Row]:
    """One ``roofline/<arch>/<shape>/<mesh>`` row per record."""
    if not Path(artifact).exists():
        return [Row("roofline/ARTIFACT_MISSING", 0.0,
                    f"run `python -m repro_torch.launch.dryrun --all "
                    f"--both-meshes --json {artifact}` first")]
    with open(artifact) as f:
        records = json.load(f)
    rows = []
    for rec in records:
        rr = analyze(rec)
        name = f"roofline/{rec['arch']}/{rec['shape']}/{rec['mesh']}"
        rows.append(Row(name, 0.0, "SKIP:" + rec.get("error", "")[:70])
                    if rr is None else Row(name, 0.0, rr.derived()))
    return rows


def render(records: list[dict]) -> str:
    """The dry-run matrix and the single-pod (16x16) roofline as markdown
    tables."""
    out = ["### Dry-run matrix\n",
           "| arch | shape | mesh | kind | FLOPs/dev | bytes/dev | "
           "coll bytes/dev | peak GiB/dev | count s |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if not r["ok"]:
            why = "skip (long-context needs sub-quadratic attn)" \
                if r["error"].startswith("SKIP") else f"FAIL {r['error'][:60]}"
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['kind']} | {why} | | | | |")
            continue
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                   f"{r['kind']} | {r['flops_per_device']:.3e} | "
                   f"{r['bytes_accessed']:.3e} | "
                   f"{r['collective_bytes'].get('total', 0):.3e} | "
                   f"{r['peak_mem_per_device'] / 2**30:.2f} | "
                   f"{r['count_s']:.0f} |")
    out += [f"\n### Roofline terms (single-pod 16x16; per-step seconds at "
            f"{H100_SXM.name} rates; memory at eager bytes, a ceiling)\n",
            "| arch | shape | compute s | memory s | collective s | bound | "
            "MODEL/counted flops | roofline frac | peak GiB |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r["mesh"] != "16x16":
            continue
        rr = analyze(r)
        if rr is None:
            continue
        dominant = max(rr.t_compute, rr.t_memory, rr.t_collective)
        # roofline fraction: ideal model-compute time / dominant term (a
        # floor where that term is the eager memory ceiling)
        ideal = rr.model_flops / (rr.chips * H100_SXM.peak(rr.dtype))
        frac = ideal / max(dominant, 1e-30)
        out.append(f"| {rr.arch} | {rr.shape} | {rr.t_compute:.3g} | "
                   f"{rr.t_memory:.3g} | {rr.t_collective:.3g} | "
                   f"{rr.bottleneck} | {rr.useful_ratio:.2f} | {frac:.2f} | "
                   f"{rr.peak_mem_gib:.1f} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", default=str(DEFAULT_ARTIFACT))
    ap.add_argument("--render", action="store_true",
                    help="the markdown tables after the rows")
    args = ap.parse_args(argv)
    for row in run(args.artifact):
        print(f"{row.name},{row.us_per_call:.2f},{row.derived}")
    if args.render and Path(args.artifact).exists():
        with open(args.artifact) as f:
            print("\n" + render(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
