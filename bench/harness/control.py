"""The readings that a cell's limits are set from and held against: the
control and the faults, beside the program's own run, each put through
the rule that decides ``correct`` (``record.within``).

- a served cell: the control, the plain reference computed in the nearest
  precision below the configuration's (float32 with TF32 off -> TF32,
  bfloat16 -> fp8 e4m3; ``reference.precision``) at every judged position,
  read by the gap of the token it puts first; where the configuration is
  bfloat16, also the witness, the reference with bf16-rounded operands,
  which stands for sound rounding and is not a control;
- a training cell: the control, and the reference trained with half of
  each batch left out (the mean over the rest), each read against the
  sound reference by the same numbers; a state left unchanged reads 1 on
  ``change_norm_gap`` by the measure itself and needs no run.

``bench/calibrate.py`` drives these on the card; the tests on the CPU.
"""

from __future__ import annotations

import torch

from bench.harness import port
from bench.harness.record import Run, within
from bench.reference import judge
from bench.reference import train as ref_train

#: readings that must come out not correct
MUST_FAIL = ("control", "half_batch", "state_unchanged")


def control_precision(cfg: dict) -> str:
    if cfg["dtype"] == "float32" and not cfg["tf32"]:
        return "tf32"
    if cfg["dtype"] in ("bfloat16", "float16"):
        return "fp8"
    raise ValueError(f"no control for {cfg['dtype']} (tf32 {cfg['tf32']})")


def serve_readings(run: Run, device) -> tuple[dict, dict]:
    """({kind: numbers}, {kind: every judged token's gap}) of the program,
    the control and, for a bf16 configuration, the witness."""
    cfg, j = run.config, run.judged
    draw = port.draw_fn(cfg, run.family, run.seed, device)
    modes = {"control": control_precision(cfg)}
    if cfg["dtype"] == "bfloat16":
        modes["witness"] = "bf16"
    gaps = {"program": judge.gaps(j["refs"], j["served"])}
    for kind, mode in modes.items():
        other = run.family.served_logits(cfg, draw, j["batches"],
                                         precision=mode)
        gaps[kind] = judge.gaps(j["refs"], [o.argmax(-1) for o in other])
        del other
    nums = {k: judge.numbers_of(g) for k, g in gaps.items()}
    return nums, {k: g.tolist() for k, g in gaps.items()}


def train_readings(run: Run, device) -> tuple[dict, dict]:
    """({kind: numbers}, {}) of the program, the control, half of each
    batch, and a state left unchanged."""
    cfg, j, rec = run.config, run.judged, run.workload["recipe"]
    fam = run.family
    draw = port.draw_fn(cfg, fam, run.seed, device)
    data = [(b["tokens"], b["labels"]) for b in j["data"]]
    ctl = ref_train.steps(cfg, fam, draw, data, rec,
                          precision=control_precision(cfg))
    half = [(t[: t.shape[0] // 2], lab[: lab.shape[0] // 2])
            for t, lab in data]
    hb = ref_train.steps(cfg, fam, draw, half, rec)

    def num(got):
        return {k: v for k, v in ref_train.numbers(got, j["ref"]).items()
                if not k.startswith("worst")}
    return {"program": dict(j["numbers"]), "control": num(ctl),
            "half_batch": num(hb),
            "state_unchanged": {"change_norm_gap": 1.0}}, {}


def readings(run: Run, device) -> tuple[dict, dict]:
    if run.workload["driver"] == "train":
        return train_readings(run, device)
    with torch.no_grad():
        return serve_readings(run, device)


def verdicts(nums: dict, limits: dict) -> dict:
    """{kind: {"correct": bool, "checks": {name: [value, limit]}}}: each
    reading held against the cell's limits by the rule of ``correct``. A
    reading is held on the numbers it has (a state left unchanged has
    only its change); one that has none of the limited numbers raises."""
    out = {}
    for kind, got in nums.items():
        checks = {k: (got[k], lim) for k, lim in limits.items() if k in got}
        if not checks:
            raise ValueError(f"{kind} reads none of {sorted(limits)}")
        out[kind] = {"correct": within(checks),
                     "checks": {k: list(v) for k, v in checks.items()}}
    return out


def faults_caught(verdict: dict) -> bool:
    """Every control and fault reads not correct."""
    return not any(v["correct"] for k, v in verdict.items()
                   if k in MUST_FAIL)
