"""Compressed data parallelism of the port (``repro_torch.train.
compression`` under ``make_train_step(mesh=...)``) over gloo worlds of 2
and 4 spawned ranks (``tests/torch_train_parity.py``, no JAX in the
children):

* ``compress_and_reduce`` in the bf16 and int8 modes equals a numpy model
  of the reference's per-rank body (``src/repro/train/compression.py``)
  on the same gradients and residuals, bit for bit: the int8 sums are
  exact; a bf16 all-reduce rounds once per addition, in an order the
  backend picks for each element (gloo's ring starts each chunk of the
  buffer at another rank), so each element must equal the bf16 sum of the
  ranks' values in one of the rank orders (at 2 ranks there is one sum);
* every rank ends a training run with the same parameters, in every mode;
* ``none`` equals the single-process step on the global batch (losses and
  grad norms over two steps);
* int8 at 2 ranks matches the reference's compressed step run by XLA at 2
  host devices (a subprocess, ``--xla_force_host_platform_device_count=2``;
  the reference's bf16 mode aborts XLA's CPU compiler there, ROADMAP C):
  losses within 1e-5 and grad norms within 1e-4 relative over two steps
  (a rounding boundary can move one int8 level when the two packages'
  gradients differ by float noise)."""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_train_parity as tp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.train import adamw, constant_lr, init_train_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT_S = 240
WORLDS = (2, 4)
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4

# The reference's int8 compressed step at 2 host devices: writes the
# initial params in the port's names, the global batches and each step's
# loss and grad norm to the npz named by argv[1].
REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig, ShapeKind
from repro.data import batch_for
from repro.models import init_params
from repro.train.optimizer import adamw, constant_lr
from repro.train.train_step import init_train_state, make_train_step
from repro_torch.configs import get_config as port_config
from repro_torch.models import jax_tree_names

assert jax.device_count() == 2, jax.devices()
cfg = get_config("h2o-danube-1.8b", smoke=True)
params = init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
out = {f"param/{k}": v for k, v in jax_tree_names(
    port_config("h2o-danube-1.8b", smoke=True),
    jax.tree.map(np.asarray, params)).items()}
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
opt = adamw(constant_lr(%(lr)r))
state = init_train_state(params, opt, compression="int8", mesh=mesh,
                         data_axes=("data",))
step = jax.jit(make_train_step(cfg, opt, mesh=mesh, compression="int8"))
shape = ShapeConfig("t", ShapeKind.TRAIN, 32, 8)
for i in range(%(steps)d):
    batch = batch_for(cfg, shape, step=i)
    for k in ("tokens", "labels"):
        out[f"batch/{i}/{k}"] = np.asarray(batch[k])
    state, m = step(state, batch)
    out[f"ref/loss/{i}"] = float(m["loss"])
    out[f"ref/grad_norm/{i}"] = float(m["grad_norm"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The reference run's npz (params, batches, int8 losses and norms)."""
    path = tmp_path_factory.mktemp("ref") / "case.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE % dict(lr=tp.LR, steps=tp.STEPS),
         str(path)], env=env, capture_output=True, text=True,
        timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def worlds(case, tmp_path_factory):
    """{world size: each rank's records} for worlds of 2 and 4."""
    out = {}
    for n in WORLDS:
        workdir = tmp_path_factory.mktemp(f"world{n}")
        np.savez(workdir / "case.npz", **case)
        out[n] = tp.run_world(n, str(workdir))
    return out


def _bf16_model(world_size, it, ef):
    """(the mean in every rank order of the bf16 additions, stacked on a
    leading axis; each rank's new residual)."""
    comp = [{k: g + e[k] for k, g in tp.fake_grads(r, it).items()}
            for r, e in enumerate(ef)]
    mean, new_ef = {}, [dict() for _ in ef]
    for k in comp[0]:
        sent = [c[k].astype(ml_dtypes.bfloat16) for c in comp]
        sums = []
        for order in itertools.permutations(range(world_size)):
            total = sent[order[0]]
            for r in order[1:]:
                total = (total.astype(np.float32) + sent[r].astype(np.float32)
                         ).astype(ml_dtypes.bfloat16)
            sums.append(total.astype(np.float32) / np.float32(world_size))
        mean[k] = np.stack(sums)
        for r, c in enumerate(comp):
            new_ef[r][k] = c[k] - sent[r].astype(np.float32)
    return mean, new_ef


def _int8_model(world_size, it, ef):
    comp = [{k: g + e[k] for k, g in tp.fake_grads(r, it).items()}
            for r, e in enumerate(ef)]
    mean, new_ef = {}, [dict() for _ in ef]
    for k in comp[0]:
        amax = max(np.float32(np.abs(c[k]).max()) for c in comp)
        scale = np.float32(max(amax, np.float32(1e-12)) / np.float32(127.0))
        q = [np.clip(np.round(c[k] / scale), -127, 127) for c in comp]
        summed = sum(qi.astype(np.int32) for qi in q).astype(np.float32)
        mean[k] = summed * scale / np.float32(world_size)
        for r, c in enumerate(comp):
            new_ef[r][k] = c[k] - q[r].astype(np.float32) * scale
    return mean, new_ef


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compress_and_reduce_equals_numpy_model(worlds, n, mode):
    records = worlds[n]
    model = {"int8": _int8_model, "bf16": _bf16_model}[mode]
    ef = [tp.fake_residual(r) for r in range(n)]
    for it in range(tp.ITERS):
        mean, ef = model(n, it, ef)
        for r, rec in enumerate(records):
            for k in mean:
                got = rec[f"reduce/{mode}/{it}/mean/{k}"]
                if mode == "int8":
                    np.testing.assert_array_equal(got, mean[k])
                else:
                    assert (mean[k] == got).any(axis=0).all(), k
                np.testing.assert_array_equal(
                    rec[f"reduce/{mode}/{it}/ef/{k}"], ef[r][k])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", tp.MODES)
def test_every_rank_ends_with_the_same_parameters(worlds, n, mode):
    records = worlds[n]
    keys = [k for k in records[0] if k.startswith(f"train/{mode}/")]
    for rec in records[1:]:
        for k in keys:
            np.testing.assert_array_equal(rec[k], records[0][k], err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_uncompressed_equals_single_process_global_batch(worlds, n, case):
    records = worlds[n]
    model = Transformer(get_config(tp.ARCH, smoke=True), device="cpu")
    names = [k for k, _ in model.named_parameters()]
    opt = adamw(constant_lr(tp.LR))
    state = init_train_state({k: torch.from_numpy(case[f"param/{k}"]).clone()
                              for k in names}, opt)
    step = make_train_step(model, opt)
    for i in range(tp.STEPS):
        batch = {k: torch.from_numpy(case[f"batch/{i}/{k}"]).long()
                 for k in ("tokens", "labels")}
        state, m = step(state, batch)
        np.testing.assert_allclose(records[0][f"train/none/loss/{i}"],
                                   float(m["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(records[0][f"train/none/grad_norm/{i}"],
                                   float(m["grad_norm"]), rtol=LOSS_RTOL)


def test_int8_matches_reference_compressed_step(worlds, case):
    records = worlds[2]
    for i in range(tp.STEPS):
        np.testing.assert_allclose(records[0][f"train/int8/loss/{i}"],
                                   case[f"ref/loss/{i}"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(records[0][f"train/int8/grad_norm/{i}"],
                                   case[f"ref/grad_norm/{i}"],
                                   rtol=GNORM_RTOL)
