"""Multi-pod dry run: account every (arch x shape x mesh) cell on meta
tensors over a fake process group, port of ``src/repro/launch/dryrun.py``.

The reference proves its distribution config coherent by lowering and
compiling each cell's step on 512 virtual host devices; the port runs the
same steps on ``device="meta"`` (nothing is allocated) inside
``launch.mesh.fake_world``, one process standing for every rank. For each
cell it reports:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the meta
  prefill, decode step, or ``loss_fn`` + backward (under the cell's remat
  policy and microbatches), through ``models.train_paths(cfg)``: a
  hand-written kernel is opaque to the counter, and the wrappers refuse
  meta tensors. FLOPs do not depend on the mesh: each (arch, shape) is
  counted once. ``flop_terms`` gives the same count in closed form, term
  by term.
* ``state_bytes_per_device``: the bytes one device holds of the weights,
  plus for training the gradients, the two AdamW moments and the step
  count (shards under ``fsdp=True``, as the reference trains) and with
  ``--compression`` one float32 error-feedback residual (the port keeps it
  per rank, so the reference's ``(n_dp, ...)`` axis has no counterpart),
  and for serving the caches; all from the local shard shapes of the
  ``sharding.rules`` placements.
* ``flops_per_device``, ``bytes_accessed`` and ``peak_mem_per_device``:
  ``launch.costs.DeviceCostMode`` over one step as one device runs it
  (``device_cost``): the model of one tensor-parallel rank at the local
  batch, a training step with AdamW's update of the device's shards (the
  reference's compiled step includes it). ``bytes_accessed`` follows XLA's
  operand-plus-result convention op by op, unfused; the peak is the
  state the device holds before the step plus the most the step's own
  tensors hold at once. On a (1, 1) mesh ``flops_per_device`` is
  ``flops``.
* ``collectives`` and ``collective_bytes``: counts and bytes by kind of
  the collectives one device issues, from ``DeviceCostMode`` over each
  layer kind of the cell run once, sharded as the rules say on the cell's
  mesh, scaled by the layer counts (``collective_cost``); each op counts
  max(operand, result) bytes, the reference's rule, and
  ``collective_groups`` keeps them by process group, for pricing on the
  link the group spans (``launch.roofline``). Each layer kind runs
  Megatron-style: its module is built for one tensor-parallel rank
  (``tp_local_config``: the heads, FF width, experts and SSM heads the
  rank holds) and computes on plain local meta shards, with ``DTensor``
  redistributions where the rules put communication: the input of a
  column-parallel block is all-reduced in the backward, the output of a
  row-parallel block in the forward, a vocab-parallel embedding's lookup,
  and the vocab-parallel cross entropy's max, sum and gold logit;
  gradients of weights replicated over the data axes are all-reduced, and
  under FSDP weights are all-gathered for each use and their gradients
  reduce-scattered. Remat recompute re-issues what it recomputes.
* SKIPs with the reference's ``cell_supported`` reasons, and ``count_s``
  (the time of the FLOP count, the counterpart of compile time).
* A layer-pattern config (``configs.pattern``, port-only: Nemotron-H) is
  refused with a ``ValueError``: the accounting builds one super-block of
  ``layer_kinds`` and scales it by ``n_layers / block_period``, and its
  closed forms know no B/C groups, relu^2 experts or shared expert.

N/A, because there is no HLO: ``normalize_cost_analysis`` (it parses XLA
output), ``measure_cell``'s two-probe extrapolation (XLA counts a
``while`` body once; ``device_cost`` has its own, of two and three
super-blocks, exact), and ``--no-seq-shard`` / ``act_spec`` (a GSPMD
activation constraint). ``launch.roofline`` prices the per-device counts.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--json out.json]
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import logging
import math
import multiprocessing
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (
    ARCH_IDS,
    SHAPE_IDS,
    batch_specs,
    cell_supported,
    decode_specs,
    get_config,
    get_shape,
    meta_model,
)
from repro_torch.configs.base import ModelConfig, ShapeConfig, ShapeKind
from repro_torch.configs.pattern import option
from repro_torch.launch.costs import COLLECTIVES, DeviceCostMode, nbytes
from repro_torch.launch.mesh import (
    data_axes,
    fake_world,
    make_production_mesh,
    mesh_name,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models.mamba2 import mamba_forward
from repro_torch.models.moe import group_capacity, group_size
from repro_torch.models.transformer import (
    DecoderLayer,
    EncoderLayer,
    block_period,
    layer_kinds,
    train_paths,
)
from repro_torch.sharding.rules import (
    MeshAxes,
    axis_sizes,
    decode_state_leaves,
    decode_state_sharding,
    enforce_divisible,
    local_shape,
    logical_param_spec,
    param_shardings,
)
from repro_torch.train.optimizer import adamw, warmup_cosine
from repro_torch.train.remat import wrap_remat
from repro_torch.train.train_step import (
    TrainState,
    bound,
    grads_over_microbatches,
)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def refuse_pattern(cfg: ModelConfig) -> None:
    """Raise for a layer-pattern config, which the accounting would count
    wrong (the module docstring)."""
    if option(cfg, "layer_pattern"):
        raise ValueError(f"{cfg.name}: the dry run does not account a "
                         "layer-pattern config")


def cell_kind(shape: ShapeConfig) -> str:
    if shape.lowers_serve_step:
        return "serve"
    return "prefill" if shape.kind == ShapeKind.PREFILL else "train"


@dataclasses.dataclass
class DryRunResult:
    arch: str
    shape: str
    mesh: str
    kind: str
    ok: bool
    error: str = ""
    dtype: str = ""
    flops: float = 0.0
    flops_per_device: float = 0.0
    bytes_accessed: float = 0.0
    state_bytes_per_device: float = 0.0
    peak_mem_per_device: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_groups: list = dataclasses.field(default_factory=list)
    count_s: float = 0.0

    def row(self) -> str:
        if not self.ok:
            return (f"{self.arch:22s} {self.shape:12s} {self.mesh:10s} "
                    f"FAIL {self.error[:90]}")
        coll = " ".join(f"{k}={self.collectives.get(k, 0)}"
                        for k in COLLECTIVES)
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:10s} "
                f"flops={self.flops:.4e} "
                f"flops/dev={self.flops_per_device:.4e} "
                f"bytes/dev={self.bytes_accessed:.4e} "
                f"state/dev={self.state_bytes_per_device / 2**30:.2f}GiB "
                f"peak/dev={self.peak_mem_per_device / 2**30:.2f}GiB "
                f"{coll} coll_bytes/dev="
                f"{self.collective_bytes.get('total', 0):.4e} "
                f"count={self.count_s:.1f}s")


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def count_flops(cfg: ModelConfig, shape: ShapeConfig, *,
                remat: str = "minimal", microbatches: int = 1) -> int:
    """FlopCounterMode's count of one step of the cell on meta tensors:
    the training step's loss and backward, the prefill, or one decode
    step (its state built outside the count)."""
    model = meta_model(cfg, shape)
    kind = cell_kind(shape)
    paths = train_paths(cfg)
    if kind == "serve":
        state, tokens = decode_specs(cfg, shape, model)
        with FlopCounterMode(display=False) as fc:
            model.decode_step(state, tokens, kernels=paths)
        return fc.get_total_flops()
    batch = batch_specs(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            grads_over_microbatches(model, dict(model.named_parameters()),
                                    batch, microbatches=microbatches,
                                    remat=remat)
        else:
            model.prefill(batch["tokens"], max_seq=shape.seq_len,
                          positions=batch.get("positions"),
                          patch_embeds=batch.get("patch_embeds"),
                          encoder_frames=batch.get("encoder_frames"),
                          kernels=paths)
    return fc.get_total_flops()


def _causal_pairs(S: int, window: int | None,
                  block_q: int | None) -> tuple[int, int]:
    """(visible (query, key) pairs, pairs ``sdpa`` multiplies) of one
    sequence and head of causal self-attention: the dense form multiplies
    every S x S pair; the blocked form each query block by every key, or
    with a window by the window padded to a block plus the block."""
    if window is not None and window >= S:
        window = None
    visible = sum(min(q + 1, window or S) for q in range(S))
    if (block_q is None or S <= 2 * block_q or S % block_q
            or window is None):
        return visible, S * S
    pad = ((window - 1 + block_q - 1) // block_q) * block_q
    return visible, S * (pad + block_q)


def _ssd_flops(cfg: ModelConfig, B: int, S: int) -> int:
    """The chunked SSD's matrix products (``ssd_chunked``): C.B^T per chunk
    and head, its weights times x, each chunk's deposited state, and C
    times the state entering each chunk."""
    L = min(cfg.ssm_chunk, max(S, 1))
    nc = -(-S // L)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return 2 * B * nc * H * (L * L * N + L * L * P + L * P * N + L * P * N)


def flop_terms(cfg: ModelConfig, shape: ShapeConfig, *,
               remat: str = "minimal") -> dict:
    """``count_flops`` in closed form, term by term (they sum to it; the
    microbatches split the same work):

    * ``weights``: 2 x each weight matrix's elements x the tokens it
      multiplies (the encoder's and the cross K/V projections over the
      encoder's frames; an MoE's router over every token, its experts'
      matrices over the k routed tokens; the tied or untied head), 3x for
      a training step (forward, input and weight gradients);
    * ``attention``: 4 x H x D per visible (query, key) pair (QK^T and
      PV), 3x for training; a decode step reads every cache slot;
    * ``masked_pairs``: the same for the pairs ``sdpa`` multiplies and
      masks (the dense form's upper triangle, the blocked causal form's
      query block x all keys; not in a decode step, which has none);
    * ``moe_capacity``: the expert FF over every capacity slot of every
      expert (E x G x C rows) less the k routed tokens above, plus the
      dispatch and combine einsums (2 x T x E x C x d each; the dispatch
      backward takes one product, the dispatch tensor having no gradient,
      and a one-token group's dispatch is elementwise);
    * ``ssd_chunks``: the chunked SSD's products (3x for training), or in
      a decode step the state's read and the conv window's einsum;
    * ``remat_recompute``: the forward products the backward recomputes:
      the batched ones (attention, the expert FF, dispatch, SSD) under
      ``dots``; under ``minimal`` every layer's forward but each
      super-block's last product where nothing after it saves a tensor
      (non-reentrant checkpointing stops recomputing there).

    Lookups, norms, biases, convolutions and elementwise work count
    nothing in FlopCounterMode."""
    kind = cell_kind(shape)
    B, S = shape.global_batch, shape.seq_len
    Sq = 1 if kind == "serve" else S
    enc = cfg.encoder_seq if cfg.is_encoder_decoder else 0
    T, Te = B * Sq, B * enc
    d, hd, H = cfg.d_model, cfg.head_dim, cfg.n_heads
    kv = cfg.n_kv_heads * hd
    mult = 3 if kind == "train" else 1
    refuse_pattern(cfg)
    kinds = layer_kinds(cfg)
    layers = [kinds[i % len(kinds)] for i in range(cfg.n_layers)]

    attn_w = d * (H * hd + 2 * kv) + H * hd * d
    dense_w = 2 * d * cfg.d_ff if cfg.mlp_gelu else 3 * d * cfg.d_ff
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    mamba_w = d * (2 * di + 2 * n + h) + di * d
    moe_k = cfg.experts_per_token * 3 * d * cfg.expert_ff

    def layer_w(k) -> int:  # forward weight FLOPs of one layer
        f = 2 * T * (attn_w if k.mixer == "attn" else mamba_w)
        if k.cross_attn:
            f += 2 * T * (d * H * hd + H * hd * d) + 2 * Te * 2 * d * kv
        if k.ff == "dense":
            f += 2 * T * dense_w
        elif k.ff == "moe":
            f += 2 * T * (d * cfg.n_experts + moe_k)
        return f

    w = 2 * T * (d * cfg.vocab_size) + sum(map(layer_w, layers))  # + head
    enc_w = 2 * Te * (attn_w + dense_w) * (cfg.n_encoder_layers if enc else 0)
    if kind == "serve":
        enc_w = 0  # the cross K/V are in the state
        w -= sum(2 * Te * 2 * d * kv for k in layers if k.cross_attn)
    w += enc_w

    n_attn = sum(k.mixer == "attn" for k in layers)
    n_cross = sum(k.cross_attn for k in layers)
    per_pair = 4 * H * hd * B
    if kind == "serve":
        buf = S if cfg.sliding_window is None else min(S, cfg.sliding_window)
        vis, mult_pairs = n_attn * buf + n_cross * enc, 0
    else:
        v_self, m_self = _causal_pairs(S, cfg.sliding_window,
                                       cfg.attn_block_q)
        vis = (n_attn * v_self + n_cross * S * enc
               + (cfg.n_encoder_layers * enc * enc if enc else 0))
        mult_pairs = n_attn * (m_self - v_self)
    attn_fwd = per_pair * vis
    masked_fwd = per_pair * mult_pairs

    moe_fwd = routed = dispatch = 0
    n_moe = sum(k.ff == "moe" for k in layers)
    if n_moe:
        Sg = group_size(cfg, T)
        G, C = T // Sg, group_capacity(cfg, Sg)
        E = cfg.n_experts
        slots = 2 * E * G * C * 3 * d * cfg.expert_ff
        routed = n_moe * 2 * T * moe_k
        combine = n_moe * 2 * T * E * C * d
        # a one-token group's dispatch contracts nothing: einsum takes it
        # as an elementwise product
        dispatch = combine if Sg > 1 else 0
        moe_fwd = n_moe * slots - routed + combine + dispatch

    n_mamba = sum(k.mixer == "mamba" for k in layers)
    if kind == "serve":  # the state's read, and the conv window's einsum
        ssd_fwd = n_mamba * 2 * B * (h * cfg.ssm_head_dim * n
                                     + cfg.ssm_conv * (di + 2 * n))
    else:
        ssd_fwd = n_mamba * _ssd_flops(cfg, B, S)

    terms = {"weights": mult * w, "attention": mult * attn_fwd,
             "masked_pairs": mult * masked_fwd,
             # the dispatch tensor carries no gradient: its einsum's
             # backward takes one product, not two
             "moe_capacity": mult * moe_fwd - (dispatch if mult == 3 else 0),
             "ssd_chunks": mult * ssd_fwd, "remat_recompute": 0}
    if kind == "train":
        # the expert FF is a batched product: recomputed whole under dots
        batched = attn_fwd + masked_fwd + moe_fwd + routed + ssd_fwd
        enc_batched = (per_pair * cfg.n_encoder_layers * enc * enc
                       if enc else 0)
        if remat == "dots":
            # the encoder runs outside the remat'd super-blocks
            terms["remat_recompute"] = batched - enc_batched
        elif remat == "minimal":
            # everything but the head and the encoder, less each
            # super-block's last product, whose output the backward does
            # not need (non-reentrant checkpoint stops recomputing there;
            # after an MoE's combine the aux loss still needs recomputing)
            last = layers[block_period(cfg) - 1]
            tail = {"dense": 2 * T * d * cfg.d_ff, "moe": 0,
                    None: 2 * T * di * d}[last.ff]
            head = 2 * T * d * cfg.vocab_size
            terms["remat_recompute"] = (w - head - enc_w) + batched \
                - routed - enc_batched \
                - cfg.n_layers // block_period(cfg) * tail
    return terms


# ---------------------------------------------------------------------------
# State bytes
# ---------------------------------------------------------------------------


def _shard_bytes(mesh, spec, shape, dtype: torch.dtype) -> int:
    return math.prod(local_shape(mesh, spec, shape)) * dtype.itemsize


def _state_parts(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 compression: str = "none") -> dict[str, int]:
    """``state_bytes_per_device`` part by part: ``weights``, and for
    training ``grads``, ``moments`` (with AdamW's int32 step count) and
    ``ef`` (the compression residual), for serving ``caches``."""
    model = meta_model(cfg, shape)
    kind = cell_kind(shape)
    params = dict(model.named_parameters())
    if kind == "train":
        specs = param_shardings(mesh, model, fsdp=True)
        parts = collections.Counter(moments=4)  # AdamW's int32 step count
        for name, p in params.items():
            shp = tuple(p.shape)
            w = _shard_bytes(mesh, specs[name], shp, p.dtype)
            f32 = _shard_bytes(mesh, specs[name], shp, torch.float32)
            parts["weights"] += w
            parts["grads"] += w
            parts["moments"] += 2 * f32
            parts["ef"] += f32 if compression != "none" else 0
        return dict(parts)
    specs = param_shardings(mesh, model)
    parts = {"weights": sum(_shard_bytes(mesh, specs[n], tuple(p.shape),
                                         p.dtype)
                            for n, p in params.items()), "caches": 0}
    B, S = shape.global_batch, shape.seq_len
    if kind == "serve":
        state, _ = decode_specs(cfg, shape, model)
    else:  # the caches prefill materialises, bfloat16 as it makes them
        frames = (torch.empty((B, cfg.encoder_seq, cfg.d_model),
                              dtype=getattr(torch, cfg.dtype), device="meta")
                  if cfg.is_encoder_decoder else None)
        state = model.init_decode_state(B, S, encoder_frames=frames,
                                        cache_dtype=torch.bfloat16,
                                        kernels=train_paths(cfg))
    leaves = decode_state_leaves(state)
    for name, spec in decode_state_sharding(mesh, state).items():
        t = leaves[name]
        parts["caches"] += _shard_bytes(mesh, spec, tuple(t.shape), t.dtype)
    return parts


def state_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                           compression: str = "none") -> int:
    """Bytes one device of ``mesh`` holds of the cell's state (module
    docstring); ``mesh``: a ``DeviceMesh`` or {axis name: size}."""
    return sum(_state_parts(cfg, shape, mesh,
                            compression=compression).values())


# ---------------------------------------------------------------------------
# One device's step: FLOPs, bytes accessed, peak memory
# ---------------------------------------------------------------------------


# the parts of the state that the step itself creates: a training step its
# gradients, a prefill the caches
_MADE_BY_STEP = {"train": ("grads",), "prefill": ("caches",), "serve": ()}


def step_optimizer():
    """The AdamW of the reference's dry run (its schedule too)."""
    return adamw(warmup_cosine(3e-4, 2000, 100000))


def _as_shard(g: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """A gradient as the shard the update takes: itself where the shapes
    agree, else a view of its first elements (the reduce-scatter's result,
    whose bytes are the collective's) or, where the rank's gradient is the
    smaller, a new tensor of the shard's shape."""
    if tuple(g.shape) == shape:
        return g
    n = math.prod(shape)
    if g.is_contiguous() and g.numel() >= n:
        return g.view(-1)[:n].view(shape)
    return g.new_empty(shape)


def device_step(model, kind: str, batch: dict, *, state=None, opt=None,
                remat: str = "minimal", microbatches: int = 1,
                between=None) -> dict | None:
    """One step of a cell as one device runs it: ``kind`` "serve" a decode
    step of ``state`` (a ``DecodeState``), "prefill" the prefill of
    ``batch``, "train" the loss's gradients by the model's own weights
    (remat, microbatches) and ``opt``'s update of ``state`` (a
    ``TrainState`` of the shards the device holds; a gradient is cut to
    its shard's shape), calling ``between()`` (if given) between the two,
    and returning the gradients the update took. ``device_cost`` counts it
    on meta tensors, ``chip_smoke.py`` on the card."""
    paths = train_paths(model.cfg)
    if kind == "serve":
        model.decode_step(state, batch["tokens"], kernels=paths)
    elif kind == "prefill":
        model.prefill(batch["tokens"], max_seq=batch["tokens"].shape[1],
                      positions=batch.get("positions"),
                      patch_embeds=batch.get("patch_embeds"),
                      encoder_frames=batch.get("encoder_frames"),
                      kernels=paths)
    else:
        grads, _ = grads_over_microbatches(
            model, dict(model.named_parameters()), batch,
            microbatches=microbatches, remat=remat)
        grads = {k: _as_shard(g, tuple(state.params[k].shape))
                 for k, g in grads.items()}
        if between is not None:
            between()
        opt.update(grads, state.opt, state.params)
        return grads
    return None


def _local_batch(shape: ShapeConfig, mesh) -> int:
    """The sequences one device takes: the global batch over the data
    axes where they divide it, else all of it."""
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in sizes if a != "model")
    B = shape.global_batch
    return B // dp if B % dp == 0 else B


def _step_cost(cfg: ModelConfig, lcfg: ModelConfig, shape: ShapeConfig,
               local: ShapeConfig, mesh, *, remat: str, microbatches: int
               ) -> tuple[DeviceCostMode, int]:
    """``DeviceCostMode`` over one step of ``lcfg`` (one rank's model) at
    the local shape, and the bytes the step holds that neither the mode
    nor the resident state counts: its inputs, the model's buffers and,
    for training, the weights the step computes with beyond the shards
    the device keeps (under FSDP the gathered weights, all of them alive
    for the step, as the gradients the mode counts are). A training step
    updates the shards of ``cfg``'s weights that the rules give one
    device of ``mesh``."""
    kind = cell_kind(shape)
    model = meta_model(lcfg, local)
    state = opt = None
    gathered = 0
    if kind == "serve":
        state, tokens = decode_specs(lcfg, local, model)
        batch = {"tokens": tokens}
    else:
        batch = batch_specs(lcfg, local)
    if kind == "prefill":
        del batch["labels"]
    if kind == "train":
        glob = meta_model(dataclasses.replace(
            cfg, n_layers=lcfg.n_layers,
            n_encoder_layers=lcfg.n_encoder_layers), shape)
        specs = param_shardings(mesh, glob, fsdp=True)
        full = dict(glob.named_parameters())
        params = {}
        for name, p in model.named_parameters():
            shp = local_shape(mesh, specs[name], tuple(full[name].shape))
            params[name] = (p if tuple(p.shape) == shp else
                            torch.empty(shp, dtype=p.dtype, device="meta"))
            gathered += max(nbytes(p) - nbytes(params[name]), 0)
        opt = step_optimizer()
        state = TrainState(params, opt.init(params), None)
    with DeviceCostMode() as cost:
        device_step(model, kind, batch, state=state, opt=opt, remat=remat,
                    microbatches=microbatches, between=cost.mark)
        cost.mark()
    return cost, gathered + sum(map(nbytes, [*batch.values(),
                                             *model.buffers()]))


def device_cost(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                remat: str = "minimal", microbatches: int = 1,
                compression: str = "none") -> dict:
    """What one step of the cell costs one device of ``mesh``, counted by
    ``DeviceCostMode`` on meta tensors: the model of one tensor-parallel
    rank (``tp_local_config``) at the local batch, training with AdamW's
    update of the device's shards. Returns ``flops_per_device``,
    ``bytes_accessed`` and ``peak_mem_per_device``: the state the device
    holds before the step (``state_bytes_per_device`` less what the step
    makes: a training step's gradients, a prefill's caches), the step's
    inputs, the model's buffers and under FSDP the gathered weights less
    their shards (every weight gathered for the whole step: the step's
    gradients are counted at the rank's full size too), plus the step's
    ``peak_live_bytes``.

    Every super-block (whisper: with one encoder layer each) runs the same
    ops, so past three super-blocks the step is counted at two and at
    three and extended linearly to the model's depth: the FLOPs, bytes and
    gathered weights are sums over ops or layers, and each phase's peak (a
    training step's backward, then its update) grows by what one more
    super-block keeps alive; the peak is the larger phase's. ``tests/test_torch_roofline.py`` holds
    this to the whole step, and ``chip_smoke.py`` the whole step on the
    card to it."""
    refuse_pattern(cfg)
    kind = cell_kind(shape)
    lcfg = tp_local_config(cfg, axis_sizes(mesh)["model"])
    local = dataclasses.replace(shape, global_batch=_local_batch(shape, mesh))
    period = block_period(cfg)
    units = cfg.n_layers // period
    enc, rem = divmod(cfg.n_encoder_layers, units)
    if rem:
        raise ValueError(f"{cfg.name}: {cfg.n_encoder_layers} encoder "
                         f"layers do not spread over {units} super-blocks")
    counts = []
    for u in (2, 3) if units > 3 else (units,):
        cost, held = _step_cost(
            cfg, dataclasses.replace(lcfg, n_layers=u * period,
                                     n_encoder_layers=u * enc),
            shape, local, mesh, remat=remat, microbatches=microbatches)
        counts.append((u, (cost.flops, cost.bytes_accessed, held,
                            *cost.phase_peaks)))
    (_, first), (u, last) = counts[0], counts[-1]
    flops, moved, held, *peaks = (b + (units - u) * (b - a)
                                  for a, b in zip(first, last))
    parts = _state_parts(cfg, shape, mesh, compression=compression)
    resident = sum(v for k, v in parts.items()
                   if k not in _MADE_BY_STEP[kind])
    return {"flops_per_device": flops, "bytes_accessed": moved,
            "peak_mem_per_device": resident + held + max(peaks)}


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _LocalConfig(ModelConfig):
    """A config as one tensor-parallel rank holds it: ``local_d_inner``
    overrides the SSM width ``ssm_expand x d_model``."""

    local_d_inner: int = 0

    @property
    def d_inner(self) -> int:
        return self.local_d_inner or self.ssm_expand * self.d_model


def _split(n: int, tp: int) -> int:
    """What one of ``tp`` ranks holds of n heads / experts / channels: n/tp
    where tp divides it, else all of it (the rules replicate it)."""
    return n // tp if n % tp == 0 else n


def tp_local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """``cfg`` for one of ``tp`` tensor-parallel ranks: n_heads / tp query
    heads (at least one, the Megatron layout; kv heads likewise, repeated
    where tp exceeds them), d_ff / tp, n_experts / tp experts (top-k
    capped at them) and ssm_heads / tp SSM heads."""
    heads = max(cfg.n_heads // tp, 1)
    kv = max(cfg.n_kv_heads // tp, 1)
    experts = _split(cfg.n_experts, tp) if cfg.n_experts else 0
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(
        n_heads=heads, n_kv_heads=kv if heads % kv == 0 else 1,
        head_dim=cfg.head_dim, d_ff=_split(cfg.d_ff, tp),
        n_experts=experts,
        experts_per_token=min(cfg.experts_per_token, experts))
    return _LocalConfig(**fields,
                        local_d_inner=_split(cfg.ssm_heads, tp)
                        * cfg.ssm_head_dim if cfg.ssm_state else 0)


def _placements_for(mesh, dims: dict) -> list:
    """Placements of a local tensor: ``dims`` maps an axis name to a
    placement (default Replicate)."""
    from torch.distributed.tensor import Replicate
    return [dims.get(n, Replicate()) for n in mesh.mesh_dim_names]


class _Comm:
    """The DTensor redistributions one layer kind issues on ``mesh`` (see
    the module docstring); each returns plain local tensors."""

    def __init__(self, mesh):
        from torch.distributed.tensor import Shard
        self.mesh = mesh
        self.batch = {a: Shard(0) for a in data_axes(mesh)}

    def _reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """All-reduce of a local tensor over ``model`` (a Partial DTensor
        made Replicate), without autograd."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        pl = _placements_for(self.mesh, dict(self.batch,
                                             model=Partial(op)))
        d = DTensor.from_local(t.detach(), self.mesh, pl, run_check=False)
        out = d.redistribute(self.mesh, _placements_for(
            self.mesh, dict(self.batch, model=Replicate())))
        return out.to_local()

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: identity forward, all-reduce of the gradient."""
        return _CopyIn.apply(x, self)

    def reduce_out(self, y: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Megatron's g: all-reduce forward, identity backward."""
        return _ReduceOut.apply(y, self, op)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._reduce(g), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, comm, op):
        return comm._reduce(y, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Weights:
    """A layer's local weights as DTensors placed by the rules on the data
    axes, bound into its module for each use: under FSDP a use
    all-gathers the shard, and a gradient comes back reduce-scattered;
    otherwise the gradient of a weight replicated over the data axes is
    all-reduced by ``sync``."""

    def __init__(self, module: torch.nn.Module, mesh, fsdp: bool,
                 train: bool):
        from torch.distributed.tensor import DTensor, Shard
        self.mesh = mesh
        m = MeshAxes.for_mesh(mesh, fsdp=fsdp)
        n_fsdp = axis_sizes(mesh)[m.fsdp] if m.fsdp else 1
        self.dt = {}
        for name, p in module.named_parameters():
            spec = logical_param_spec(name.rsplit(".", 1)[-1], p.ndim, m)
            local, dims = torch.empty(p.shape, dtype=p.dtype,
                                      device="meta"), {}
            if m.fsdp and m.fsdp in spec:
                i = spec.index(m.fsdp)
                if p.shape[i] % n_fsdp == 0:  # else replicated, as the rules
                    dims = {m.fsdp: Shard(i)}
                    local = local.narrow(i, 0, p.shape[i] // n_fsdp)
            self.dt[name] = DTensor.from_local(
                local, mesh, _placements_for(mesh, dims),
                run_check=False).requires_grad_(train)

    def gathered(self) -> dict:
        """{name: the local weight this use computes with}."""
        from torch.distributed.tensor import Partial, Replicate
        out = {}
        for name, d in self.dt.items():
            full = d.redistribute(self.mesh, _placements_for(
                self.mesh, {}))
            grad = _placements_for(self.mesh, {a: Partial() for a in
                                               data_axes(self.mesh)})
            grad = [g if n != "model" else Replicate()
                    for g, n in zip(grad, self.mesh.mesh_dim_names)]
            out[name] = full.to_local(grad_placements=grad)
        return out

    def sync(self) -> None:
        """Reduce each weight's gradient to the weight's own placements."""
        for d in self.dt.values():
            if d.grad is not None:
                d.grad.redistribute(self.mesh, d.placements)


def _superblock_fn(layers, lcfg, comm: _Comm, kernels, positions, memory):
    """One super-block of sub-layers on local shards, as
    ``DecoderLayer.forward`` computes each, with the Megatron f / g around
    each parallel block (remat applies to the whole, as in the model)."""

    def fn(x):
        for layer in layers:
            kind = layer.kind
            h = comm.copy_in(layer.norm1(x, kernels))
            if kind.mixer == "attn":
                y, _, _ = attn_mod.attention(layer.attn, lcfg, h, positions,
                                             kernels)
            else:
                y, _ = mamba_forward(layer.mamba, lcfg, h, kernels=kernels)
            x = x + comm.reduce_out(y)
            if kind.cross_attn:
                mkv = attn_mod.memory_kv(layer.cross, lcfg,
                                         comm.copy_in(memory))
                h = comm.copy_in(layer.norm_x(x, kernels))
                x = x + comm.reduce_out(attn_mod.cross_attention(
                    layer.cross, lcfg, h, mkv, kernels))
            if kind.ff == "dense":
                x = x + comm.reduce_out(layer.ff(comm.copy_in(
                    layer.norm2(x, kernels))))
            elif kind.ff == "moe":
                y, _ = layer.moe(comm.copy_in(layer.norm2(x, kernels)),
                                 kernels)
                x = x + comm.reduce_out(y)
        return x
    return fn


def _encoder_fn(layer, lcfg, comm: _Comm, kernels):
    def fn(x):
        B, S, _ = x.shape
        h = comm.copy_in(layer.norm1(x, kernels))
        q, k, v = attn_mod._project_qkv(layer.attn, lcfg, h)
        y = kernels.flash_attention(q, k, v, causal=False)
        x = x + comm.reduce_out(y.reshape(B, S, -1) @ layer.attn.wo)
        return x + comm.reduce_out(layer.ff(comm.copy_in(
            layer.norm2(x, kernels))))
    return fn


class _EmbedHead(torch.nn.Module):
    """The vocab-parallel embedding and head of one rank."""

    def __init__(self, cfg: ModelConfig, vocab: int, dtype: torch.dtype):
        super().__init__()
        meta = dict(device="meta", dtype=dtype)
        self.embed = torch.nn.Parameter(torch.empty((vocab, cfg.d_model),
                                                    **meta))
        if not cfg.tie_embeddings:
            self.lm_head = torch.nn.Parameter(torch.empty(
                (cfg.d_model, vocab), **meta))
        self.tied = cfg.tie_embeddings


def _embed_head_fn(mod: _EmbedHead, comm: _Comm, sharded: bool,
                   train: bool):
    def fn(tokens, x_out):
        """``x_out`` stands for the layers' output, which the embedding
        feeds through the residual stream."""
        x = torch.nn.functional.embedding(tokens, mod.embed)
        if sharded:  # each rank looks up its vocab slice, zeros elsewhere
            x = comm.reduce_out(x)
        head = mod.embed.T if mod.tied else mod.lm_head
        logits = comm.copy_in(x + x_out) @ head
        if not train:
            return x, logits
        lf = logits.float()
        if sharded:  # vocab-parallel cross entropy
            m = comm.reduce_out(lf.amax(-1, keepdim=True).detach(), "max")
            z = comm.reduce_out(torch.exp(lf - m).sum(-1, keepdim=True))
            gold = comm.reduce_out(lf[..., :1])
            loss = (torch.log(z) + m - gold).mean()
        else:
            loss = torch.logsumexp(lf, -1).mean()
        return x, loss
    return fn


def collective_cost(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                    remat: str = "minimal", microbatches: int = 1) -> dict:
    """The collectives one device issues for one step of the cell on
    ``mesh`` (the module docstring), from ``DeviceCostMode``: one
    super-block counted and scaled by the super-blocks, whisper's encoder
    layer by its layers, then the embedding and head. Returns ``counts``
    and ``bytes`` by kind (``bytes`` with its ``total``) and ``groups``:
    one {kind, size, span (the group's lowest and highest rank), bytes}
    per kind and process group."""
    refuse_pattern(cfg)
    kind = cell_kind(shape)
    train = kind == "train"
    tp = axis_sizes(mesh)["model"]
    lcfg = tp_local_config(cfg, tp)
    dtype = getattr(torch, cfg.dtype)
    b = _local_batch(shape, mesh)
    if train:
        b = max(b // microbatches, 1)
    S = 1 if kind == "serve" else shape.seq_len
    kernels = train_paths(lcfg)
    comm = _Comm(mesh)
    meta = dict(device="meta", dtype=dtype)
    reps = microbatches if train else 1
    counts, moved, groups = (collections.Counter() for _ in range(3))

    def run(times, module, fn, *inputs, remat_fn: bool = True):
        weights = _Weights(module, mesh, fsdp=train, train=train)
        cost = DeviceCostMode()
        ctx = torch.enable_grad() if train else torch.no_grad()
        with ctx, cost:
            for _ in range(reps):
                with bound(module, weights.gathered()):
                    f = wrap_remat(fn, remat) if train and remat_fn else fn
                    ins = [t.requires_grad_(train) if t.is_floating_point()
                           else t for t in inputs]
                    out = f(*ins)
                    if train:
                        loss = (out[1] if isinstance(out, tuple)
                                else out.float().sum())
                        loss.backward()
            if train:
                weights.sync()
        for total, got in ((counts, cost.collective_counts),
                           (moved, cost.collective_bytes),
                           (groups, cost.collective_groups)):
            for k, v in got.items():
                total[k] += times * v

    period = block_period(cfg)
    x = torch.empty((b, S, cfg.d_model), **meta)
    pos = torch.arange(S, device="meta").expand(b, S)
    if cfg.mrope:
        pos = pos.expand(3, b, S)
    enc = cfg.encoder_seq if cfg.is_encoder_decoder else 0
    memory = torch.empty((b, enc, cfg.d_model), **meta) if enc else None
    block = torch.nn.ModuleList(
        DecoderLayer(lcfg, k, device="meta", dtype=dtype, generator=None)
        for k in layer_kinds(cfg))
    run(cfg.n_layers // period, block,
        _superblock_fn(block, lcfg, comm, kernels, pos, memory), x)
    if enc and kind != "serve":  # the encoder runs outside remat
        layer = EncoderLayer(lcfg, device="meta", dtype=dtype,
                             generator=None)
        run(cfg.n_encoder_layers, layer,
            _encoder_fn(layer, lcfg, comm, kernels),
            torch.empty((b, enc, cfg.d_model), **meta), remat_fn=False)
    sharded = cfg.vocab_size % tp == 0
    mod = _EmbedHead(cfg, cfg.vocab_size // tp if sharded
                     else cfg.vocab_size, dtype)
    tokens = torch.zeros((b, S), dtype=torch.int64, device="meta")
    run(1, mod, _embed_head_fn(mod, comm, sharded and tp > 1, train),
        tokens, x, remat_fn=False)

    def by_kind(c: collections.Counter) -> dict:
        return {k: c.get(k, 0) for k in COLLECTIVES} | {
            k: v for k, v in c.items() if k not in COLLECTIVES}

    return {"counts": by_kind(counts),
            "bytes": by_kind(moved) | {"total": sum(moved.values())},
            "groups": [{"kind": k, "size": n, "span": [lo, hi], "bytes": v}
                       for (k, n, lo, hi), v in sorted(groups.items())]}


# ---------------------------------------------------------------------------
# One cell, the matrix
# ---------------------------------------------------------------------------


def lower_cell(arch: str, shape_id: str, mesh, *, remat: str = "minimal",
               microbatches: int = 1, compression: str = "none",
               counted: tuple[float, float] | None = None) -> DryRunResult:
    """Account one (arch x shape) cell on ``mesh`` (a ``DeviceMesh`` over
    the initialized, usually fake, process group). ``counted``: (FLOPs,
    seconds) of the same (arch, shape) counted earlier, reused (the count
    does not depend on the mesh)."""
    cfg = get_config(arch)
    refuse_pattern(cfg)
    shape = get_shape(shape_id)
    kind = cell_kind(shape)
    res = DryRunResult(arch=arch, shape=shape_id, mesh=mesh_name(mesh),
                       kind=kind, ok=False, dtype=cfg.dtype)
    ok, why = cell_supported(cfg, shape)
    if not ok:
        res.error = "SKIP: " + why
        return res
    t0 = time.time()
    try:
        if counted is None:
            res.flops = float(count_flops(cfg, shape, remat=remat,
                                          microbatches=microbatches))
            res.count_s = time.time() - t0
        else:
            res.flops, res.count_s = counted
        res.state_bytes_per_device = float(state_bytes_per_device(
            cfg, shape, mesh, compression=compression))
        per_step = dict(remat=remat, microbatches=microbatches)
        coll = collective_cost(cfg, shape, mesh, **per_step)
        res.collectives = coll["counts"]
        res.collective_bytes = coll["bytes"]
        res.collective_groups = coll["groups"]
        cost = device_cost(cfg, shape, mesh, compression=compression,
                           **per_step)
        res.flops_per_device = float(cost["flops_per_device"])
        res.bytes_accessed = float(cost["bytes_accessed"])
        res.peak_mem_per_device = float(cost["peak_mem_per_device"])
        res.ok = True
    except Exception as e:  # noqa: BLE001 — report, don't crash the matrix
        res.error = f"{type(e).__name__}: {e}"
        res.count_s = time.time() - t0
    return res


def _meshes(multi_pod: bool, both: bool) -> list[bool]:
    return [False, True] if both else [multi_pod]


def run_pair(arch: str, shape_id: str, multi_pods: list[bool], opts: dict
             ) -> list[DryRunResult]:
    """Every mesh's cell of one (arch, shape), FLOPs counted once; each
    mesh in its own fake world."""
    # DTensor warns of each reduction over (pod, data) taken as two
    _quiet_dtensor()
    out, counted = [], None
    for multi in multi_pods:
        n = 512 if multi else 256
        with fake_world(n):
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            r = lower_cell(arch, shape_id, mesh, counted=counted, **opts)
        if r.ok:
            counted = (r.flops, r.count_s)
        out.append(r)
    return out


def _quiet_dtensor() -> None:
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def _run_pair_star(args):
    return run_pair(*args)


def run_matrix(archs, shapes, multi_pods: list[bool], opts: dict, *,
               workers: int = 1, on_result=None) -> list[DryRunResult]:
    """All cells, ordered mesh by mesh as the reference prints them; with
    ``workers`` > 1 the (arch, shape) pairs run in a spawned process pool
    (each process its own fake world)."""
    pairs = [(a, s, multi_pods, opts) for a in archs for s in shapes]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=ctx) as pool:
            per_pair = list(pool.map(_run_pair_star, pairs))
    else:
        per_pair = [run_pair(*p) for p in pairs]
    results = [r for i in range(len(multi_pods)) for rs in per_pair
               for r in rs[i:i + 1]]
    if on_result:
        for r in results:
            on_result(r)
    return results


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="minimal")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none")
    ap.add_argument("--json", default=None)
    ap.add_argument("--workers", type=int, default=1,
                    help="processes over the (arch, shape) pairs")
    args = ap.parse_args(argv)
    if not (args.all or args.arch):
        ap.error("pass --arch/--shape or --all")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPE_IDS)
    opts = dict(remat=args.remat, microbatches=args.microbatches,
                compression=args.compression)
    results = run_matrix(archs, shapes,
                         _meshes(args.multi_pod, args.both_meshes), opts,
                         workers=args.workers,
                         on_result=lambda r: print(r.row(), flush=True))
    rows = [dataclasses.asdict(r) for r in results]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    n_fail = sum(1 for r in rows
                 if not r["ok"] and not r["error"].startswith("SKIP"))
    print(f"\n{len(rows)} cells, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
