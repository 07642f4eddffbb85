"""Nemotron-3-Nano-30B-A3B on the port (``configs.pattern``), held against
the benchmark's plain reference of its family (``bench/families/
nemotron_h.py``) on the seed's weights, in float32 on the CPU: the smoke
stack ``MEM*EME`` (every block kind, two B/C groups, the sigmoid router
with its correction bias, relu^2 experts and the shared expert) served
through ``ServeEngine`` (prefill, then decode steps through the caches)
against the reference's full forward; the grouped gated norm, the
correction bias and the shared expert each move the logits far beyond
that agreement; the full configuration's parameter count on meta tensors;
and the reference registry's ``ARCH_IDS`` left as they are."""

import json
from pathlib import Path

import pytest
import torch

from bench.harness import port
from bench.harness.cell import load_family
from repro import configs as r_configs
from repro_torch import configs as t_configs
from repro_torch.configs.nemotron_3_nano_30b_a3b import FULL
from repro_torch.models import Transformer, count_params, mamba2
from repro_torch.serve import ServeEngine

CPU = torch.device("cpu")
ARCH = "nemotron-3-nano-30b-a3b"
DATA = Path(__file__).resolve().parents[1] / "bench" / "tests" / "data"
SEED = 7
# float32 on both sides: the port and the reference sum in other orders
# (the SSD scan's chunks, the conv, the matmuls), ~1e-6 of the largest
# logit apart on the CPU; 2e-4 of it leaves that room and stays far below
# what leaving out any published part moves (see test_each_part_moves...)
RTOL = 2e-4


def smoke(**model) -> dict:
    """The smoke configuration, with ``model`` keys changed (as cuts)."""
    cfg = json.loads((DATA / "configs" / "nemotron-smoke.json").read_text())
    for k, v in model.items():
        cfg["reduced"][k] = [cfg["model"][k], v]
        cfg["model"][k] = v
    return cfg


def serve(cfg: dict, B: int, S: int, new: int, patch=None):
    """(the port's logits (B, new, V) at the served positions, its tokens,
    the prompt); ``patch(model)`` edits the model's weights first."""
    pc, model = port.build_model(cfg, load_family(cfg), SEED, CPU)
    if patch is not None:
        with torch.no_grad():
            patch(model)
    eng = ServeEngine(pc, model, max_seq=S + new, device=CPU)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, pc.vocab_size, (B, S), generator=g)
    logits, state = eng.prefill_batch(prompt)
    outs, toks = [logits], [logits.argmax(-1, keepdim=True)]
    for _ in range(new - 1):
        logits, state = eng.serve_step(state, toks[-1])
        outs.append(logits)
        toks.append(logits.argmax(-1, keepdim=True))
    return torch.stack(outs, 1), torch.cat(toks, 1), prompt


def reference(cfg: dict, prompt, toks) -> torch.Tensor:
    fam = load_family(cfg)
    (ref,) = fam.served_logits(
        cfg, port.draw_fn(cfg, fam, SEED, CPU),
        [(torch.cat([prompt, toks[:, :-1]], 1), prompt.shape[1])])
    return ref


@pytest.fixture(scope="module")
def served():
    prog, toks, prompt = serve(smoke(), B=2, S=40, new=10)
    return prog, toks, prompt, reference(smoke(), prompt, toks)


def _gap(a, b) -> float:
    return (a - b).abs().max().item()


def test_serving_matches_the_reference(served):
    """The prefill's logits and 9 decode steps' through the KV ring, the
    grouped SSM states and conv tails, against the teacher-forced full
    forward."""
    prog, _, _, ref = served
    assert prog.shape == ref.shape == (2, 10, 256)
    assert _gap(prog, ref) < RTOL * ref.abs().max().item()


@pytest.mark.parametrize("factor", [0.5, 0.25])
def test_capacity_drops_match_the_reference(factor, monkeypatch):
    """Below FULL's capacity factor the prompt's groups drop (token,
    choice) assignments; the reference drops the same ones, at prefill and
    at each decode position."""
    from repro_torch.models import moe

    dropped = []
    real = moe.dispatch_positions

    def spy(ids, n_experts, capacity):
        onehot, pos, keep = real(ids, n_experts, capacity)
        dropped.append(int((~keep).sum()))
        return onehot, pos, keep
    monkeypatch.setattr(moe, "dispatch_positions", spy)
    cfg = smoke(moe_capacity_factor=factor)
    prog, toks, prompt = serve(cfg, B=4, S=32, new=9)
    assert sum(dropped[:3]) > 0  # the prefill's three MoE blocks
    ref = reference(cfg, prompt, toks)
    assert _gap(prog, ref) < RTOL * ref.abs().max().item()


def _drop_gated_groups(monkeypatch):
    """The gated norm over all of d_inner, as with one group."""
    def whole(kernels, y, z, p, cfg):
        return kernels.rmsnorm(y * torch.nn.functional.silu(z), p.norm_scale,
                               eps=cfg.norm_eps)
    monkeypatch.setattr(mamba2, "_gated_norm", whole)


def _zero(suffix: str):
    def patch(model):
        for name, p in model.named_parameters():
            if name.endswith(suffix):
                p.zero_()
    return patch


@pytest.mark.parametrize("part", ["grouped_gated_norm",
                                  "e_score_correction_bias", "shared_expert"])
def test_each_part_moves_the_logits(served, part, monkeypatch):
    """Leaving out a published part moves the served logits by far more
    than the port sits from the reference: the comparison above would
    catch its absence."""
    prog, _, _, ref = served
    patch = None
    if part == "grouped_gated_norm":
        _drop_gated_groups(monkeypatch)
    elif part == "e_score_correction_bias":
        patch = _zero("moe.e_score_correction_bias")
    else:
        patch = _zero("moe.shared.w_down")
    # teacher-forced on the same tokens, so the positions line up
    other, _, _ = serve(smoke(), B=2, S=40, new=1, patch=patch)
    assert _gap(other[:, 0], ref[:, 0]) > 100 * RTOL * ref.abs().max().item()
    assert _gap(prog[:, 0], ref[:, 0]) < RTOL * ref.abs().max().item()


def test_full_config_counts_its_published_parameters():
    """On meta tensors: 31,577,940,288 parameters, the published 31.6B,
    3.23B of them active a token without the input embedding."""
    model = Transformer(FULL, device="meta", dtype=torch.bfloat16)
    assert count_params(model) == FULL.param_count() == 31_577_940_288
    active = FULL.active_param_count() - FULL.vocab_size * FULL.d_model
    assert active == 3_227_754_816
    kinds = list(FULL.layer_pattern)
    assert (kinds.count("M"), kinds.count("E"), kinds.count("*")) == \
        (23, 23, 6)
    assert [i for i, k in enumerate(kinds) if k == "*"] == \
        [5, 12, 19, 26, 33, 42]
    assert FULL.d_inner == 4096 and FULL.ssm_heads == 64


def test_the_reference_registry_is_untouched():
    """The port holds the architecture beside its copy of the reference's
    registry: ``ARCH_IDS`` stay the reference's, ``get_config`` finds it."""
    assert t_configs.ARCH_IDS == r_configs.ARCH_IDS
    assert ARCH not in t_configs.ARCH_IDS
    assert t_configs.get_config(ARCH) is FULL
    with pytest.raises(KeyError):
        r_configs.get_config(ARCH)


def test_the_family_loss_is_the_ports():
    """``loss_fn`` of the family on the port's weights equals the port's
    training forward's cross-entropy (no auxiliary loss: the correction
    bias balances the load)."""
    from bench.reference.precision import Arith
    from repro_torch.models import loss_fn

    cfg = smoke()
    fam = load_family(cfg)
    _, model = port.build_model(cfg, fam, SEED, CPU)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, 256, (2, 17), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    got, parts = loss_fn(model, batch)
    assert float(parts["moe_aux"]) == 0.0
    p = {n: t.detach() for n, t in model.named_parameters()}
    want = fam.loss_fn(cfg, p, batch["tokens"], batch["labels"], Arith())
    assert abs(float(got.detach()) - float(want)) < 1e-5


@pytest.mark.parametrize("group", [4, 8, 32])
def test_the_grouped_norm_is_a_norm_a_group(group):
    """``rmsnorm_ref(..., group=)`` (the CPU side of the RMSNorm kernel's
    groups) normalises each run of ``group`` channels on its own, by its
    slice of the scale."""
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(group)
    x = torch.randn(3, 5, 32, generator=g)
    s = torch.randn(32, generator=g)
    want = torch.cat([ref.rmsnorm_ref(x[..., j:j + group], s[j:j + group])
                      for j in range(0, 32, group)], dim=-1)
    assert torch.equal(ref.rmsnorm_ref(x, s, group=group), want)



@pytest.mark.parametrize("entry", ["lower_cell", "flop_terms", "device_cost",
                                   "collective_cost"])
def test_the_dry_run_refuses_a_layer_pattern(entry):
    """The dry run scales one super-block of ``layer_kinds`` by ``n_layers
    / block_period``, and its closed forms know no B/C groups, relu^2
    experts or shared expert: it refuses a pattern config rather than
    count it wrong, at its entry point and in each accounting."""
    from repro_torch.configs import get_shape
    from repro_torch.launch import dryrun

    shape = get_shape("decode_32k")
    with pytest.raises(ValueError, match="layer-pattern"):
        if entry == "lower_cell":
            dryrun.lower_cell(ARCH, "decode_32k", None)
        elif entry == "flop_terms":
            dryrun.flop_terms(FULL, shape)
        else:
            getattr(dryrun, entry)(FULL, shape, None)
