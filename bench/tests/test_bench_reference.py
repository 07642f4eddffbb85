"""The plain references held against the port at smoke sizes: served
logits through prefill and decode (danube, and jamba with capacity
drops), the SSD scan against its token recurrence, MoE capacity against
a loop, and training steps against ``make_train_step``. The same
comparisons run on the card under the ``cuda`` marker."""

import json
from pathlib import Path

import pytest
import torch

from bench.harness import port
from bench.harness.cell import load_family
from bench.reference import lm
from bench.reference import train as ref_train

DATA = Path(__file__).resolve().parent / "data" / "configs"


def config(name: str, **model) -> dict:
    cfg = json.loads((DATA / f"{name}.json").read_text())
    for k, v in model.items():
        cfg["reduced"][k] = [cfg["model"][k], v]
        cfg["model"][k] = v
    return cfg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def served(cfg: dict, device, B=2, S=40, new=6, seed=7):
    """The port's logits (B, new, V) at the served positions, its tokens,
    and the prompt."""
    from repro_torch.serve import ServeEngine

    pc, model = port.build_model(cfg, load_family(cfg), seed, device)
    eng = ServeEngine(pc, model, max_seq=S + new, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, pc.vocab_size, (B, S), generator=g,
                           device=device)
    logits, st = eng.prefill_batch(prompt)
    outs, toks = [logits.float()], [logits.argmax(-1, keepdim=True)]
    for _ in range(new - 1):
        logits, st = eng.serve_step(st, toks[-1])
        outs.append(logits.float())
        toks.append(logits.argmax(-1, keepdim=True))
    return torch.stack(outs, 1), torch.cat(toks, 1), prompt


def reference(cfg, device, prompt, toks, seed=7, precision="float32"):
    fam = load_family(cfg)
    (ref,) = fam.served_logits(cfg, port.draw_fn(cfg, fam, seed, device),
                               [(torch.cat([prompt, toks[:, :-1]], 1),
                                 prompt.shape[1])], precision)
    return ref


CASES = [("danube-smoke", {}, 40), ("jamba-smoke", {}, 40),
         ("jamba-smoke", {"moe_capacity_factor": 1.25}, 64)]


def _served_matches(name, over, S, device):
    cfg = config(name, **over)
    prog, toks, prompt = served(cfg, device, S=S)
    ref = reference(cfg, device, prompt, toks)
    err = (prog - ref).abs().max().item()
    assert err < 2e-4 * ref.abs().max().item(), err


@pytest.mark.parametrize("name,over,S", CASES)
def test_served_logits_match_the_port(name, over, S):
    _served_matches(name, over, S, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name,over,S", CASES)
def test_served_logits_match_the_port_on_the_card(name, over, S, cuda_device):
    _served_matches(name, over, S, cuda_device)


def test_cache_dtype_is_read_past_the_prompt():
    """Queries past the prompt see keys rounded to the cache's dtype: the
    reference's decode positions move when the cache dtype does."""
    cfg = config("danube-smoke")
    prog, toks, prompt = served(cfg, torch.device("cpu"))
    ref = reference(cfg, torch.device("cpu"), prompt, toks)
    cfg32 = dict(cfg, cache_dtype="float32")
    ref32 = reference(cfg32, torch.device("cpu"), prompt, toks)
    assert torch.equal(ref[:, 0], ref32[:, 0])  # the prefill position
    assert (ref[:, 1:] - ref32[:, 1:]).abs().max() > 1e-5


def test_ssd_matches_the_token_recurrence():
    g = torch.Generator().manual_seed(0)
    B, L, H, P, N = 2, 150, 3, 4, 5
    x = torch.randn(B, L, H, P, generator=g)
    dt = torch.rand(B, L, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 2
    Bm, Cm = torch.randn(B, L, N, generator=g), torch.randn(B, L, N, generator=g)
    h = torch.zeros(B, H, P, N)
    want = []
    for t in range(L):
        h = h * torch.exp(dt[:, t] * A)[:, :, None, None] + (
            dt[:, t, :, None, None] * x[:, t, :, :, None] * Bm[:, t, None, None, :])
        want.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    torch.testing.assert_close(lm.ssd(x, dt, A, Bm, Cm), torch.stack(want, 1),
                               rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops_in_token_order():
    """Every token picks experts 0 and 1: the first C of a group keep
    both choices, the rest are dropped."""
    m = {"n_experts": 4, "experts_per_token": 2, "moe_group_size": 16,
         "moe_capacity_factor": 1.0}
    T, d = 32, 3
    x = torch.randn(T, d).abs() + 1
    router = torch.tensor([[5.0, 4.0, 0.0, -1.0]] * d)
    eye = torch.eye(d).expand(4, d, d).contiguous()
    w = {"moe.router": router, "moe.w_gate": eye * 10, "moe.w_up": eye,
         "moe.w_down": eye}
    Sg, C = lm.capacity_group(m, T)
    assert (Sg, C) == (16, 8)
    out = lm.moe_block(x, w, m, lm.Arith())
    kept = (out.abs().sum(-1) > 0).view(T // Sg, Sg)
    assert kept[:, :C].all() and not kept[:, C:].any()


def _train_matches(device):
    from repro_torch.train import adamw, init_train_state, make_train_step

    wl = json.loads((Path(__file__).resolve().parents[1] / "workloads"
                     / "danube-train.json").read_text())
    rec = wl["recipe"]
    cfg = config("danube-smoke")
    fam = load_family(cfg)
    pc, model = port.build_model(cfg, fam, 3, device)
    opt = adamw(rec["lr"], b1=rec["b1"], b2=rec["b2"], eps=rec["eps"],
                weight_decay=rec["weight_decay"],
                max_grad_norm=rec["max_grad_norm"])
    state = init_train_state(dict(model.named_parameters()), opt)
    step = make_train_step(model, opt, remat=rec["remat"])
    g = torch.Generator(device=device).manual_seed(2)
    data = []
    for _ in range(3):
        t = torch.randint(0, pc.vocab_size, (2, 17), generator=g, device=device)
        data.append((t[:, :-1], t[:, 1:]))
    losses = []
    for i, (tok, lab) in enumerate(data):
        state, met = step(state, {"tokens": tok, "labels": lab})
        losses.append(float(met["loss"]))
        if i == 0:
            grad = {k: float(v.norm() / (1 - rec["b1"]))
                    for k, v in state.opt.mu.items()}
    ref = ref_train.steps(cfg, fam, port.draw_fn(cfg, fam, 3, device), data,
                          rec)
    assert ref_train.loss_gap(losses, ref["loss"]) < 1e-5
    assert ref_train.worst_leaf_gap(grad, ref["grad"])[0] < 1e-4
    p0 = port.draw_fn(cfg, fam, 3, device)
    change = {}
    with torch.no_grad():
        for gname in ("embed", "layers.0", "layers.1", "head"):
            for n, t0 in p0(gname).items():
                change[n] = float((state.params[n] - t0).norm())
    assert ref_train.worst_leaf_gap(change, ref["change"])[0] < 1e-4


def test_training_steps_match_the_port():
    _train_matches(torch.device("cpu"))


@pytest.mark.cuda
def test_training_steps_match_the_port_on_the_card(cuda_device):
    _train_matches(cuda_device)
