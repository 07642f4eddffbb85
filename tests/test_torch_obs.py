"""The port's spans (``repro_torch.obs``): off, a span touches no profiler
function; on, under a CPU profiler, a served prefill, a decode step and a
training step export the spans of their layer kinds, nested as
``obs``'s docstring lists them: an MoE layer's ``moe.route``,
``moe.experts`` and (nemotron's shared expert) ``moe.shared`` inside its
``moe``, and a pattern layer of nemotron's one span of its kind."""

import json
from collections import Counter

import pytest
import torch
import torch.autograd.profiler
import torch.profiler

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.pattern import option
from repro_torch.models.transformer import Transformer, layer_kinds
from repro_torch.serve import ServeEngine
from repro_torch.train import adamw, init_train_state, make_train_step

DANUBE, JAMBA = "h2o-danube-1.8b", "jamba-v0.1-52b"
NEMOTRON = "nemotron-3-nano-30b-a3b"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def spans_off():
    obs.enable(False)
    yield
    obs.enable(False)


def _engine(arch: str) -> ServeEngine:
    torch.manual_seed(0)
    cfg = get_config(arch, smoke=True)
    return ServeEngine(cfg, Transformer(cfg, device=CPU), max_seq=32,
                       device=CPU)


def _tokens(cfg, batch: int = 2, seq: int = 12) -> torch.Tensor:
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=g)


def _prefill(arch: str):
    eng = _engine(arch)
    toks = _tokens(eng.cfg)
    return lambda: eng.prefill_batch(toks)


def _decode(arch: str):
    eng = _engine(arch)
    logits, state = eng.prefill_batch(_tokens(eng.cfg))
    tok = logits.argmax(-1, keepdim=True)
    return lambda: eng.serve_step(state, tok)


def _train(arch: str):
    torch.manual_seed(0)
    cfg = get_config(arch, smoke=True)
    model = Transformer(cfg, device=CPU)
    opt = adamw(1e-3)
    state = init_train_state(dict(model.named_parameters()), opt)
    step = make_train_step(model, opt, remat="dots")
    toks = _tokens(cfg, seq=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return lambda: step(state, batch)


def _served_kinds(arch: str) -> Counter:
    """Spans a served pass gives per layer: the mixer and the FF, each
    where the layer has one."""
    cfg = get_config(arch, smoke=True)
    kinds = layer_kinds(cfg)
    want = Counter()
    for i in range(cfg.n_layers):
        k = kinds[i % len(kinds)]
        if k.mixer is not None:
            want[k.mixer] += 1
        if k.ff is not None:
            want["moe" if k.ff == "moe" else "ff"] += 1
    return want


def test_off_is_one_null_context_and_calls_no_profiler(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a span called the profiler while off")

    for mod in (obs, torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", boom)
    assert obs.span("decode") is obs.span("attn")
    _decode(JAMBA)()
    _train(DANUBE)()


def test_on_returns_a_profiler_range():
    obs.enable(True)
    assert isinstance(obs.span("decode"), torch.profiler.record_function)
    obs.enable(False)
    assert not isinstance(obs.span("decode"), torch.profiler.record_function)


def _spans_of(fn, tmp_path) -> list[tuple[str, str | None]]:
    """(name, innermost enclosing span's name) of every ``gs.`` range the
    CPU profiler exports over one call of ``fn``."""
    obs.enable(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    obs.enable(False)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["ts"], -e["dur"], e["name"][3:]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("gs.")))
    out, stack = [], []
    for ts, neg, name in spans:
        while stack and stack[-1][0] <= ts:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((ts - neg, name))
    return out


def _served(top: str, arch: str) -> Counter:
    want = Counter({(top, None): 1, ("head", top): 1})
    for kind, n in _served_kinds(arch).items():
        want[(kind, top)] = n
    n_moe = want[("moe", top)]
    parts = ["moe.route", "moe.experts"]
    if option(get_config(arch, smoke=True), "shared_expert_ff"):
        parts.append("moe.shared")
    for part in parts if n_moe else []:
        want[(part, "moe")] = n_moe
    return want


CASES = {
    "danube-prefill": (_prefill, DANUBE, lambda: _served("prefill", DANUBE)),
    "jamba-prefill": (_prefill, JAMBA, lambda: _served("prefill", JAMBA)),
    "jamba-decode": (_decode, JAMBA, lambda: _served("decode", JAMBA)),
    "danube-decode": (_decode, DANUBE, lambda: _served("decode", DANUBE)),
    "nemotron-prefill": (_prefill, NEMOTRON,
                         lambda: _served("prefill", NEMOTRON)),
    "nemotron-decode": (_decode, NEMOTRON,
                        lambda: _served("decode", NEMOTRON)),
    "danube-train": (_train, DANUBE, lambda: Counter(
        {("train.forward", None): 1, ("train.backward", None): 1,
         ("train.optimizer", None): 1})),
}


@pytest.mark.parametrize("case", list(CASES))
def test_on_exports_the_spans_nested(case, tmp_path):
    make, arch, want = CASES[case]
    fn = make(arch)
    assert Counter(_spans_of(fn, tmp_path)) == want()


def test_layer_kinds_give_the_counts():
    """The expected counts above are the configurations' own layer kinds:
    jamba's smoke stack holds both mixers and both FFs."""
    assert _served_kinds(JAMBA) == Counter(
        {"mamba": 7, "attn": 1, "ff": 4, "moe": 4})
    assert _served_kinds(DANUBE) == Counter({"attn": 2, "ff": 2})
    # MEM*EME: one span a layer, of its kind
    assert _served_kinds(NEMOTRON) == Counter(
        {"mamba": 3, "moe": 3, "attn": 1})
