"""Named spans of the program on the profiler's clock, off by default.

``span(name)`` marks a stretch of host work. Off, it returns one shared
null context and costs a flag check. On (``enable(True)``), it returns a
``torch.profiler.record_function`` range ``gs.<name>``: under a running
``torch.profiler.profile`` the range lands in the same trace as the
device's kernels, copies and CUDA runtime calls, on the same clock, so a
reader of the trace can give each launch and each host wait to the
innermost span open when the host issued it. Nesting gives each span its
parent; batches are static, so a step is the unit and no request id is
carried.

The spans, and where they are opened:

- ``prefill``, ``decode``: ``ServeEngine.prefill_batch``, ``serve_step``;
- per layer in ``Transformer.prefill`` and ``decode_step``: ``attn`` or
  ``mamba`` (norm1, the mixer and its cache write), ``ff`` or ``moe``
  (norm2 and the dense or MoE FF), then ``head`` (final norm, LM head);
  a layer of a pattern config (``configs.pattern``) is one block and
  opens exactly one of ``mamba``, ``attn`` or ``moe`` (its norm inside);
- inside ``moe`` (``models.moe.moe_forward``, wherever it runs):
  ``moe.route`` (router, top-k and the dispatch positions),
  ``moe.experts`` (the dispatch, the grouped matmuls and the combine),
  and ``moe.shared`` (the shared expert, where the config has one);
- ``train.forward`` (the loss), ``train.backward`` (the gradients, remat's
  recompute included): ``train_step.grads_over_microbatches``;
  ``train.optimizer`` (the update, clipping included): the step itself.

On CUDA, ``serve_step`` replays a captured graph of the decode step
(``serve.engine``). ``decode`` still opens on every step, but the
per-layer spans inside it (``attn``, ``mamba``, ``ff``, ``moe`` and its
``moe.*``, ``head``) open only while the step is captured: a replayed
step issues one ``cudaGraphLaunch`` and its kernels find no per-layer
span, so per-layer host time no longer splits a replayed step, and the
device operations a ``decode`` span counts are those of that one launch.
"""

from __future__ import annotations

import contextlib

from torch.profiler import record_function

_ON = False
_OFF = contextlib.nullcontext()


def enable(on: bool) -> None:
    """Turn the spans on or off for the whole process."""
    global _ON
    _ON = bool(on)


def span(name: str):
    """The context of span ``gs.<name>``: a profiler range when on, the
    shared null context when off."""
    return record_function("gs." + name) if _ON else _OFF
