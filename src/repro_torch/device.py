"""Device selection shared by every entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``. A request for a
CUDA device on a host without one raises: nothing falls back to the CPU
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev
