"""Activation-checkpoint (remat) policies (port of
``src/repro/train/remat.py``). The policies live beside the model that
applies them, in ``repro_torch.models.remat``; this module names them
where the reference does."""

from repro_torch.models.remat import POLICIES, wrap_remat

__all__ = ["POLICIES", "wrap_remat"]
