"""Checkpoints of the reference (PyTorch) repository, read by the port.

The port's modules carry the reference's state-dict keys, so importing a
reference checkpoint needs no layout transform: only the wrapper the
reference's trainers save (``{"state_dict": ...}``) and the ``module.``
prefix of a model trained under DDP (reference ``main_mage.py:218-223``) come
off. The port's copy of ``mage_tpu/compat/torch_import.py``'s
``strip_ddp_prefix`` and ``load_torch_checkpoint``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch


def strip_ddp_prefix(sd: Mapping[str, Any]) -> dict:
    """Drop DDP's ``module.`` prefix when every key has it."""
    if all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def load_reference_checkpoint(path: str) -> dict:
    """A reference ``.pt``/``.pth`` file -> its state dict on the CPU, with
    the ``state_dict`` wrapper and DDP's ``module.`` prefix removed."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return strip_ddp_prefix(obj)
