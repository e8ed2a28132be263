"""Device policy — the port's counterpart of ``repro/backend/target.py``.

The JAX package picks a lowering target ("tpu" or "emulated").  The port's
entry points run on the card: ``resolve_device(None)`` is ``cuda``, and it
raises when no CUDA device is present.  The CPU is used only when the caller
asks for it (``device="cpu"``), as the tests do — the kernel wrappers then
run their plain PyTorch versions.  Nothing falls back quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller says otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev

