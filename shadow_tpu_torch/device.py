"""Where the port's tensors live. Entry points take a `device` that is
the card ("cuda") unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. Asking for the card on a
    machine without one is an error, never a silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA not available: this entry point runs on the GPU unless "
            "asked for the CPU (pass device='cpu', or --device cpu)"
        )
    return dev
