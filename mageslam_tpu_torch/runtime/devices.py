"""Where the port's entry points run: the card unless the caller asks for
another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another.  Without a CUDA device the default raises; there is no
    quiet step down to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engine runs on the card by default; pass "
            'device="cpu" to ask for the CPU')
    return dev
