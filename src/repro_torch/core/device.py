"""Device selection for the port's entry points.

Entry points take ``device=None`` to mean ``cuda``.  A CPU run must be asked
for by name (``device="cpu"``, as the tests do): when CUDA is requested and
absent, :func:`resolve_device` raises instead of carrying on on the CPU, so a
timing can never silently come from the wrong device.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device raises when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def backend_name(device) -> str:
    """Backend identity used in plan-cache keys: ``"cpu"``, or ``"cuda:"``
    plus the card's name — plans measured on one card type never serve
    another."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(dev)
    return dev.type
