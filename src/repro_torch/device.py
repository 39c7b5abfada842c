"""Device resolution shared by the port's entry points.

The JAX reference picks its backend implicitly; the port takes an explicit
`device` and defaults to the CUDA card. Asking for the card on a host
without one is an error that names the way out — no entry point moves to
the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device=\"cpu\" to run on the CPU")
    return dev
