"""Device resolution shared by the port's entry points.

The JAX reference picks its backend implicitly; the port takes an explicit
`device` and defaults to the CUDA card. Asking for the card on a host
without one is an error that names the way out — no entry point moves to
the CPU on its own.

`on_card(t)` is where a tensor's work runs: on the card for a CUDA
tensor, and, inside `fake_card()`, for a fake tensor on the CPU as well.
The dry run (`launch/dryrun.py`) traces a cell on fake CPU tensors there,
so that every kernel wrapper takes its card branch (the launch operator,
whose fake implementation gives the output's shape) and no real CPU
tensor does: a torch built without CUDA cannot run autograd's engine on
fake CUDA tensors.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import is_fake

_FAKE_CARD = 0


def resolve_device(device: "str | torch.device") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device=\"cpu\" to run on the CPU")
    return dev


@contextlib.contextmanager
def fake_card():
    """Within it, fake tensors on the CPU stand for tensors on the card
    (see `on_card`)."""
    global _FAKE_CARD
    _FAKE_CARD += 1
    try:
        yield
    finally:
        _FAKE_CARD -= 1


def on_card(t: torch.Tensor) -> bool:
    """Whether `t`'s work runs on the card: a CUDA tensor, or a fake
    tensor on the CPU inside `fake_card()`."""
    return t.device.type == "cuda" or (
        _FAKE_CARD > 0 and t.device.type == "cpu" and is_fake(t))
