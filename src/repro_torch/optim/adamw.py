"""AdamW with global-norm clipping. Port of `repro/optim/adamw.py`.

The reference's own math, not `torch.optim.AdamW`: the gradients are
clipped to a global norm of `grad_clip` (scale ``grad_clip / (gnorm +
1e-9)``, at most 1), the bias corrections ``1 - b^step`` are taken in
f32, ``delta = m_hat / (sqrt(v_hat) + eps) + weight_decay * p``, and
``p <- p - lr * lr_scale * delta`` cast back to p's dtype. The moments are
f32 and `step` is a 0-d int32 tensor on the parameters' device, so a
checkpoint of an `OptState` is byte-compatible with the reference's.

Unlike the reference, `adamw_update` updates the parameters and the
moments in place, under `torch.no_grad()`: at Qwen2-1.5B width a second
copy of weights plus moments would be another 18.5 GB on the card.

Sharded parameters (DTensors) keep moments with their placements (ZeRO-1:
no optimizer state is gathered); each gradient is laid out like its
parameter and the update runs on the local parts. The global norm sums
over the whole sharded tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..parallel.sharding import full, reshard

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


def _leaves(tree: PyTree) -> List[torch.Tensor]:
    """The tensors of nested dicts in the reference's leaf order (sorted
    keys)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]


def _zeros_f32(tree: PyTree) -> PyTree:
    if isinstance(tree, DTensor):
        return torch.zeros_like(tree, dtype=torch.float32,
                                requires_grad=False)
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    return {k: _zeros_f32(v) for k, v in tree.items()}


def adamw_init(params: PyTree) -> OptState:
    """Zero f32 moments shaped like `params`, step 0 on their device."""
    device = _leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=_zeros_f32(params), nu=_zeros_f32(params))


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, summed leaf by leaf
    in the reference's leaf order. DTensor leaves reduce over their mesh;
    the result is a plain 0-d tensor, the same on every rank."""
    total = None
    for x in _leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return full(torch.sqrt(total))


def local_part(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x's local part laid out like `like` (a DTensor); x itself for plain
    tensors."""
    if isinstance(like, DTensor):
        return reshard(x, like.placements).to_local()
    return x


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: PyTree, state: OptState,
                 params: PyTree, lr_scale: "torch.Tensor | float" = 1.0
                 ) -> Tuple[PyTree, OptState, Dict[str, torch.Tensor]]:
    """Returns (params, new_state, {"grad_norm": gnorm}).

    `params`, `state.mu` and `state.nu` are updated in place and returned
    (the new state shares them); `grads` and `state.step` are left as they
    were. No value leaves the device: the clip scale, the bias corrections
    and the learning rate stay 0-d tensors."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)
    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(state.mu), _leaves(state.nu)):
        g = local_part(g, p)
        p, m, v = (local_part(t, t) for t in (p, m, v))
        g = g.to(torch.float32) * clip
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        denom = torch.sqrt(v / b2c).add_(cfg.eps)
        delta = (m / b1c).div_(denom).add_(p.to(torch.float32),
                                           alpha=cfg.weight_decay)
        p.copy_(p.to(torch.float32) - delta.mul_(lr))
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm}
