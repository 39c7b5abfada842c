"""Training step: loss -> grads -> AdamW, with micro-batched gradient
accumulation.

Port of `repro/training/train_step.py`. The reference scans over the
micro-batch slices; here a Python loop takes each slice's gradients with
`torch.autograd.grad` and adds them into f32 buffers. On the card every
attention layer's forward is the flash-attention kernel (through
`kernels.attention.flash_attention_trainable`); its backward, the loss
and AdamW are plain torch, as they are plain jnp in the reference.

The update runs in place (see `optim.adamw`): `train_step` returns a new
`TrainState` whose params and moments are the tensors of the state it was
given.

Under sharding rules the params and moments are DTensors laid out by
`state_shardings`; each micro-batch's gradients are laid out like the
params (a reduce-scatter of the fsdp-gathered weights' partial sums) and
accumulate on the local parts. The batch is whole on every rank or laid
out over dp (each rank fed its rows), and each rank embeds its own rows
of each micro-batch; the loss and the metrics come back as plain 0-d
tensors, the same on every rank.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import (
    abstract_params, init_params, loss_fn, param_shardings,
    params_from_reference)
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..optim.adamw import _leaves, local_part
from ..optim.schedule import cosine_schedule
from ..parallel.sharding import ShardingRules, full, wrap_local

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: OptState


def _like(tree: PyTree, leaves: List[torch.Tensor]) -> PyTree:
    """`leaves` (in `_leaves(tree)`'s order) put back under tree's keys."""
    return _build(tree, iter(leaves))


def _build(tree: PyTree, it) -> PyTree:
    # Not a closure over `it`: a nested function that calls itself is a
    # reference cycle, and would keep `leaves` (a step's gradients) on the
    # device until the garbage collector ran.
    if isinstance(tree, torch.Tensor):
        return next(it)
    return {k: _build(tree[k], it) for k in sorted(tree)}


def init_train_state(cfg: ModelConfig, seed: int, device="cuda",
                     rules: Optional[ShardingRules] = None) -> TrainState:
    """`init_params(cfg, seed, device, rules)` with requires_grad set, and
    zero f32 moments laid out like the params."""
    params = init_params(cfg, seed, device, rules)
    for p in _leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params))


def train_state_from_reference(np_state, cfg: ModelConfig,
                               device="cuda",
                               rules: Optional[ShardingRules] = None
                               ) -> TrainState:
    """The reference's TrainState, as numpy arrays
    (``jax.tree.map(np.asarray, state)``), as the port's on `device`: the
    params and the f32 moments under the same keys (checked against
    `model_defs(cfg)`), sharded by `rules` if given, and `step` as a 0-d
    int32 tensor."""
    np_params, (np_step, np_mu, np_nu) = np_state
    params = params_from_reference(np_params, cfg, device, rules)
    for p in _leaves(params):
        p.requires_grad_(True)
    mu = params_from_reference(np_mu, cfg, device, rules)
    nu = params_from_reference(np_nu, cfg, device, rules)
    for m in _leaves(mu) + _leaves(nu):
        if m.dtype != torch.float32:
            raise ValueError(f"moments must be f32, got {m.dtype}")
    step = torch.tensor(int(np.asarray(np_step)), dtype=torch.int32,
                        device=resolve_device(device))
    return TrainState(params, OptState(step, mu, nu))


def loss_and_grads(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   rules=None, remat: bool = True):
    """(loss, grads): `loss_fn`'s loss, detached, and its gradient with
    respect to every leaf of `params`, under the same keys (the counterpart
    of the reference's `jax.value_and_grad`). The gradients are taken with
    respect to aliases of the leaves, so a state trains whether or not its
    tensors require grad (a restored one does not)."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    loss, _ = loss_fn(_like(params, leaves), cfg, batch, rules, remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _like(params, list(grads))


def make_abstract_state(cfg: ModelConfig) -> TrainState:
    """The train state as meta tensors: the params' shapes and dtypes, f32
    moments and a 0-d int32 step."""
    params = abstract_params(cfg)

    def f32(tree):
        if isinstance(tree, torch.Tensor):
            return torch.empty(tree.shape, dtype=torch.float32,
                               device="meta")
        return {k: f32(v) for k, v in tree.items()}

    return TrainState(params, OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=f32(params), nu=f32(params)))


def state_shardings(cfg: ModelConfig, rules: ShardingRules) -> TrainState:
    """The Shardings of the train state: the moments are laid out like the
    params (ZeRO-1), the step replicated (None without a mesh)."""
    ps = param_shardings(cfg, rules)
    return TrainState(ps, OptState(
        step=rules.sharding() if rules.mesh is not None else None,
        mu=ps, nu=ps))


def make_train_step(cfg: ModelConfig,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    rules=None,
                    microbatches: int = 1,
                    warmup: int = 100, total_steps: int = 10_000,
                    remat: bool = True):
    """Returns train_step(state, batch) -> (state, metrics), metrics
    holding `loss`, `grad_norm` and `lr_scale` as 0-d tensors.

    With `microbatches` > 1 each batch entry is cut as the reference cuts
    it, reshape(microbatches, B // microbatches, ...): contiguous slices,
    in order. Micro-batch m is those rows of the whole batch, spread over
    the dp ranks as GSPMD lays it out (rank d of the data axes embeds its
    d-th share of them), not each rank's m-th slice of its own rows: the
    MoE's capacity drops and its router's loss depend on which tokens
    share a micro-batch. So an entry fed laid out over dp is first
    gathered whole (an all-gather of its rows; token ids are a few MB).
    Loss and gradients are summed over the slices and divided by
    `microbatches`; the schedule is evaluated at opt.step + 1."""

    def grads_of(params, batch):
        loss, grads = loss_and_grads(params, cfg, batch, rules, remat)
        # each gradient laid out like its param, as a plain local tensor
        return full(loss), [local_part(g, p) for g, p in
                            zip(_leaves(grads), _leaves(params))]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            def slice_mb(x, m):
                b = x.shape[0]
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])[m]
            whole = {k: full(v) for k, v in batch.items()}
            loss, grads = None, None
            for m in range(microbatches):
                mb_loss, mb_grads = grads_of(
                    params, {k: slice_mb(v, m) for k, v in whole.items()})
                mb_grads = [g.to(torch.float32) for g in mb_grads]
                if grads is None:
                    loss, grads = mb_loss, mb_grads
                else:
                    loss = loss + mb_loss
                    torch._foreach_add_(grads, mb_grads)
                del mb_grads
            loss = loss / microbatches
            torch._foreach_div_(grads, float(microbatches))

        lr_scale = cosine_schedule(state.opt.step + 1, warmup, total_steps)
        grads = [wrap_local(g, p.device_mesh, p.placements, p.shape)
                 if isinstance(p, DTensor) else g
                 for g, p in zip(grads, _leaves(params))]
        new_params, new_opt, om = adamw_update(
            opt_cfg, _like(params, grads), state.opt, params, lr_scale)
        metrics = {"loss": loss, "grad_norm": om["grad_norm"],
                   "lr_scale": lr_scale}
        return TrainState(new_params, new_opt), metrics

    return train_step
