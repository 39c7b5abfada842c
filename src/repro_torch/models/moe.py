"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

Port of `repro/models/moe.py`, the single-group path (one dispatch group per
batch row). Tokens are scattered into a per-expert capacity buffer
(B, E, C, D); over-capacity tokens are dropped (capacity_factor sets the
head-room). Shared experts (Qwen2-MoE) run densely on every token.

The reference's grouped one-hot einsum dispatch runs only under sharding
rules with a model axis; `rules=` raises here, naming ROADMAP.md item 19.

Returns (out, aux) where aux is the Switch load-balancing penalty
(E * sum_e fraction_e * prob_e).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import PARALLEL, ModelConfig, not_ported
from .layers import ParamDef


def moe_defs(cfg: ModelConfig):
    m = cfg.moe
    d = cfg.d_model
    defs = {
        "router": ParamDef((d, m.num_experts), ("fsdp", None)),
        "w_gate": ParamDef((m.num_experts, d, m.d_ff_expert),
                           ("tp", "fsdp", None), fan_in=d),
        "w_up": ParamDef((m.num_experts, d, m.d_ff_expert),
                         ("tp", "fsdp", None), fan_in=d),
        "w_down": ParamDef((m.num_experts, m.d_ff_expert, d),
                           ("tp", None, "fsdp"), fan_in=m.d_ff_expert),
    }
    if m.num_shared_experts:
        f_sh = m.num_shared_experts * m.d_ff_shared
        defs["shared"] = {
            "w_gate": ParamDef((d, f_sh), ("fsdp", "tp")),
            "w_up": ParamDef((d, f_sh), ("fsdp", "tp")),
            "w_down": ParamDef((f_sh, d), ("tp", "fsdp")),
        }
    return defs


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    c = math.ceil(tokens_per_group * m.top_k / m.num_experts * m.capacity_factor)
    return max(int(c), 1)


class Routing(NamedTuple):
    """The router's decisions for x (B, S, D), k choices per token."""
    probs: torch.Tensor      # (B, S, E) f32 softmax of the router logits
    gate_vals: torch.Tensor  # (B, S, k) f32, renormalised over the k
    gate_idx: torch.Tensor   # (B, S, k) experts, descending probability
    slot: torch.Tensor       # (B, S*k) position in the expert's buffer
    keep: torch.Tensor       # (B, S*k) False where capacity dropped it


def route(params, cfg: ModelConfig, x: torch.Tensor) -> Routing:
    """Top-k routing in f32 and each (token, choice)'s slot in its expert's
    capacity buffer. The choices are laid out token-major, choice-minor,
    and the capacity count runs along that order, as in the reference: it
    decides which tokens are dropped.

    The router product expects PyTorch's default f32 matmul precision
    (`torch.backends.cuda.matmul.allow_tf32` False): TF32's 10-bit
    mantissa would move top-k picks."""
    m = cfg.moe
    b, s, _ = x.shape
    e, k = m.num_experts, m.top_k
    c = capacity(cfg, s)
    xf, wf = x.to(torch.float32), params["router"].to(torch.float32)
    logits = xf @ wf                                              # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    flat_e = gate_idx.reshape(b, s * k)
    onehot = F.one_hot(flat_e, e)
    pos = torch.cumsum(onehot, dim=1) * onehot                    # rank+1
    pos_in_e = torch.sum(pos, dim=-1) - 1                         # (B,S*k)
    keep = (pos_in_e >= 0) & (pos_in_e < c)
    slot = torch.clamp(pos_in_e, 0, c - 1)
    return Routing(probs, gate_vals, gate_idx, slot, keep)


def moe(params, cfg: ModelConfig, x: torch.Tensor, rules=None):
    """x: (B, S, D) -> (out (B, S, D), aux 0-d f32)."""
    if rules is not None:
        raise not_ported("rules=", PARALLEL)
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    c = capacity(cfg, s)
    r = route(params, cfg, x)
    flat_e = r.gate_idx.reshape(b, s * k)

    # --- scatter dispatch. A dropped choice adds a zero at the clipped slot
    # c - 1; accumulating keeps that slot's real token whatever the order
    # (an assignment could overwrite it with the zero).
    x_rep = torch.repeat_interleave(x, k, dim=1)                  # (B,S*k,D)
    contrib = torch.where(r.keep[..., None], x_rep, 0).to(x.dtype)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = x.new_zeros((b, e, c, d))
    buf.index_put_((bidx, flat_e, r.slot), contrib, accumulate=True)

    # --- expert FFN (swiglu)
    wg = params["w_gate"].to(x.dtype)
    wu = params["w_up"].to(x.dtype)
    wd = params["w_down"].to(x.dtype)
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg))
    h = h * torch.einsum("becd,edf->becf", buf, wu)
    y = torch.einsum("becf,efd->becd", h, wd)                     # (B,E,C,D)

    # --- combine: weighted un-dispatch, sum over the k choices
    wv = r.gate_vals.reshape(b, s * k).to(x.dtype)
    y_tok = torch.where(r.keep[..., None], y[bidx, flat_e, r.slot], 0)
    out = torch.sum((y_tok * wv[..., None]).reshape(b, s, k, d), dim=2)

    if m.num_shared_experts:
        sh = params["shared"]
        hs = F.silu(x @ sh["w_gate"].to(x.dtype))
        hs = hs * (x @ sh["w_up"].to(x.dtype))
        out = out + hs @ sh["w_down"].to(x.dtype)

    # --- Switch load-balancing auxiliary loss
    frac = torch.mean(F.one_hot(r.gate_idx[..., 0], e).to(torch.float32),
                      dim=(0, 1))
    pmean = torch.mean(r.probs, dim=(0, 1))
    aux = m.router_aux_weight * e * torch.sum(frac * pmean)
    return out, aux
