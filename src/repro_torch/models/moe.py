"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

Port of `repro/models/moe.py`. Tokens are grouped, B rows x G sequence
groups of S/G tokens; each group has its own capacity of C slots per
expert (`capacity(cfg, S/G)`), and over-capacity choices are dropped
(capacity_factor sets the head-room). Shared experts (Qwen2-MoE) run
densely on every token.

G = 1 without rules, or when the rules' tensor-parallel size g does not
divide S: tokens are scattered into a (B, E, C, D) buffer. Otherwise G =
g and the dispatch is the reference's GShard one-hot einsum: a (Sg*k, E,
C) one-hot per group, a contraction into (B, G, E, C, D). With a smaller
group the capacity counts fewer tokens, so the drops differ from G = 1's:
it is a different function, and the one the reference serves on a mesh.

Under rules the routing, dispatch and combine run on each rank's own
token groups (the groups are sharded over the model axis, the rows over
the data axes); the buffer is resharded from token groups to experts for
the expert FFN and back (`constrain_p`, an all-gather and a local slice),
and the router's gradient is a partial sum over the token-sharded ranks.

Returns (out, aux) where aux is the Switch load-balancing penalty
(E * sum_e fraction_e * prob_e).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..parallel.sharding import P, reshard, settled, summed, wrap_local
from .config import ModelConfig
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


def _local(x, grad_placements=None):
    """A DTensor's local part (differentiable); a tensor unchanged."""
    if isinstance(x, DTensor):
        return x.to_local(grad_placements=grad_placements)
    return x


def _token_partial(x, w):
    """Placements of the gradient of a replicated weight `w` used on the
    local tokens of `x`: a partial sum over the mesh dims that shard x."""
    if not isinstance(x, DTensor):
        return None
    return [Partial() if p.is_shard() else wp
            for p, wp in zip(x.placements, w.placements)]


def _experts(params, buf):
    """The expert FFN (swiglu) on a (..., E, C, D) buffer, experts on dim
    -3. DTensor weights keep only their expert sharding: a dim sharded
    over the fsdp axes is gathered here, at use, so that the products
    shard over the experts alone."""
    def weight(name):
        w = params[name].to(buf.dtype)
        if isinstance(w, DTensor):
            w = reshard(w, [p if p == Shard(0) else Replicate()
                            for p in w.placements])
        return w

    wg, wu, wd = weight("w_gate"), weight("w_up"), weight("w_down")
    h = F.silu(torch.einsum("...ecd,edf->...ecf", buf, wg))
    h = h * torch.einsum("...ecd,edf->...ecf", buf, wu)
    return torch.einsum("...ecf,efd->...ecd", h, wd)


def _aux(cfg: ModelConfig, r: Routing, like, n_tokens: int):
    """The Switch load-balancing loss from the local routing `r`: its
    per-expert sums are partial over the ranks that shard `like`."""
    m = cfg.moe
    e = m.num_experts
    frac = F.one_hot(r.gate_idx[..., 0], e).to(torch.float32)
    frac = frac.reshape(-1, e).sum(0)
    psum = r.probs.reshape(-1, e).sum(0)
    if isinstance(like, DTensor):
        pl = [Partial() if p.is_shard() else Replicate()
              for p in like.placements]
        frac = summed(frac, like.device_mesh, pl, (e,))
        psum = summed(psum, like.device_mesh, pl, (e,))
    return m.router_aux_weight * e * torch.sum(
        (frac / n_tokens) * (psum / n_tokens))


def moe(params, cfg: ModelConfig, x: torch.Tensor, rules=None):
    """x: (B, S, D) -> (out (B, S, D), aux 0-d f32)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    g = rules.tp_size() if rules is not None else 1
    if g <= 1 or s % g:
        g = 1
    sg = s // g
    c = capacity(cfg, sg)
    dp, tp = ((rules.axes("dp"), rules.axes("tp")) if rules is not None
              else (None, None))
    x = settled(x)                 # the local code reads values, not sums
    xd = x.reshape(b, g, sg, d)
    if rules is not None and g > 1:
        xd = rules.constrain_p(xd, P(dp, tp, None, None))
    xl = _local(xd)                                   # (b, g, sg, d) local
    bl, gl = xl.shape[:2]
    router = params["router"]
    if isinstance(router, DTensor):
        router = reshard(router, [Replicate()] * router.device_mesh.ndim)
    r = route({"router": _local(router, _token_partial(xd, router))}, cfg,
              xl.reshape(bl * gl, sg, d))
    flat_e = r.gate_idx.reshape(bl * gl, sg * k)
    x_rep = torch.repeat_interleave(xl.reshape(bl * gl, sg, d), k, dim=1)
    wv = r.gate_vals.reshape(bl * gl, sg * k).to(x.dtype)

    def wrap(t, shape):
        if not isinstance(xd, DTensor):
            return t
        return wrap_local(t, xd.device_mesh, xd.placements, shape)

    if g > 1:
        # --- GShard one-hot einsum dispatch: (Sg*k, E, C) per group
        onehot_c = F.one_hot(r.slot, c).to(x.dtype) \
            * r.keep[..., None].to(x.dtype)                    # (bg,Sk,C)
        dispatch = F.one_hot(flat_e, e).to(x.dtype)[..., None] \
            * onehot_c[..., None, :]                           # (bg,Sk,E,C)
        buf = torch.einsum("gtec,gtd->gecd", dispatch, x_rep)
        buf = wrap(buf.reshape(bl, gl, e, c, d), (b, g, e, c, d))
        if rules is not None:
            buf = rules.constrain_p(buf, P(dp, None, tp, None, None))
        y = _experts(params, buf)                              # (B,G,E,C,D)
        if rules is not None:
            # back from expert owners to token groups
            y = rules.constrain_p(y, P(dp, tp, None, None, None))
        yl = _local(y).reshape(bl * gl, e, c, d)
        comb = dispatch * wv[..., None, None]
        y_sum = torch.einsum("gtec,gecd->gtd", comb, yl)
    else:
        # --- scatter dispatch. A dropped choice adds a zero at the clipped
        # slot c - 1; accumulating keeps that slot's real token whatever
        # the order (an assignment could overwrite it with the zero).
        contrib = torch.where(r.keep[..., None], x_rep, 0).to(x.dtype)
        bidx = torch.arange(bl * gl, device=xl.device)[:, None] \
            .expand(bl * gl, sg * k)
        buf = xl.new_zeros((bl * gl, e, c, d))
        buf.index_put_((bidx, flat_e, r.slot), contrib, accumulate=True)
        buf = wrap(buf.reshape(bl, gl, e, c, d), (b, g, e, c, d))
        if rules is not None:
            buf = rules.constrain_p(buf, P(dp, None, tp, None, None))
        y = _experts(params, buf)
        if rules is not None:
            # one group: every rank of the model axis takes all experts
            y = rules.constrain_p(y, P(dp, None, None, None, None))
        yl = _local(y).reshape(bl * gl, e, c, d)
        y_tok = torch.where(r.keep[..., None], yl[bidx, flat_e, r.slot], 0)
        y_sum = y_tok * wv[..., None]
    out = y_sum.reshape(bl, gl, sg, k, d).sum(dim=3)
    out = wrap(out, (b, g, sg, d)).reshape(b, s, d)
    if rules is not None:
        out = rules.constrain(out, "dp", "sp", None)

    if m.num_shared_experts:
        sh = params["shared"]
        hs = F.silu(x @ sh["w_gate"].to(x.dtype))
        hs = hs * (x @ sh["w_up"].to(x.dtype))
        hs = hs @ sh["w_down"].to(x.dtype)
        if rules is not None:
            hs = rules.constrain(hs, "dp", "sp", None)
        out = out + hs

    return out, _aux(cfg, r, xd, b * s)
