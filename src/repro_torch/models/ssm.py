"""Mamba-2 (SSD, state-space duality — arXiv:2405.21060) block.

Port of `repro/models/ssm.py`. A prompt runs the chunked SSD algorithm:
quadratic attention-like compute inside a chunk, a linear state recurrence
across chunks (the reference's lax.scan, here a loop over the chunk axis).
Decode is the O(1) recurrent update: no KV cache, a fixed-size (H, P, N)
state plus a (d_conv-1)-deep conv buffer. The SSD runs in f32 whatever
cfg.dtype is, and sums each within-chunk decay exponent term by term where
the reference subtracts two cumulative sums (same function; see
`_ssd_chunked`).

Layout: x (B, L, H, P); B and C are one group (B, L, N), broadcast to
the heads.

Under sharding rules the mixer runs on each rank's batch rows with its
weights gathered whole (`_ssm_block_local`): the conv channels mix x, B
and C, so the reference's tensor-parallel split of them is not kept, and
the ranks of the model axis compute the same rows. Only the output
constraint is the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..parallel.sharding import reshard, wrap_local
from .config import ModelConfig
from .layers import ParamDef, rmsnorm, torch_dtype


class SSMCache(NamedTuple):
    conv: torch.Tensor     # (B, d_conv-1, conv_ch), pre-conv inputs
    state: torch.Tensor    # (B, H, P, N) f32


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state
    return d_in, nheads, conv_ch


def ssm_defs(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_in, nheads, conv_ch = ssm_dims(cfg)
    return {
        "w_z": ParamDef((d, d_in), ("fsdp", "tp")),
        "w_xbc": ParamDef((d, conv_ch), ("fsdp", "tp")),
        "w_dt": ParamDef((d, nheads), ("fsdp", "tp")),
        "conv_w": ParamDef((s.d_conv, conv_ch), (None, "tp")),
        "conv_b": ParamDef((conv_ch,), ("tp",), scale=0.0),
        "a_log": ParamDef((nheads,), ("tp",), scale=0.0),
        "d_skip": ParamDef((nheads,), ("tp",), scale=0.0),
        "dt_bias": ParamDef((nheads,), ("tp",), scale=0.0),
        "norm": ParamDef((d_in,), ("tp",), scale=0.0),
        "w_out": ParamDef((d_in, d), ("tp", "fsdp")),
    }


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    s = cfg.ssm
    d_in, nheads, _ = ssm_dims(cfg)
    x = xbc[..., :d_in]
    bmat = xbc[..., d_in:d_in + s.d_state]
    cmat = xbc[..., d_in + s.d_state:]
    b, l = x.shape[0], x.shape[1]
    x = x.reshape(b, l, nheads, s.head_dim)
    return x, bmat, cmat


def _causal_conv(cfg: ModelConfig, params, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, window d_conv, over (B, L, C)."""
    s = cfg.ssm
    xp = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
    w = params["conv_w"].to(xbc.dtype)                     # (d_conv, C)
    out = sum(xp[:, i:i + xbc.shape[1], :] * w[i] for i in range(s.d_conv))
    return F.silu(out + params["conv_b"].to(xbc.dtype))


def _ssd_chunked(cfg: ModelConfig, x: torch.Tensor, dt: torch.Tensor,
                 a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 init_state: torch.Tensor):
    """Chunked SSD scan.

    x (B,L,H,P); dt (B,L,H) post-softplus; a (H,) negative; B/C (B,L,N).
    Returns (y (B,L,H,P), final_state (B,H,P,N)).
    """
    s = cfg.ssm
    bsz, l, h, p = x.shape
    n = bmat.shape[-1]
    q = min(s.chunk, l)
    l_orig = l
    if l % q:
        # Zero-pad the tail: dt = 0 there, so xbar = 0 and the decay is
        # exp(0) = 1: the padding is inert for the outputs and the states.
        pad = q - l % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        l = l + pad
    nc = l // q

    xb = (x * dt[..., None]).reshape(bsz, nc, q, h, p)     # \bar{x}
    da = (dt * a).reshape(bsz, nc, q, h)                   # log-decays
    bm = bmat.reshape(bsz, nc, q, n)
    cm = cmat.reshape(bsz, nc, q, n)

    cs = torch.cumsum(da, dim=2)                           # (B,NC,Q,H)
    # seg[i, j] = sum of da over (j, i], summed term by term: the
    # reference's cs_i - cs_j cancels when |cs| >> |seg| (a long chunk of
    # large dt), leaving eps |cs| of error in every decay.
    iq = torch.arange(q, device=x.device)
    after = (iq[:, None] > iq[None, :])[None, None, :, :, None]
    seg = torch.cumsum(torch.where(after, da[:, :, :, None, :], 0.0), dim=2)
    # Mask BEFORE exp, as the reference does (its non-causal seg > 0 can
    # overflow, and where(mask, exp(seg), 0) then gives inf * 0 = NaN in
    # the backward).
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    seg = torch.where(causal, seg, -torch.inf)             # (B,NC,Qi,Qj,H)
    lmat = torch.exp(seg)

    # intra-chunk (the "attention-like" quadratic term)
    att = torch.einsum("bcin,bcjn->bcij", cm, bm)[..., None] * lmat
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xb)

    # chunk summary state: sum_j exp(cs_last - cs_j) B_j (x) xb_j
    decay_to_end = torch.exp(seg[:, :, -1])                # (B,NC,Q,H)
    chunk_state = torch.einsum("bcjn,bcjhp->bchpn", bm,
                               decay_to_end[..., None] * xb)
    chunk_decay = torch.exp(torch.sum(da, dim=2))          # (B,NC,H)

    # the recurrence across chunks, keeping the state *before* each chunk
    state = init_state
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,NC,H,P,N)

    # inter-chunk: y_i += C_i . (decay_in * state_prev)
    decay_in = torch.exp(cs)                               # (B,NC,Q,H)
    y_inter = torch.einsum("bcin,bchpn->bcihp", cm, prev_states) \
        * decay_in[..., None]
    y = (y_intra + y_inter).reshape(bsz, l, h, p)[:, :l_orig]
    return y, state


def ssm_block(params, cfg: ModelConfig, u: torch.Tensor, rules=None,
              cache: SSMCache | None = None, return_cache: bool = False):
    """Full Mamba-2 mixer. u: (B, L, D). With `cache`: one-step decode
    (L = 1), returning the next cache as new tensors (the caller copies
    them into its stacked cache).

    return_cache=True (prefill): also build the post-sequence cache (final
    SSD state + the conv's last d_conv - 1 pre-conv inputs) so decoding can
    continue the stream."""
    if isinstance(u, DTensor):
        return _ssm_block_local(params, cfg, u, rules, cache, return_cache)
    s = cfg.ssm
    d_in, nheads, _ = ssm_dims(cfg)
    bsz, l, _ = u.shape
    f32 = torch.float32
    z = u @ params["w_z"].to(u.dtype)
    xbc = u @ params["w_xbc"].to(u.dtype)
    dt_raw = u @ params["w_dt"].to(u.dtype)
    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"].to(f32))
    a = -torch.exp(params["a_log"].to(f32))                # (H,) negative

    new_cache = None
    if cache is None:
        xbc_raw = xbc
        xbc = _causal_conv(cfg, params, xbc)
        x, bmat, cmat = _split_xbc(cfg, xbc)
        init_state = torch.zeros((bsz, nheads, s.head_dim, s.d_state),
                                 dtype=f32, device=u.device)
        y, final_state = _ssd_chunked(cfg, x.to(f32), dt, a, bmat.to(f32),
                                      cmat.to(f32), init_state)
        if return_cache:
            tail = xbc_raw[:, -(s.d_conv - 1):, :]
            new_cache = SSMCache(conv=tail, state=final_state)
    else:
        # --- recurrent decode: O(1) state update
        conv_buf = torch.cat([cache.conv, xbc], dim=1)     # (B, d_conv, C)
        w = params["conv_w"].to(u.dtype)
        conv_out = torch.einsum("btc,tc->bc", conv_buf, w)[:, None, :]
        xbc = F.silu(conv_out + params["conv_b"].to(u.dtype))
        x, bmat, cmat = _split_xbc(cfg, xbc)
        xf = x.to(f32)[:, 0]                               # (B,H,P)
        btf = bmat.to(f32)[:, 0]                           # (B,N)
        ctf = cmat.to(f32)[:, 0]
        dt0 = dt[:, 0]                                     # (B,H)
        da = torch.exp(dt0 * a)                            # (B,H)
        upd = torch.einsum("bhp,bn,bh->bhpn", xf, btf, dt0)
        state = cache.state * da[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", state, ctf)[:, None]  # (B,1,H,P)
        new_cache = SSMCache(conv=conv_buf[:, 1:], state=state)

    y = y + params["d_skip"].to(f32)[None, None, :, None] * x.to(f32)
    y = y.reshape(bsz, l, d_in).to(u.dtype)
    y = rmsnorm({"scale": params["norm"]}, y * F.silu(z), cfg.rms_eps)
    out = y @ params["w_out"].to(u.dtype)
    return out, new_cache


def _ssm_block_local(params, cfg: ModelConfig, u: DTensor, rules, cache,
                     return_cache: bool):
    """`ssm_block` on this rank's batch rows of u (B, L, D), sharded over
    the batch only: every weight is gathered whole (its gradient a partial
    sum over the batch-sharding ranks) and the cache's rows come with all
    their channels and heads. The new cache is returned with the
    placements of `cache` (a local slice), or batch-sharded after a
    prefill."""
    mesh = u.device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in u.placements]
    u = reshard(u, rows)
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if p.is_shard() else Replicate() for p in rows]
    p_loc = {k: reshard(w, whole).to_local(grad_placements=grad)
             for k, w in params.items()}
    c_loc = None
    if cache is not None:
        c_loc = SSMCache(*(reshard(t, rows).to_local() for t in cache))
    out, new = ssm_block(p_loc, cfg, u.to_local(), cache=c_loc,
                         return_cache=return_cache)
    out = wrap_local(out, mesh, rows, u.shape)
    if rules is not None:
        out = rules.constrain(out, "dp", "sp", None)
    if new is not None:
        b = u.shape[0]
        new = SSMCache(*(wrap_local(t, mesh, rows, (b, *t.shape[1:]))
                         for t in new))
        if cache is not None:
            new = SSMCache(*(reshard(t, c.placements)
                             for t, c in zip(new, cache)))
    return out, new


def ssm_cache_defs(cfg: ModelConfig, batch: int, device="cuda") -> SSMCache:
    """A zeroed decode cache for `batch` rows on `device`: the conv buffer
    in cfg.dtype, the state in f32."""
    s = cfg.ssm
    _, nheads, conv_ch = ssm_dims(cfg)
    dev = resolve_device(device)
    return SSMCache(
        conv=torch.zeros((batch, s.d_conv - 1, conv_ch),
                         dtype=torch_dtype(cfg.dtype), device=dev),
        state=torch.zeros((batch, nheads, s.head_dim, s.d_state),
                          dtype=torch.float32, device=dev),
    )
