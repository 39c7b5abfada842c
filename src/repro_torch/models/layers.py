"""Core layers: RMSNorm, RoPE, GQA attention (prefill/decode), MLP.

Port of `repro/models/layers.py`. Params are plain dicts of tensors; each
layer has a `*_defs()` (shapes, init scale, and the reference's logical
sharding spec, kept as data) and a forward function.

The prefill and training attention step (between `_qkv` and the output
projection) runs the hand-written flash-attention kernel when q is on the
card, and the reference's own code on the CPU: dense scores up to
`CHUNK_THRESHOLD`, a query-chunked exact attention beyond it. A sliding
window (Mixtral) is masked in the kernel when the prompt is longer than
the window; up to the window the causal mask alone is exact. Under
autograd the card's step is `flash_attention_trainable`: the kernel's
forward, and the gradient of that plain step recomputed in the backward.
Decode keeps the plain form on both devices: the kernel's causal mask is
top-left aligned, which is not the mask of one query against a cache. The
large products around attention (`_qkv`, `wo`, `mlp`) are plain matrix
products, as in the reference.

Under sharding rules (`parallel/sharding.py`) the weights and activations
are DTensors and the reference's constraints are redistributions. The
attention step is not DTensor-aware: it runs on each rank's local shard
(its batch rows and its share of the query heads, `_local_attention`),
with the KV heads those query heads read, and its output is put back as a
DTensor with q's placements. Decode writes the new k, v into each rank's
own part of the cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch._subclasses.fake_tensor import is_fake

from ..device import on_card
from ..kernels.attention import flash_attention, flash_attention_trainable
from ..parallel.sharding import local_bounds, reshard, settled, wrap_local
from .config import ModelConfig

CHUNK_THRESHOLD = 8192
QUERY_CHUNK = 1024

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; choose from "
                         f"{sorted(DTYPES)}")
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]          # logical sharding per dim (data)
    scale: float = 1.0                       # stddev multiplier (0 => zeros)
    dtype: str = "float32"
    fan_in: Optional[int] = None             # contraction size (default dim 0)


def init_param(generator: torch.Generator, d: ParamDef) -> torch.Tensor:
    """N(0, (scale / sqrt(fan_in))^2) on the generator's device; zeros for
    scale 0."""
    dev = generator.device
    if d.scale == 0.0:
        return torch.zeros(d.shape, dtype=torch_dtype(d.dtype), device=dev)
    fan_in = d.fan_in or d.shape[0]
    std = d.scale / math.sqrt(max(fan_in, 1))
    # Scaled in place: an out-of-place product would hold two copies of the
    # largest leaf at once (16.6 GB for Qwen2-MoE's expert stacks).
    return torch.randn(d.shape, generator=generator, dtype=torch.float32,
                       device=dev).mul_(std).to(torch_dtype(d.dtype))


def init_tree(generator: torch.Generator, defs):
    """A nested dict of ParamDef -> the same dict of tensors, drawn in the
    reference's leaf order (sorted keys)."""
    if isinstance(defs, ParamDef):
        return init_param(generator, defs)
    return {k: init_tree(generator, defs[k]) for k in sorted(defs)}


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_defs(d_model: int):
    return {"scale": ParamDef((d_model,), (None,), scale=0.0)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].to(torch.float32))).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotate-half
    layout, angles in f32."""
    if isinstance(x, DTensor):
        # elementwise per (row, position): each rank rotates its own part
        (b0, bn), (s0, sn) = local_bounds(x.shape, x.device_mesh,
                                          x.placements)[:2]
        local = rope(x.to_local(), positions[b0:b0 + bn, s0:s0 + sn]
                     .to(x.device), theta)
        return wrap_local(local, x.device_mesh, x.placements, x.shape)
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; optional sliding window)
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig):
    d, h, k = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("fsdp", "tp", None)),
        "wk": ParamDef((d, k, hd), ("fsdp", "tp", None)),
        "wv": ParamDef((d, k, hd), ("fsdp", "tp", None)),
        "wo": ParamDef((h, hd, d), ("tp", None, "fsdp"), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), ("tp", None), scale=0.0)
        defs["bk"] = ParamDef((k, hd), ("tp", None), scale=0.0)
        defs["bv"] = ParamDef((k, hd), ("tp", None), scale=0.0)
    return defs


def _qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
    """(..., Sq, Sk) additive mask: causal + optional sliding window."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        ok &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return torch.where(ok, 0.0, -torch.inf).to(torch.float32)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: torch.Tensor, n_groups: int) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Sk,K,hd); bias (B?,Sq,Sk). GQA by repeating
    the KV heads; scores in the input dtype, softmax in f32, probabilities
    cast to v's dtype."""
    hd = q.shape[-1]
    if n_groups > 1:
        k = k.repeat_interleave(n_groups, dim=2)
        v = v.repeat_interleave(n_groups, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd) + bias[:, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def prefill_attention_plain(cfg: ModelConfig, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            positions: torch.Tensor,
                            check_positions: bool = True) -> torch.Tensor:
    """The reference's attention step: dense up to CHUNK_THRESHOLD, then
    exact attention over QUERY_CHUNK query blocks (never (S, S)). It takes
    any positions; `check_positions` is accepted so that it can stand in
    for `prefill_attention`."""
    b, s = q.shape[:2]
    n_groups = q.shape[2] // k.shape[2]
    if s <= CHUNK_THRESHOLD:
        bias = _mask_bias(positions, positions, cfg.sliding_window)
        return _sdpa(q, k, v, bias, n_groups)
    s_pad = -(-s // QUERY_CHUNK) * QUERY_CHUNK
    if s_pad != s:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
    # pad with the last position (a valid bias row); the output is sliced
    pp = torch.cat([positions, positions[:, -1:].expand(b, s_pad - s)],
                   dim=1)
    outs = []
    for c0 in range(0, s_pad, QUERY_CHUNK):
        bias = _mask_bias(pp[:, c0:c0 + QUERY_CHUNK], positions,
                          cfg.sliding_window)
        outs.append(_sdpa(q[:, c0:c0 + QUERY_CHUNK], k, v, bias, n_groups))
    return torch.cat(outs, dim=1)[:, :s]


def kernel_window(cfg: ModelConfig, s: int) -> Optional[int]:
    """The window the kernel masks for an S-token prefill: the config's
    sliding window when S exceeds it, else None (every key j <= i then lies
    inside i's window, so the causal mask alone is exact)."""
    w = cfg.sliding_window
    return w if w is not None and s > w else None


def prefill_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, positions: torch.Tensor,
                      check_positions: bool = True) -> torch.Tensor:
    """The prefill and training attention step: the flash-attention kernel
    on the card, `prefill_attention_plain` on the CPU.

    On the card, when grad is enabled and q, k or v requires grad, the
    step is `flash_attention_trainable` with this step's plain version as
    its backward: the kernel's output, and dq, dk, dv bit-equal to
    autograd's through `prefill_attention_plain`.

    The kernel masks by index (key j visible to query i iff j <= i, and
    with a window i - W < j), so on the card every row of `positions` must
    be 0..S-1, as `prefill` and `loss_fn` give them; checking that costs
    one host sync, which a caller that built them with arange skips with
    `check_positions=False`, and a dry run's fake tensors skip (they
    hold no values). The window is `kernel_window(cfg, S)`.
    """
    if not on_card(q):
        return prefill_attention_plain(cfg, q, k, v, positions)
    s = q.shape[1]
    window = kernel_window(cfg, s)
    if check_positions and not is_fake(positions) and not bool(
            (positions == torch.arange(s, device=positions.device)).all()):
        raise ValueError("the flash-attention kernel masks by index: "
                         "positions must be 0..S-1 in every row")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention_trainable(
            q, k, v, causal=True,
            plain=lambda q, k, v: prefill_attention_plain(cfg, q, k, v,
                                                          positions),
            window=window)
    return flash_attention(q, k, v, causal=True, window=window)


def kv_heads_for(q_heads: range, n_groups: int
                 ) -> Tuple[Sequence[int], int]:
    """The KV heads that query heads `q_heads` (a contiguous run of global
    heads) read under GQA, where query head h reads KV head h // n_groups,
    as (KV heads, group): the run's KV heads in order, each read by
    `group` consecutive query heads of the run. When the run splits a
    group unevenly the KV heads come one per query head (group 1), with
    repeats."""
    kv = [h // n_groups for h in q_heads]
    first, last = kv[0], kv[-1]
    span = last - first + 1
    if len(kv) % span == 0 and all(
            k == first + i // (len(kv) // span) for i, k in enumerate(kv)):
        return range(first, last + 1), len(kv) // span
    return kv, 1


def _take_heads(t: torch.Tensor, heads) -> torch.Tensor:
    """t[:, :, heads] for a range (a view) or a list of heads."""
    if isinstance(heads, range):
        return t[:, :, heads.start:heads.stop]
    return t.index_select(2, torch.tensor(heads, device=t.device))


def _local_kv(q: DTensor, k: DTensor, v: DTensor):
    """k and v as local tensors that line up with q's local query heads.

    q is sharded (dp, -, tp, -); k and v hold the same batch rows, and
    either the same share of the KV heads or all of them (when the KV
    heads do not divide the model axis: `spec_for_shape` replicates them).
    In that case each rank takes the KV heads its query heads read
    (`kv_heads_for`), and its gradient for them is a partial sum over the
    ranks."""
    pl = tuple(q.placements)
    k = reshard(k, [Replicate() if p == Shard(2) and kp != Shard(2) else p
                    for p, kp in zip(pl, k.placements)])
    v = reshard(v, k.placements)
    if tuple(k.placements) == pl:
        return k.to_local(), v.to_local()
    h, kh = q.shape[2], k.shape[2]
    _, _, (h0, hn), _ = local_bounds(q.shape, q.device_mesh, pl)
    heads, _ = kv_heads_for(range(h0, h0 + hn), h // kh)
    grad_pl = [Partial() if p == Shard(2) else kp
               for p, kp in zip(pl, k.placements)]
    return (_take_heads(k.to_local(grad_placements=grad_pl), heads),
            _take_heads(v.to_local(grad_placements=grad_pl), heads))


def _local_attention(step, cfg: ModelConfig, q: DTensor, k: DTensor,
                     v: DTensor, positions: torch.Tensor) -> DTensor:
    """`step(cfg, q, k, v, positions)` on this rank's batch rows and query
    heads (`_local_kv`), put back as a DTensor with q's placements."""
    q = settled(q)
    k_loc, v_loc = _local_kv(q, k, v)
    (b0, bn), *_ = local_bounds(q.shape, q.device_mesh, q.placements)
    out = step(cfg, q.to_local(), k_loc, v_loc,
               positions[b0:b0 + bn].to(k_loc.device))
    return wrap_local(out, q.device_mesh, q.placements, q.shape)


def attention_with_kv(params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, rules=None,
                      check_positions: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal GQA self-attention; returns (out, k, v) so prefill can cache.
    `check_positions` as in `prefill_attention`. Under rules q, k, v are
    constrained to (dp, -, tp, -) and the step runs on local heads."""
    q, k, v = _qkv(params, cfg, x, positions)
    if rules is not None:
        q = rules.constrain(q, "dp", None, "tp", None)
        k = rules.constrain(k, "dp", None, "tp", None)
        v = rules.constrain(v, "dp", None, "tp", None)
    if isinstance(q, DTensor):
        out = _local_attention(
            lambda c, q, k, v, p: prefill_attention(
                c, q, k, v, p, check_positions=check_positions),
            cfg, q, k, v, positions)
    else:
        out = prefill_attention(cfg, q, k, v, positions,
                                check_positions=check_positions)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    if rules is not None:
        out = rules.constrain(out, "dp", "sp", None)
    return out, k, v


def attention(params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, rules=None,
              check_positions: bool = True) -> torch.Tensor:
    """Training / prefill self-attention (causal, GQA)."""
    out, _, _ = attention_with_kv(params, cfg, x, positions, rules,
                                  check_positions)
    return out


# -- decode path ------------------------------------------------------------

def attention_decode(params, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cur_len: int, rules=None):
    """One-token decode. x: (B, 1, d); cache_*: (B, S_alloc, K, hd).

    With sliding-window attention the cache is a ring buffer of the window
    size: slot i holds the newest absolute position
    p_i = cur_len - ((cur_len - i) mod S_alloc), exactly the visible set.

    The new k, v are written into `cache_k`, `cache_v` in place (the
    reference returns updated copies). Returns (out, cache_k, cache_v).

    Under rules the cache is a DTensor view (B, S_alloc, K, hd) of a
    cache laid out by `cache_specs`: each rank writes k, v into its own
    part (the rank holding the slot, when the sequence is sharded), and
    attends on its local query heads over the whole sequence. The output
    is constrained as `attention_with_kv`'s (the reference leaves it to
    GSPMD), so that no partial sum reaches the residual stream.
    """
    b = x.shape[0]
    cur = int(cur_len)
    s_alloc = cache_k.shape[1]
    positions = torch.full((b, 1), cur, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    ring = cfg.sliding_window is not None
    slot = (cur % s_alloc) if ring else cur
    if not 0 <= slot < s_alloc:
        raise ValueError(f"decode position {cur} outside a cache of "
                         f"{s_alloc} positions")
    idx = torch.arange(s_alloc, dtype=torch.int32, device=x.device)
    if ring:
        k_pos = cur - torch.remainder(cur - idx, s_alloc)
        valid = (k_pos >= 0) & (k_pos > cur - cfg.sliding_window)
    else:
        valid = idx <= cur
    bias = torch.where(valid, 0.0, -torch.inf).to(torch.float32)

    if isinstance(cache_k, DTensor):
        _write_slot(cache_k, k, slot)
        _write_slot(cache_v, v, slot)
        if rules is not None:
            q = rules.constrain(q, "dp", None, "tp", None)
        # a sequence-sharded cache is gathered for the attention
        whole = [Replicate() if p == Shard(1) else p
                 for p in cache_k.placements]
        out = _local_attention(
            lambda c, q, k, v, _: _sdpa(
                q, k.to(q.dtype), v.to(q.dtype),
                bias.expand(q.shape[0], s_alloc)[:, None, :],
                q.shape[2] // k.shape[2]),
            cfg, q, reshard(cache_k, whole), reshard(cache_v, whole),
            positions)
    else:
        cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
        out = _sdpa(q, cache_k.to(x.dtype), cache_v.to(x.dtype),
                    bias.expand(b, s_alloc)[:, None, :],
                    cfg.num_heads // cfg.num_kv_heads)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    if rules is not None:
        out = rules.constrain(out, "dp", "sp", None)
    return out, cache_k, cache_v


def _write_slot(cache: DTensor, new: torch.Tensor, slot: int) -> None:
    """cache[:, slot] = new[:, 0] on this rank's part of a (B, S, K, hd)
    DTensor cache: `new` (B, 1, K, hd) is laid out like the cache (its
    sequence dim of one never sharded) and written by the rank whose
    sequence range holds the slot."""
    pl = [Replicate() if p == Shard(1) else p for p in cache.placements]
    local = reshard(new, pl).to_local()
    _, (s0, sn), _, _ = local_bounds(cache.shape, cache.device_mesh,
                                     cache.placements)
    if s0 <= slot < s0 + sn:
        cache.to_local()[:, slot - s0] = local[:, 0].to(cache.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": ParamDef((d, f), ("fsdp", "tp")),
            "w_up": ParamDef((d, f), ("fsdp", "tp")),
            "w_down": ParamDef((f, d), ("tp", "fsdp")),
        }
    return {
        "w_up": ParamDef((d, f), ("fsdp", "tp")),
        "w_down": ParamDef((f, d), ("tp", "fsdp")),
    }


def mlp(params, cfg: ModelConfig, x: torch.Tensor, rules=None) -> torch.Tensor:
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"].to(x.dtype))
        h = h * (x @ params["w_up"].to(x.dtype))
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ params["w_up"].to(x.dtype), approximate="tanh")
    if rules is not None:
        h = rules.constrain(h, "dp", None, "tp")
    out = h @ params["w_down"].to(x.dtype)
    if rules is not None:
        out = rules.constrain(out, "dp", "sp", None)
    return out
