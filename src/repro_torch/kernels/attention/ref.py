"""Port of `repro/kernels/attention/ref.py`: the dense oracle for the
flash-attention kernel (causal GQA SDPA with an f32 softmax)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _visible(sq: int, sk: int, window: Optional[int],
             device) -> torch.Tensor:
    """(Sq, Sk) bool: key j visible to query i iff j <= i, and with a
    window also j > i - window."""
    iq = torch.arange(sq, device=device)[:, None]
    ik = torch.arange(sk, device=device)[None, :]
    ok = ik <= iq
    if window is not None:
        ok &= ik > iq - window
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0.

    f32 softmax, bf16/f32 inputs. Returns (B, Sq, H, D) in q's dtype.
    `window` (causal only): key j visible to query i iff i - window < j <= i.
    """
    b, sq, h, d = q.shape
    kh = k.shape[2]
    if h != kh:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    if causal:
        scores = torch.where(_visible(sq, k.shape[1], window, q.device),
                             scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """The attention function in f64 on folded operands: q (BH, Sq, D),
    k, v (BH/group, Sk, D), row bh of q attending to row bh // group, under
    `attention_ref`'s mask (causal, with an optional window). An oracle
    for f32 inputs whose scores are large enough that f32 sums (the plain
    version's among them) sit near the f32 bound; one KV row's query rows
    at a time. Returns (BH, Sq, D) in f64."""
    group = q.shape[0] // k.shape[0]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for kv in range(k.shape[0]):
        rows = slice(kv * group, (kv + 1) * group)
        s = (q[rows].double() @ k[kv].double().T) / math.sqrt(q.shape[2])
        if causal:
            s.masked_fill_(~_visible(s.shape[1], s.shape[2], window,
                                     q.device), -torch.inf)
        out[rows] = torch.softmax(s, dim=-1) @ v[kv].double()
    return out


def f64_distances(x: torch.Tensor, exact: torch.Tensor) -> Tuple[float, float]:
    """(max |x - exact|, RMS(x - exact) / RMS(exact)) against an
    `attention_f64` result."""
    err = x.double() - exact
    return (float(err.abs().max()),
            float(err.pow(2).mean().sqrt() / exact.pow(2).mean().sqrt()))


def within_plain_rounding(got: torch.Tensor, plain: torch.Tensor,
                          exact: torch.Tensor) -> bool:
    """The bf16 kernel's bound against the f64 function: its max error and
    relative RMSE each within twice the plain version's. Both compute in
    f32 and round once to bf16, so each sits about half a bf16 ulp from
    the exact function; a key missed or let in at a window's edge moves
    the rows it touches by far more than that."""
    (d_k, r_k), (d_p, r_p) = (f64_distances(got, exact),
                              f64_distances(plain, exact))
    return d_k <= 2 * d_p and r_k <= 2 * r_p
