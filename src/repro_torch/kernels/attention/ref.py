"""Port of `repro/kernels/attention/ref.py`: the dense oracle for the
flash-attention kernel (causal GQA SDPA with an f32 softmax)."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0.

    f32 softmax, bf16/f32 inputs. Returns (B, Sq, H, D) in q's dtype.
    """
    b, sq, h, d = q.shape
    kh = k.shape[2]
    if h != kh:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    if causal:
        iq = torch.arange(sq, device=q.device)[:, None]
        ik = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(ik <= iq, scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """The attention function in f64 on folded operands: q (BH, Sq, D),
    k, v (BH/group, Sk, D), row bh of q attending to row bh // group. An
    oracle for f32 inputs whose scores are large enough that f32 sums (the
    plain version's among them) sit near the f32 bound; one KV row's query
    rows at a time. Returns (BH, Sq, D) in f64."""
    group = q.shape[0] // k.shape[0]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for kv in range(k.shape[0]):
        rows = slice(kv * group, (kv + 1) * group)
        s = (q[rows].double() @ k[kv].double().T) / math.sqrt(q.shape[2])
        if causal:
            s.masked_fill_(torch.ones(s.shape[1:], dtype=torch.bool,
                                      device=q.device).triu(1), -torch.inf)
        out[rows] = torch.softmax(s, dim=-1) @ v[kv].double()
    return out
