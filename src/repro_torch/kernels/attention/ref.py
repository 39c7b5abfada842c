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
