"""Public wrapper: (B, S, H, D) GQA attention via the flash kernel.

Port of `repro/kernels/attention/ops.py::flash_attention`. The reference
repeats the KV heads to the full head count before folding; here k and v
are folded with their own K heads and the kernel reads KV head
``h // (H / K)`` for query head h, the head the repeat would have put there.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_bhsd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D), H % K == 0. Returns (B, Sq,
    H, D) in q's dtype. bq, bk block the plain version (on the CPU); the
    kernel's tiles are its own."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    if h % kh:
        raise ValueError(f"{h} query heads not a multiple of {kh} KV heads")
    bq = min(bq, sq)
    bk = min(bk, k.shape[1])
    qf = q.transpose(1, 2).reshape(b * h, sq, d)
    kf = k.transpose(1, 2).reshape(b * kh, k.shape[1], d)
    vf = v.transpose(1, 2).reshape(b * kh, v.shape[1], d)
    out = flash_attention_bhsd(qf, kf, vf, bq=bq, bk=bk, causal=causal)
    return out.reshape(b, h, sq, d).transpose(1, 2)
