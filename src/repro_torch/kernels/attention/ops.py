"""Public wrappers: (B, S, H, D) GQA attention via the flash kernel.

Port of `repro/kernels/attention/ops.py::flash_attention`. The reference
repeats the KV heads to the full head count before folding; here k and v
are folded with their own K heads and the kernel reads KV head
``h // (H / K)`` for query head h, the head the repeat would have put there.

`flash_attention_trainable` is the same forward under autograd (the
`FlashAttention` Function): the kernel computes the output, and the
gradient is the plain attention math's, recomputed in the backward. The
reference has no backward kernel either: its training attention is dense
jnp code that XLA differentiates.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .kernel import flash_attention_bhsd
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    bq: int = 128, bk: int = 128,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D), H % K == 0. Returns (B, Sq,
    H, D) in q's dtype. bq, bk block the plain version (on the CPU); the
    kernel's tiles are its own. `window` (causal, Sq == Sk): key j visible
    to query i iff i - window < j <= i."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    if h % kh:
        raise ValueError(f"{h} query heads not a multiple of {kh} KV heads")
    bq = min(bq, sq)
    bk = min(bk, k.shape[1])
    qf = q.transpose(1, 2).reshape(b * h, sq, d)
    kf = k.transpose(1, 2).reshape(b * kh, k.shape[1], d)
    vf = v.transpose(1, 2).reshape(b * kh, v.shape[1], d)
    out = flash_attention_bhsd(qf, kf, vf, bq=bq, bk=bk, causal=causal,
                               window=window)
    return out.reshape(b, h, sq, d).transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """The flash-attention forward with the gradient of a plain version.

    forward(q, k, v, causal, plain, window): `flash_attention` under
    no_grad (the kernel for CUDA tensors, its blocked plain version for CPU
    tensors); saves q, k and v.

    backward(dO): `plain(q, k, v)` recomputed on detached copies under
    enable_grad, then `torch.autograd.grad` of it with dO. So dq, dk and dv
    are bit-equal to autograd's gradients of `plain` at the same q, k, v
    and dO; only the forward output differs from plain's, by the kernel's
    round-off. With GQA, `plain` repeats the KV heads itself, so each KV
    head's gradient sums over its group of query heads.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, plain: Callable,
                window: Optional[int] = None):
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        with torch.no_grad():
            return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ctx.plain(q, k, v)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), d_out)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              plain: Optional[Callable] = None,
                              window: Optional[int] = None
                              ) -> torch.Tensor:
    """`flash_attention` under autograd, same layout and dtypes.

    `plain(q, k, v)` is the attention math whose gradient the backward
    takes (see `FlashAttention`); by default the dense oracle
    `attention_ref` with the same `causal` and `window`. The model's
    attention step passes its own plain step, so that its gradients are
    the reference's.
    """
    if plain is None:
        plain = functools.partial(attention_ref, causal=causal,
                                  window=window)
    return FlashAttention.apply(q, k, v, causal, plain, window)
