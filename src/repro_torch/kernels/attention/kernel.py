"""Hand-written CUDA flash-attention kernel for Hopper, its plain torch
version, and the launch wrapper.

Replaces the Pallas TPU kernel `_fa_kernel` of
`repro/kernels/attention/kernel.py` (launched there by
`flash_attention_bhsd`): the FlashAttention-2 forward over folded
(batch*head, S, D) arrays, with the running max, the normaliser and the
output accumulator in f32, causal masking by ``ik <= iq`` (masked scores
-1e30), key blocks above the diagonal skipped, and the output in q's dtype.
Beyond the reference kernel, a causal call may take a sliding window W:
key j is visible to query i iff ``i - W < j <= i`` (the mask of the
reference model's plain attention step with `sliding_window`), and key
blocks wholly below a block's window are skipped too.

The kernel is `csrc/attention.cu` (CUDA C++ for sm_90a, plain C interface,
loaded with ctypes). What bounds it on an H100 and what its design does
about that is noted at the top of that source. Unlike the reference, k and
v may carry fewer heads than q: folded row ``bh`` of q attends to row
``bh // group`` of k and v, ``group = q.shape[0] // k.shape[0]``, which is
the layout the reference's GQA repeat materialises. S need not be a
multiple of any block: the kernel masks its tails.

`flash_attention_bhsd_torch` is the plain torch version, the reference
kernel's online-softmax recurrence over ``bq x bk`` blocks (what its
interpret mode runs); `flash_attention_bhsd` takes it only for tensors on
the CPU. For a CUDA tensor it launches the kernel, whose tiles (64 queries
for bf16, 128 for f32, by 64 keys) are fixed in its source, or raises;
`bq` and `bk` only block the plain version. The default metrics registry
(obs/metrics.py) counts kernel launches, ``kernels.attention.launches``,
and those with a window, ``kernels.attention.window_launches``.

The launch is the operator `torch.ops.repro_torch.flash_attention_fwd`
(`flash_attention_fwd`): on fake tensors (a dry run, `launch/dryrun.py`)
its fake implementation gives the output's shape and dtype and launches
nothing, and `torch.utils.flop_counter` counts it by
`attention_flops`.

The kernel's output is written through ctypes, outside autograd. So on the
card the wrapper raises when grad is enabled and q, k or v requires grad:
under autograd the kernel runs only through the `ops.FlashAttention`
Function (`ops.flash_attention_trainable`).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from ...device import on_card
from ...obs import metrics
from ..build import CudaLibrary

LIBRARY = CudaLibrary(
    "attention", [Path(__file__).parent / "csrc" / "attention.cu"])

NEG_INF = -1e30
MAX_HEAD_DIM = 128

# Codes of the C entry point's `dtype` argument.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Registry counters of kernel launches (never the plain path's), and of
# those with a sliding window.
LAUNCHES = "kernels.attention.launches"
WINDOW_LAUNCHES = "kernels.attention.window_launches"


def _bound_library() -> ctypes.CDLL:
    lib = LIBRARY.load()
    lib.fa_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.fa_fwd_launch.restype = ctypes.c_int
    lib.fa_error_string.argtypes = [ctypes.c_int]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, window: Optional[int] = None) -> int:
    """Validates the folded operands and the mask; returns the GQA group
    size."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"q must be (BH, Sq, D) and k, v (BH/group, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise ValueError(f"q, k, v must share one dtype of {list(DTYPES)}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.shape[2] != k.shape[2] or q.shape[0] % k.shape[0]:
        raise ValueError(
            f"head dims {q.shape[2]} vs {k.shape[2]}, or {q.shape[0]} query "
            f"rows not a multiple of {k.shape[0]} key rows")
    if window is not None and (window < 1 or not causal
                               or q.shape[1] != k.shape[1]):
        raise ValueError(
            f"a sliding window must be >= 1 on causal self-attention (Sq == "
            f"Sk), got window {window}, causal {causal}, Sq {q.shape[1]}, "
            f"Sk {k.shape[1]}")
    return q.shape[0] // k.shape[0]


def flash_attention_bhsd_torch(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bq: int = 128, bk: int = 128,
                               causal: bool = True,
                               window: Optional[int] = None) -> torch.Tensor:
    """Plain torch version: q (BH, Sq, D), k/v (BH/group, Sk, D) -> (BH, Sq,
    D) in q's dtype. The reference kernel's blocked recurrence; the last
    block of each axis may be short. With a `window`, blocks wholly below
    the window of a query block's first row are skipped, as the kernel
    skips them."""
    group = _check(q, k, v, causal, window)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    out = torch.empty_like(q)
    for q0 in range(0, sq, bq):
        qb = qf[:, q0:q0 + bq]
        nq = qb.shape[1]
        iq = torch.arange(q0, q0 + nq, device=q.device)[:, None]
        m = torch.full((bh, nq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((bh, nq, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, bk):
            if causal and k0 > q0 + bq - 1:  # block above the diagonal
                break
            if window is not None and k0 + bk <= q0 - window + 1:
                continue                     # block below the window
            kb = kf[:, k0:k0 + bk]
            s = (qb @ kb.transpose(1, 2)) * scale
            if causal:
                ik = torch.arange(k0, k0 + kb.shape[1], device=q.device)
                ok = ik[None, :] <= iq
                if window is not None:
                    ok &= ik[None, :] > iq - window
                s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vf[:, k0:k0 + bk]
            m = m_new
        out[:, q0:q0 + nq] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous with a 16-byte aligned start (the kernel's vector
    loads need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bq: int = 128, bk: int = 128, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Fused attention over folded (BH, S, D) arrays: the CUDA kernel for
    tensors on the card, the plain torch version (blocked by bq x bk) for
    tensors on the CPU. `window` (causal, Sq == Sk): key j visible to query
    i iff i - window < j <= i; None for the causal mask alone."""
    _check(q, k, v, causal, window)
    if not on_card(q):
        if q.device.type == "cpu":
            return flash_attention_bhsd_torch(q, k, v, bq, bk, causal,
                                              window)
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_bhsd writes the kernel's output outside "
            "autograd, so its result would carry no gradient; under autograd "
            "call kernels.attention.flash_attention_trainable (the "
            "FlashAttention autograd Function), or run under torch.no_grad()")
    d = q.shape[2]
    if d % 4 or not 4 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims that are multiples of "
                         f"4 up to {MAX_HEAD_DIM}, got {d}")
    return flash_attention_fwd(q, k, v, causal, int(window or 0))


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int) -> torch.Tensor:
    """The kernel's launch as a PyTorch operator (checked operands, window
    0 for none): a fake tensor gets its output's shape and dtype from the
    fake implementation below, without the library, and a FlopCounterMode
    the count of `attention_flops`."""
    lib = _bound_library()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fa_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), bh, bh // k.shape[0], sq,
                               k.shape[1], d, 1.0 / math.sqrt(d), int(causal),
                               window, DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash-attention kernel launch failed: "
            f"{lib.fa_error_string(rc).decode()} (cudaError {rc})")
    metrics.counter(LAUNCHES).inc()
    if window > 0:
        metrics.counter(WINDOW_LAUNCHES).inc()
    return out


@flash_attention_fwd.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def attention_flops(bh: int, sq: int, sk: int, d: int, causal: bool = True,
                    window: Optional[int] = None) -> int:
    """The products the attention function needs over BH folded rows, 2 D
    operations each for q.k and for p.v per (query, visible key) pair:
    query i sees keys 0..i when causal (min(i + 1, W) of them with a
    window W), all Sk keys otherwise."""
    if not causal:
        pairs = sq * sk
    elif window:
        w = min(window, sq)
        pairs = w * (w + 1) // 2 + (sq - w) * w
    else:
        pairs = sq * (sq + 1) // 2
    return 4 * d * pairs * bh


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None,
      **kwargs) -> int:
    bh, sq, d = q_shape
    return attention_flops(bh, sq, k_shape[1], d, causal, window)
