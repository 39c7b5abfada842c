"""Filtering stage (paper Alg. 1): cosine weighting + 1-D ramp convolution.

Port of `repro/core/filtering.py`. The numpy tables (`cosine_weights`,
`ramp_kernel`, `ramp_frequency_response`, `fft_length`) are the reference's
own code, so they are bit-equal. The convolution runs on `torch.fft`
(cuFFT on the card) at the same padded length, in f32, a batch of
projections at a time so that the complex spectrum of a clinical-size
stream never lives in memory whole.

Q_i(j, .) = (E_i * F_cos)(j, .)  (x)  F_ramp        for every detector row j
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .geometry import CBCTGeometry

_WINDOWS = ("ramlak", "shepp-logan", "hann", "hamming")

# Projections filtered per FFT batch: bounds the (B, N_v, pad/2+1) complex
# spectrum and the (B, N_v, pad) inverse transform.
_FILTER_BATCH = 32


def cosine_weights(g: CBCTGeometry) -> np.ndarray:
    """F_cos: the FDK cosine (Feldkamp) weighting table, shape (N_v, N_u).

    w(u, v) = d / sqrt(d^2 + p^2 + zeta^2) with (p, zeta) the virtual-detector
    (isocenter-rescaled) physical coordinates of the pixel.
    """
    cu = (g.n_u - 1) / 2.0
    cv = (g.n_v - 1) / 2.0
    p = (np.arange(g.n_u, dtype=np.float64) - cu) * g.tau_u
    zeta = (np.arange(g.n_v, dtype=np.float64) - cv) * g.tau_v
    pp, zz = np.meshgrid(p, zeta, indexing="xy")
    return (g.d / np.sqrt(g.d * g.d + pp * pp + zz * zz)).astype(np.float32)


def ramp_kernel(n: int, tau: float) -> np.ndarray:
    """Band-limited spatial-domain ramp h[n], length n (n even, circular).

    h[0] = 1/(4 tau^2); h[m] = -1/(m pi tau)^2 for odd m; 0 for even m != 0.
    Negative lags are wrapped (h[n-m] = h[m]).
    """
    h = np.zeros(n, dtype=np.float64)
    h[0] = 1.0 / (4.0 * tau * tau)
    m = np.arange(1, n // 2 + 1)
    odd = m[m % 2 == 1]
    val = -1.0 / (odd * np.pi * tau) ** 2
    h[odd] = val
    h[n - odd] = val
    return h


def ramp_frequency_response(g: CBCTGeometry, window: str = "ramlak",
                            pad: int | None = None) -> np.ndarray:
    """rfft of the (apodized) ramp kernel at padded length."""
    if window not in _WINDOWS:
        raise ValueError(f"unknown window {window!r}; choose from {_WINDOWS}")
    n = pad or fft_length(g.n_u)
    h = ramp_kernel(n, g.tau_u)
    hf = np.fft.rfft(h)
    freq = np.fft.rfftfreq(n)  # cycles/sample in [0, 0.5]
    if window == "shepp-logan":
        x = np.pi * freq
        w = np.where(freq > 0, np.sin(np.clip(x, 1e-12, None)) / np.clip(x, 1e-12, None), 1.0)
    elif window == "hann":
        w = 0.5 * (1.0 + np.cos(2.0 * np.pi * freq))
    elif window == "hamming":
        w = 0.54 + 0.46 * np.cos(2.0 * np.pi * freq)
    else:
        w = np.ones_like(freq)
    return (hf * w).astype(np.complex64)


def fft_length(n_u: int) -> int:
    """Next power of two >= 2*N_u (linear, not circular, convolution)."""
    n = 1
    while n < 2 * n_u:
        n *= 2
    return n


def _filter_batch(proj: torch.Tensor, fcos: torch.Tensor, hf: torch.Tensor,
                  pad: int, tau_u: float, out_dtype=None) -> torch.Tensor:
    """Alg. 1 over a batch: proj (B, N_v, N_u) -> filtered (B, N_v, N_u)."""
    n_u = proj.shape[-1]
    e = proj.to(torch.float32) * fcos[None]
    ef = torch.fft.rfft(e, n=pad, dim=-1)
    q = torch.fft.irfft(ef * hf[None, None, :], n=pad, dim=-1)[..., :n_u]
    # Discrete convolution sum approximates the integral: multiply by the
    # sample pitch tau (Kak & Slaney eq. 3.62).
    return (q * tau_u).to(out_dtype or proj.dtype)


def make_filter(g: CBCTGeometry, window: str = "ramlak", out_dtype=None,
                device="cuda"):
    """Returns filter_fn(proj: (B, N_v, N_u)) -> (B, N_v, N_u) on `device`.

    `out_dtype` is the storage dtype of the emitted filtered projections;
    the FFT convolution itself always runs in f32. None keeps the input
    dtype.
    """
    dev = resolve_device(device)
    pad = fft_length(g.n_u)
    fcos = torch.as_tensor(cosine_weights(g), device=dev)
    hf = torch.as_tensor(ramp_frequency_response(g, window, pad), device=dev)

    def filter_fn(proj: torch.Tensor) -> torch.Tensor:
        proj = torch.as_tensor(proj, device=dev)
        out = torch.empty(proj.shape, dtype=out_dtype or proj.dtype,
                          device=dev)
        for b0 in range(0, proj.shape[0], _FILTER_BATCH):
            sl = slice(b0, b0 + _FILTER_BATCH)
            out[sl] = _filter_batch(proj[sl], fcos, hf, pad, g.tau_u,
                                    out_dtype)
        return out

    return filter_fn


def filter_projections(g: CBCTGeometry, proj: torch.Tensor,
                       window: str = "ramlak", out_dtype=None) -> torch.Tensor:
    """One-shot filtering of all projections (N_p, N_v, N_u), on the
    projections' own device."""
    return make_filter(g, window, out_dtype, device=proj.device)(proj)
