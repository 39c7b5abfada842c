"""Hand-written CUDA ramp filter for Hopper, its plain torch version, and the
launch wrapper.

Replaces no Pallas kernel: the JAX package filters with `jnp.fft`
(`repro/core/filtering.py`), and the port did so on the card with
`torch.fft` (cuFFT) in `core/filtering._filter_batch`, which stays the CPU
path. On the card that chain made every detector row into a zero-filled
padded row, a complex spectrum, its product with the response, an inverse
transform and a scaled crop, each a pass over device memory: about twenty
times the bytes the function needs. The kernel (`csrc/filter.cu`) keeps the
padded row and its spectrum in shared memory, reads each raw sample once and
writes each filtered sample once; its header says what bounds it.

For a row x of N_u samples, its cosine-weight row c and pad = 2M, the
filter's FFT length (a power of two >= 2 N_u), both compute

    tau_u * irfft(rfft(x * c, pad) * H, pad)[:N_u]

by this algorithm:

1. z[n] = x_w[2n] + i x_w[2n+1] with x_w = x * c, zero beyond N_u. Only
   n < ceil(N_u / 2) <= M / 2 is nonzero: the kernel loads nothing else.
2. Z = DFT_M(z), a Stockham transform (natural order in and out) in passes
   of radix 16 after one of radix 2^(log2 M mod 4) (`radices`), each pass
   twiddled from `twiddle_table`.
3. The real split, the response and the inverse split in one step,
   Z'[k] = P[k] Z[k] + Q[k] conj(Z[(M - k) mod M]). P and Q
   (`response_table`) fold the split's twiddles, the window's response H,
   tau_u and the inverse's 1/pad; they are made in float64 and rounded
   once.
4. y = IDFT_M(Z') unnormalised, the radices reversed; the outputs are
   x_f[2n] = Re y[n] and x_f[2n+1] = Im y[n] for the indices below N_u.
   The kernel stores nothing else.

`filter_rows_torch` is that algorithm in plain torch (complex64, the same
tables and passes; the pruned loads and stores are its zero padding and its
crop), the kernel's twin for the tests. `filter_rows` launches the kernel
for a tensor on the card or raises; the CPU path of `make_filter` is
`core/filtering._filter_batch`.

The kernel is compiled for pads 2^6 to 2^14 (`PADS`); any other raises. Each
row is filtered alone, so a row's output does not depend on the batch it
came in.

The launch is the operator `torch.ops.repro_torch.filter_rows_launch`: on
fake tensors (a dry run, `launch/dryrun.py`) its fake implementation gives
the output's shape and launches nothing. A real launch advances
``kernels.filter.launches`` by one and ``kernels.filter.rows`` by the rows it
filtered in the default metrics registry (obs/metrics.py). With the tracer
on, the launch alone is the ``filter.kernel`` device stage of the enclosing
fence (`obs.trace.device_stage`), as ``bp.kernel`` is the back-projector's:
the ``stage.filter`` around it also holds the host's way to the launch,
which an idle card waits out inside the stage.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...device import on_card
from ...obs import metrics
from ...obs.trace import device_stage
from ..build import CudaLibrary

LIBRARY = CudaLibrary("filter", [Path(__file__).parent / "csrc" / "filter.cu"])

# The compiled FFT lengths (kMinLog2Pad..kMaxLog2Pad in the source).
PADS = tuple(1 << n for n in range(6, 15))

# The registry counters a launch advances (see the module docstring).
LAUNCHES = "kernels.filter.launches"
ROWS = "kernels.filter.rows"

_BOUND: Optional[ctypes.CDLL] = None


# -- the host tables ----------------------------------------------------------

def radices(pad: int, inverse: bool = False) -> List[int]:
    """The passes of the length-pad/2 complex transform: one of radix
    2^(log2 M mod 4), where that is not 1, then radix 16 (forward); the
    inverse takes them in reverse order."""
    log2m = pad.bit_length() - 2
    out = ([1 << log2m % 4] if log2m % 4 else []) + [16] * (log2m // 4)
    return out[::-1] if inverse else out


def _passes(pad: int, inverse: bool) -> List[Tuple[int, int]]:
    """(Ns, R) of each pass: Ns is the product of the radices before it."""
    out, ns = [], 1
    for r in radices(pad, inverse):
        out.append((ns, r))
        ns *= r
    return out


def twiddle_table(pad: int) -> np.ndarray:
    """The passes' twiddles, (n, 2) float32 (re, im): for each pass with
    Ns > 1 of the forward transform, then of the inverse, the (R - 1, Ns)
    block W[r - 1, k] = exp(-2 pi i r k / (Ns R)), r = 1..R-1, k < Ns,
    row-major. The inverse conjugates them. Computed in float64 and
    rounded once."""
    parts = [np.zeros(0, np.complex128)]
    for inverse in (False, True):
        for ns, r in _passes(pad, inverse):
            if ns > 1:
                rk = np.arange(1, r)[:, None] * np.arange(ns)[None, :]
                parts.append(np.exp(-2j * np.pi * rk / (ns * r)).ravel())
    t = np.concatenate(parts)
    return np.stack([t.real, t.imag], axis=1).astype(np.float32)


def split_response(hf: np.ndarray, tau: float) -> Tuple[np.ndarray, np.ndarray]:
    """P and Q of step 3 (module docstring), complex128 (M,), for the
    response hf (M + 1 bins of the length-2M real transform).

    With W = exp(-2 pi i / 2M), a = (1 - i W^k) / 2, b = (1 + i W^k) / 2:
    X[k] = a Z[k] + b conj(Z[M-k]) is the real signal's spectrum, Y =
    X H, and Z'[k] = 2 conj(a) Y[k] + 2 conj(b) conj(Y[M-k]) the packed
    spectrum of the output, so
    P = 2 (|a|^2 H[k] + |b|^2 conj(H[M-k])) tau / 2M and
    Q = 2 (conj(a) b H[k] + conj(b) a conj(H[M-k])) tau / 2M.
    The imaginary parts of bins 0 and M are dropped, as irfft drops them.
    """
    hf = np.array(hf, dtype=np.complex128)
    m = hf.shape[0] - 1
    hf[0], hf[m] = hf[0].real, hf[m].real
    k = np.arange(m)
    w = np.exp(-2j * np.pi * k / (2 * m))
    a, b = 0.5 * (1 - 1j * w), 0.5 * (1 + 1j * w)
    h, hm = hf[:m], np.conj(hf[m - k])
    scale = tau / (2 * m)
    p = 2 * (np.abs(a) ** 2 * h + np.abs(b) ** 2 * hm) * scale
    q = 2 * (np.conj(a) * b * h + np.conj(b) * a * hm) * scale
    return p, q


def response_table(hf: np.ndarray, tau: float) -> np.ndarray:
    """`split_response` rounded once to float32, (M, 4): P re, P im, Q re,
    Q im for each k."""
    p, q = split_response(hf, tau)
    return np.stack([p.real, p.imag, q.real, q.imag], axis=1).astype(
        np.float32)


def filter_tables(hf: np.ndarray, tau: float, device) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
    """The kernel's tables for the response hf (float64, M + 1 bins) on
    `device`: (twiddles, response), as `filter_rows` takes them."""
    pad = 2 * (np.shape(hf)[0] - 1)
    return (torch.as_tensor(twiddle_table(pad), device=device),
            torch.as_tensor(response_table(hf, tau), device=device))


# -- the plain torch version --------------------------------------------------

def _stockham(z: torch.Tensor, pad: int, tw: torch.Tensor,
              inverse: bool) -> torch.Tensor:
    """DFT_M (unnormalised IDFT_M if `inverse`) of z (..., M) complex64,
    pass by pass as the kernel makes it."""
    m = z.shape[-1]
    off = 0 if not inverse else sum(
        (r - 1) * ns for ns, r in _passes(pad, False) if ns > 1)
    for ns, r in _passes(pad, inverse):
        j = torch.arange(m // r, device=z.device)
        rr = torch.arange(r, device=z.device)
        u = z[..., j[:, None] + rr[None, :] * (m // r)]        # (..., J, R)
        if ns > 1:
            n = (r - 1) * ns
            w = tw[off:off + n].reshape(r - 1, ns)
            off += n
            w = torch.cat([torch.ones_like(w[:1]), w])          # (R, Ns)
            u = u * (w.conj() if inverse else w)[:, j % ns].T
        f = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        f = torch.as_tensor(f.astype(np.complex64), device=z.device)
        u = u @ (f.conj() if inverse else f)
        dst = ((j // ns) * ns * r + j % ns)[:, None] + rr[None, :] * ns
        out = torch.empty_like(z)
        out[..., dst] = u
        z = out
    return z


def filter_rows_torch(proj: torch.Tensor, fcos: torch.Tensor,
                      twiddles: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: proj (B, N_v, N_u) and fcos
    (N_v, N_u) f32, the tables of `filter_tables` -> the filtered rows
    (B, N_v, N_u) f32."""
    m = table.shape[0]
    b, nv, nu = proj.shape
    nz = (nu + 1) // 2
    x = proj * fcos
    x = torch.nn.functional.pad(x, (0, 2 * nz - nu))
    z = torch.zeros((b, nv, m), dtype=torch.complex64, device=proj.device)
    z[..., :nz] = torch.complex(x[..., 0::2], x[..., 1::2])
    tw = torch.view_as_complex(twiddles.reshape(-1, 2).contiguous())
    z = _stockham(z, 2 * m, tw, inverse=False)
    pq = torch.view_as_complex(table.reshape(m, 2, 2).contiguous())
    mirror = (m - torch.arange(m, device=proj.device)) % m
    z = pq[:, 0] * z + pq[:, 1] * z[..., mirror].conj()
    y = _stockham(z, 2 * m, tw, inverse=True)[..., :nz]
    return torch.view_as_real(y).reshape(b, nv, 2 * nz)[..., :nu].contiguous()


# -- the launch ---------------------------------------------------------------

def twiddle_count(pad: int) -> int:
    """Entries of `twiddle_table(pad)`."""
    return sum((r - 1) * ns for inverse in (False, True)
               for ns, r in _passes(pad, inverse) if ns > 1)


def _bound_library() -> ctypes.CDLL:
    global _BOUND
    if _BOUND is not None:
        return _BOUND
    lib = LIBRARY.load()
    lib.rf_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.rf_launch.restype = ctypes.c_int
    lib.rf_twiddle_count.argtypes = [ctypes.c_int]
    lib.rf_twiddle_count.restype = ctypes.c_int
    lib.rf_error_string.argtypes = [ctypes.c_int]
    lib.rf_error_string.restype = ctypes.c_char_p
    listed = {pad: lib.rf_twiddle_count(pad.bit_length() - 1) for pad in PADS}
    want = {pad: twiddle_count(pad) for pad in PADS}
    if listed != want:
        raise RuntimeError(
            f"the filter library's twiddle tables hold {listed} entries by "
            f"pad; kernel.py makes {want}: csrc/filter.cu and kernel.py "
            "disagree")
    _BOUND = lib
    return lib


def _check(proj: torch.Tensor, fcos: torch.Tensor, twiddles: torch.Tensor,
           table: torch.Tensor) -> None:
    if proj.dim() != 3:
        raise ValueError(
            f"proj must be (B, N_v, N_u), got shape {tuple(proj.shape)}")
    b, nv, nu = proj.shape
    m = table.shape[0]
    pad = 2 * m
    if table.shape != (m, 4) or pad not in PADS:
        raise ValueError(
            f"table must be (pad / 2, 4) for a compiled pad {PADS}, got "
            f"{tuple(table.shape)}")
    if nu > m:
        raise ValueError(f"N_u = {nu} exceeds pad / 2 = {m}")
    if tuple(fcos.shape) != (nv, nu):
        raise ValueError(f"fcos must be ({nv}, {nu}), got "
                         f"{tuple(fcos.shape)}")
    if tuple(twiddles.shape) != (twiddle_count(pad), 2):
        raise ValueError(
            f"twiddles must be ({twiddle_count(pad)}, 2) for pad {pad}, got "
            f"{tuple(twiddles.shape)}")
    for name, t in (("proj", proj), ("fcos", fcos), ("twiddles", twiddles),
                    ("table", table)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != proj.device:
            raise ValueError(f"{name} on {t.device}, proj on {proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def filter_rows(proj: torch.Tensor, fcos: torch.Tensor,
                twiddles: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Every row of proj (B, N_v, N_u) on the card weighted by fcos and
    filtered by the tables of `filter_tables`, f32, by the CUDA kernel.
    Raises for a tensor off the card, a pad the kernel is not compiled for,
    operands that are not f32 or not contiguous, and tables that are not
    aligned for the kernel's loads."""
    _check(proj, fcos, twiddles, table)
    if not on_card(proj):
        raise ValueError(f"the filter kernel runs on the card, not on "
                         f"{proj.device}")
    return filter_rows_launch(proj, fcos, twiddles, table)


@torch.library.custom_op("repro_torch::filter_rows_launch", mutates_args=(),
                         device_types="cuda")
def filter_rows_launch(proj: torch.Tensor, fcos: torch.Tensor,
                       twiddles: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """The kernel's launch as a PyTorch operator (checked, contiguous
    operands): the filtered rows, f32. A fake tensor gets the shape from
    the fake implementation below, without the library."""
    lib = _bound_library()
    b, nv, nu = proj.shape
    out = torch.empty(proj.shape, dtype=torch.float32, device=proj.device)
    if out.numel() == 0:
        return out
    if twiddles.data_ptr() % 8 or table.data_ptr() % 16:
        raise ValueError("the twiddle and response tables must start 8- and "
                         "16-byte aligned (filter_tables makes them so)")
    with torch.cuda.device(proj.device):
        stream = torch.cuda.current_stream(proj.device).cuda_stream
        with device_stage("filter.kernel", proj.device):
            rc = lib.rf_launch(proj.data_ptr(),
                               fcos.data_ptr(), twiddles.data_ptr(),
                               table.data_ptr(), out.data_ptr(), b, nv, nu,
                               (2 * table.shape[0]).bit_length() - 1, stream)
    if rc != 0:
        raise RuntimeError(
            f"filter kernel launch failed (B {b}, N_v {nv}, N_u {nu}, pad "
            f"{2 * table.shape[0]}): {lib.rf_error_string(rc).decode()} "
            f"(cudaError {rc})")
    metrics.counter(LAUNCHES).inc()
    metrics.counter(ROWS).inc(b * nv)
    return out


@filter_rows_launch.register_fake
def _(proj, fcos, twiddles, table):
    return proj.new_empty(proj.shape, dtype=torch.float32)
