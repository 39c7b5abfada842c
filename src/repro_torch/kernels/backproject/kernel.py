"""Hand-written CUDA back-projection kernel for Hopper, its plain torch
version, and the launch wrapper.

Replaces the Pallas TPU kernel `_bp_kernel` of
`repro/kernels/backproject/kernel.py` (launched there by
`backproject_dual_pallas`): the iFDK factorized back-projection (Theorems
1-3) into the dual-slab volume (nx, ny, 2, nz/2), from transposed
projections Q^T (Np, Nu, Nv) in any wire dtype (f32, bf16, fp16, fp8 e4m3,
fp8 e5m2) and (Np, 13) f32 parameter rows (the 3x4 matrix plus the stream
codec's decode scale in column 12). Taps are upcast to f32 at the gather
and accumulation is f32.

The kernel is `csrc/backproject.cu` (CUDA C++ for sm_90a, plain C
interface, loaded with ctypes). What bounds it on an H100 and what its
design does about that is noted at the top of that source: one thread per
mirrored voxel pair loops over every projection with both accumulators in
registers, so each output element is written once, with no atomics and a
fixed (deterministic) summation order.

`backproject_dual_torch` is the plain torch version of the same function
with the kernel's arithmetic in the kernel's order; `backproject_dual`
takes it only for tensors on the CPU. For a CUDA tensor it launches the
kernel or raises. `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary

LIBRARY = CudaLibrary(
    "backproject", [Path(__file__).parent / "csrc" / "backproject.cu"])

# Codes of the C entry point's `wire_dtype` argument.
WIRE_DTYPES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.float8_e4m3fn: 3,
    torch.float8_e5m2: 4,
}

launches = 0  # kernel launches by backproject_dual (never by the plain path)


def _bound_library() -> ctypes.CDLL:
    lib = LIBRARY.load()
    lib.bp_dual_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.bp_dual_launch.restype = ctypes.c_int
    lib.bp_error_string.argtypes = [ctypes.c_int]
    lib.bp_error_string.restype = ctypes.c_char_p
    return lib


def _check(params13: torch.Tensor, qt: torch.Tensor,
           nx: int, ny: int, nz: int) -> None:
    if qt.dim() != 3:
        raise ValueError(f"qt must be (Np, Nu, Nv), got shape {tuple(qt.shape)}")
    if qt.dtype not in WIRE_DTYPES:
        raise ValueError(f"unsupported wire dtype {qt.dtype}; "
                         f"choose from {list(WIRE_DTYPES)}")
    n_p = qt.shape[0]
    if params13.shape != (n_p, 13) or params13.dtype != torch.float32:
        raise ValueError(
            f"params13 must be ({n_p}, 13) float32, got "
            f"{tuple(params13.shape)} {params13.dtype}")
    if params13.device != qt.device:
        raise ValueError(f"params13 on {params13.device}, qt on {qt.device}")
    if nz % 2 or min(nx, ny, nz) < 1:
        raise ValueError(
            f"volume ({nx}, {ny}, {nz}) must be positive with even nz "
            "(dual-slab layout)")


def _bilinear_flat(qflat: torch.Tensor, nu: int, nv: int,
                   rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """4-tap zero-outside bilinear gather from the flattened (nu*nv,)
    projection, in the kernel's operation order."""
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    dr = rows - r0
    dc = cols - c0
    r0i = r0.to(torch.int64)
    c0i = c0.to(torch.int64)

    def tap(ri, ci, wgt):
        valid = (ri >= 0) & (ri < nu) & (ci >= 0) & (ci < nv)
        idx = ri.clamp(0, nu - 1) * nv + ci.clamp(0, nv - 1)
        return torch.where(valid, qflat[idx].to(torch.float32) * wgt, 0.0)

    return (
        tap(r0i, c0i, (1 - dr) * (1 - dc))
        + tap(r0i, c0i + 1, (1 - dr) * dc)
        + tap(r0i + 1, c0i, dr * (1 - dc))
        + tap(r0i + 1, c0i + 1, dr * dc)
    )


def backproject_dual_torch(params13: torch.Tensor, qt: torch.Tensor,
                           nx: int, ny: int, nz: int) -> torch.Tensor:
    """Plain torch version of the kernel: params13 (Np, 13) f32, qt
    (Np, Nu, Nv) in any wire dtype -> dual-slab volume (nx, ny, 2, nz/2)."""
    _check(params13, qt, nx, ny, nz)
    dev = qt.device
    n_p, nu, nv = qt.shape
    nzh = nz // 2
    i = torch.arange(nx, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(ny, dtype=torch.float32, device=dev)[None, :]
    k = torch.arange(nzh, dtype=torch.float32, device=dev)
    vmax = float(nv - 1)
    acc_f = torch.zeros((nx, ny, nzh), dtype=torch.float32, device=dev)
    acc_b = torch.zeros_like(acc_f)
    rows = params13.cpu().tolist()   # exact f32 values as Python floats
    for s in range(n_p):
        p = rows[s]
        qflat = qt[s].reshape(-1)
        x0 = p[0] * i + p[1] * j + p[3]
        y0 = p[4] * i + p[5] * j + p[7]
        z = p[8] * i + p[9] * j + p[11]
        f = 1.0 / z
        u = (x0 * f)[..., None]
        w = (f * f * p[12])[..., None]
        v = (y0[..., None] + p[6] * k) * f[..., None]
        acc_f += w * _bilinear_flat(qflat, nu, nv, u, v)
        acc_b += w * _bilinear_flat(qflat, nu, nv, u, vmax - v)
    return torch.stack([acc_f, acc_b], dim=-2)


def backproject_dual(params13: torch.Tensor, qt: torch.Tensor,
                     nx: int, ny: int, nz: int) -> torch.Tensor:
    """Dual-slab back-projection: the CUDA kernel for tensors on the card,
    the plain torch version for tensors on the CPU."""
    _check(params13, qt, nx, ny, nz)
    if qt.device.type == "cpu":
        return backproject_dual_torch(params13, qt, nx, ny, nz)
    if qt.device.type != "cuda":
        raise ValueError(f"no back-projection kernel for device {qt.device}")
    global launches
    lib = _bound_library()
    params13 = params13.contiguous()
    qt = qt.contiguous()
    n_p, nu, nv = qt.shape
    out = torch.empty((nx, ny, 2, nz // 2), dtype=torch.float32,
                      device=qt.device)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        rc = lib.bp_dual_launch(params13.data_ptr(), qt.data_ptr(),
                                out.data_ptr(), n_p, nu, nv, nx, ny, nz // 2,
                                WIRE_DTYPES[qt.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"back-projection kernel launch failed: "
            f"{lib.bp_error_string(rc).decode()} (cudaError {rc})")
    launches += 1
    return out
