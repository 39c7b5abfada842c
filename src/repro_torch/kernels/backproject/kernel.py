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
design does about that is noted at the top of that source: a block owns a
tile of columns x k (`tile()`), loops over every projection with its
accumulators in registers (each output element written once, no atomics,
a fixed and deterministic summation order), and gathers the taps from
the footprint boxes of Q^T that it stages in shared memory.
`footprint_boxes` is that rule in plain torch. A (tile, projection) whose
boxes exceed the staging buffer is gathered from global memory inside the
same kernel with the same arithmetic; `direct_pairs` counts them.

`backproject_dual_torch` is the plain torch version of the same function
with the kernel's arithmetic in the kernel's order; `backproject_dual`
takes it only for tensors on the CPU. For a CUDA tensor it launches the
kernel or raises. `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

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
# (tile, projection) pairs of the last launch whose boxes exceeded the
# staging buffer and were gathered from global memory, as a 1-element
# int64 tensor on the card (read it after a synchronize), and all pairs.
direct_pairs: Optional[torch.Tensor] = None
tile_pairs = 0


def _bound_library() -> ctypes.CDLL:
    lib = LIBRARY.load()
    lib.bp_dual_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)
    lib.bp_dual_launch.restype = ctypes.c_int
    lib.bp_error_string.argtypes = [ctypes.c_int]
    lib.bp_error_string.restype = ctypes.c_char_p
    lib.bp_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bp_tile.restype = None
    return lib


def tile() -> Tuple[int, int, int]:
    """The kernel's block: a tile of (i, j) columns x k values of the dual
    slab, as the CUDA source defines it (builds the library)."""
    out = (ctypes.c_int * 3)()
    _bound_library().bp_tile(out)
    return tuple(out)


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


def footprint_boxes(params13: torch.Tensor, nu: int, nv: int,
                    lo: Tuple[int, int, int], hi: Tuple[int, int, int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The footprint rule: which Q^T pixels the gathers of a block of voxel
    pairs can read, per projection.

    The block is [lo, hi] (inclusive (i, j, k), k < nz/2). u and v are
    ratios of affine functions of (i, j, k) whose denominator z keeps its
    sign over the block, so their extremes lie at its 8 corners; a pair's
    taps lie in [floor(x), floor(x) + 1] on each axis. With one pixel of
    margin, clipped to the detector: rows [floor(u_min) - 1, floor(u_max) +
    2], front columns likewise from v, mirror columns from (N_v - 1) - v.
    The corner coordinates are the kernel's own f32 chain (the plain
    version's arithmetic), so the kernel computes the same boxes.

    Returns int64 (Np, 6): rows, front columns, mirror columns, each as an
    inclusive [lo, hi] (lo > hi: empty); and bool (Np,): z > 0 at every
    corner (where it is not, the rule does not hold).
    """
    p = params13.to(torch.float32)
    corners = [(a, b, c) for a in (lo[0], hi[0]) for b in (lo[1], hi[1])
               for c in (lo[2], hi[2])]
    us, vs, zs = [], [], []
    for i, j, k in corners:
        x0 = p[:, 0] * float(i) + p[:, 1] * float(j) + p[:, 3]
        y0 = p[:, 4] * float(i) + p[:, 5] * float(j) + p[:, 7]
        z = p[:, 8] * float(i) + p[:, 9] * float(j) + p[:, 11]
        f = 1.0 / z
        us.append(x0 * f)
        vs.append((y0 + p[:, 6] * float(k)) * f)
        zs.append(z)
    u, v, z = (torch.stack(t) for t in (us, vs, zs))
    vmax = float(nv - 1)

    def rng(xmin, xmax, n):
        a = (torch.floor(xmin) - 1).clamp(0, n)
        b = (torch.floor(xmax) + 2).clamp(-1, n - 1)
        return a.to(torch.int64), b.to(torch.int64)

    rows = rng(u.amin(0), u.amax(0), nu)
    front = rng(v.amin(0), v.amax(0), nv)
    mirror = rng(vmax - v.amax(0), vmax - v.amin(0), nv)
    return (torch.stack([*rows, *front, *mirror], dim=1),
            (z > 0).all(dim=0))


def backproject_dual(params13: torch.Tensor, qt: torch.Tensor,
                     nx: int, ny: int, nz: int,
                     stage_bytes: Optional[int] = None) -> torch.Tensor:
    """Dual-slab back-projection: the CUDA kernel for tensors on the card,
    the plain torch version for tensors on the CPU.

    `stage_bytes` is the kernel's shared-memory staging budget (default:
    the CUDA source's); a (tile, projection) whose boxes exceed half of it
    is gathered from global memory with the same arithmetic, and counted
    in `direct_pairs`. With 0, every projection is gathered so."""
    _check(params13, qt, nx, ny, nz)
    if stage_bytes is not None and stage_bytes < 0:
        raise ValueError(f"stage_bytes must be >= 0, got {stage_bytes}")
    if qt.device.type == "cpu":
        return backproject_dual_torch(params13, qt, nx, ny, nz)
    if qt.device.type != "cuda":
        raise ValueError(f"no back-projection kernel for device {qt.device}")
    global launches, direct_pairs, tile_pairs
    lib = _bound_library()
    params13 = params13.contiguous()
    qt = qt.contiguous()
    n_p, nu, nv = qt.shape
    out = torch.empty((nx, ny, 2, nz // 2), dtype=torch.float32,
                      device=qt.device)
    count = torch.zeros(1, dtype=torch.int64, device=qt.device)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        rc = lib.bp_dual_launch(params13.data_ptr(), qt.data_ptr(),
                                out.data_ptr(), n_p, nu, nv, nx, ny, nz // 2,
                                WIRE_DTYPES[qt.dtype],
                                -1 if stage_bytes is None else stage_bytes,
                                count.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"back-projection kernel launch failed: "
            f"{lib.bp_error_string(rc).decode()} (cudaError {rc})")
    launches += 1
    direct_pairs = count
    tile_pairs = n_p * math.prod(-(-n // t) for n, t in
                                 zip((nx, ny, nz // 2), tile()))
    return out
