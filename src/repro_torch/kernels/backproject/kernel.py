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
tile of columns x k, loops over every projection with its accumulators in
registers (each output element written once, no atomics, a fixed and
deterministic summation order), and gathers the taps from the footprint
boxes of Q^T that it stages in shared memory. `footprint_boxes` is that
rule in plain torch. A (tile, projection) whose boxes exceed the staging
buffer is gathered from global memory inside the same kernel with the same
arithmetic; `direct_pairs` counts them.

The launch shape is (tile, staging bytes). The tile is a template
parameter of the kernel, compiled for each of `TILES` (the library lists
them, `tiles()`; the first is the default); the staging budget is a launch
argument. `smem_bytes` is a launch's shared memory and `staging_stats` the
kernel's staging decisions for a launch, both computed here without the
card: the tuner (tune.py) ranks launch shapes with them.

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

# The compiled tiles, (columns along i, along j, values of k), in the order
# of the CUDA source's kTiles; the first is the default. `_bound_library`
# checks the library's listing against this one.
TILES: Tuple[Tuple[int, int, int], ...] = (
    (8, 8, 64), (8, 8, 32), (16, 8, 32), (4, 8, 64))
DEFAULT_TILE = TILES[0]
WARPS = 8         # warps per block (kWarps)
PREP = 2          # projections whose terms and boxes are made at once
# The default staging budget in Q^T pixels, both buffers (kStagePixels).
STAGE_PIXELS = 26 * 1024

launches = 0  # kernel launches by backproject_dual (never by the plain path)
# (tile, projection) pairs of the last launch whose boxes exceeded the
# staging buffer and were gathered from global memory, as a 1-element
# int64 tensor on the card (read it after a synchronize), and all pairs.
direct_pairs: Optional[torch.Tensor] = None
tile_pairs = 0

_BOUND: Optional[ctypes.CDLL] = None


def _bound_library() -> ctypes.CDLL:
    global _BOUND
    if _BOUND is not None:
        return _BOUND
    lib = LIBRARY.load()
    lib.bp_dual_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2)
    lib.bp_dual_launch.restype = ctypes.c_int
    lib.bp_error_string.argtypes = [ctypes.c_int]
    lib.bp_error_string.restype = ctypes.c_char_p
    lib.bp_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bp_tiles.restype = ctypes.c_int
    lib.bp_stage_pixels.argtypes = []
    lib.bp_stage_pixels.restype = ctypes.c_int
    lib.bp_smem_optin.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.bp_smem_optin.restype = ctypes.c_int
    lib.bp_static_smem.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int)]
    lib.bp_static_smem.restype = ctypes.c_int
    out = (ctypes.c_int * (3 * 16))()
    n = lib.bp_tiles(out)
    listed = tuple(tuple(out[3 * t:3 * t + 3]) for t in range(n))
    if listed != TILES or lib.bp_stage_pixels() != STAGE_PIXELS:
        raise RuntimeError(
            f"the back-projection library compiles tiles {listed} and "
            f"stages {lib.bp_stage_pixels()} pixels; kernel.py expects "
            f"{TILES} and {STAGE_PIXELS}: csrc/backproject.cu and kernel.py "
            "disagree")
    _BOUND = lib
    return lib


def _call(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"back-projection library call {fn.__name__} failed: "
            f"{_bound_library().bp_error_string(rc).decode()} "
            f"(cudaError {rc})")


def tiles() -> Tuple[Tuple[int, int, int], ...]:
    """The compiled tiles as the library lists them (builds it)."""
    _bound_library()
    return TILES


def tile() -> Tuple[int, int, int]:
    """The default tile: (i, j) columns x k values of the dual slab."""
    return tiles()[0]


def _tile_index(t) -> int:
    t = tuple(int(x) for x in t)
    if t not in TILES:
        raise ValueError(
            f"tile {t} is not compiled; the kernel's tiles are {TILES}")
    return TILES.index(t)


def default_stage_bytes(dtype: torch.dtype) -> int:
    """The kernel's default staging budget for a wire dtype, in bytes."""
    return STAGE_PIXELS * dtype.itemsize


def static_smem_bytes(t) -> int:
    """Static shared memory of a tile's kernel: the column-term tables
    (a float4 and an int per column, 2 x PREP projections) and the boxes
    (32 bytes, 2 x PREP); `compiled_static_smem` reads it on the card."""
    cols = t[0] * t[1]
    return 2 * PREP * (cols * 20 + 32)


def _buf_elems(stage_bytes: int, itemsize: int) -> int:
    """Elements per staging buffer: two buffers, each 16-byte aligned."""
    return stage_bytes // 2 // 16 * 16 // itemsize


def smem_bytes(t, stage_bytes: Optional[int], dtype: torch.dtype) -> int:
    """Shared memory of one block of a launch: the tile's static tables
    plus the two staging buffers (`stage_bytes` None: the default)."""
    if stage_bytes is None:
        stage_bytes = default_stage_bytes(dtype)
    return (static_smem_bytes(t)
            + 2 * _buf_elems(stage_bytes, dtype.itemsize) * dtype.itemsize)


def compiled_static_smem(dtype: torch.dtype, t) -> int:
    """The static shared memory the compiler gave the (dtype, tile) kernel
    (cudaFuncGetAttributes; builds the library)."""
    out = ctypes.c_int()
    lib = _bound_library()
    _call(lib.bp_static_smem, WIRE_DTYPES[dtype], _tile_index(t),
          ctypes.byref(out))
    return out.value


def smem_optin(device: torch.device) -> int:
    """The largest shared memory a block may opt in to on the card
    (cudaDevAttrMaxSharedMemoryPerBlockOptin; builds the library)."""
    out = ctypes.c_int()
    lib = _bound_library()
    _call(lib.bp_smem_optin, torch.device(device).index or 0,
          ctypes.byref(out))
    return out.value


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


def _corner_terms(p: torch.Tensor, i, j, k):
    """u, v and z of the kernel's f32 chain at voxel (i, j, k) for every
    parameter row of `p`; i, j, k are ints or integer-valued f32 tensors
    that broadcast against p[:, :1]."""
    x0 = p[:, 0:1] * i + p[:, 1:2] * j + p[:, 3:4]
    y0 = p[:, 4:5] * i + p[:, 5:6] * j + p[:, 7:8]
    z = p[:, 8:9] * i + p[:, 9:10] * j + p[:, 11:12]
    f = 1.0 / z
    return x0 * f, (y0 + p[:, 6:7] * k) * f, z


def _box_range(xmin, xmax, n):
    """Inclusive [lo, hi] of the pixels taps in [xmin, xmax] read, with a
    pixel of margin, clipped to [0, n) (lo > hi: empty)."""
    a = (torch.floor(xmin) - 1).clamp(0, n)
    b = (torch.floor(xmax) + 2).clamp(-1, n - 1)
    return a.to(torch.int64), b.to(torch.int64)


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
    corners = [_corner_terms(p, float(a), float(b), float(c))
               for a in (lo[0], hi[0]) for b in (lo[1], hi[1])
               for c in (lo[2], hi[2])]
    u, v, z = (torch.cat(t, dim=1) for t in zip(*corners))
    vmax = float(nv - 1)
    rows = _box_range(u.amin(1), u.amax(1), nu)
    front = _box_range(v.amin(1), v.amax(1), nv)
    mirror = _box_range(vmax - v.amax(1), vmax - v.amin(1), nv)
    return (torch.stack([*rows, *front, *mirror], dim=1),
            (z > 0).all(dim=1))


def _edges(n: int, t: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """First and last index of each tile of width t along an axis of n."""
    lo = torch.arange(0, n, t, device=device)
    return lo, torch.clamp(lo + t - 1, max=n - 1)


def copy_elems(nv: int, dtype: torch.dtype) -> int:
    """Elements per staging copy: the widest of 16, 8 and 4 bytes that
    divides a Q^T row (the tensor's start is 16-byte aligned), else 1."""
    row = nv * dtype.itemsize
    for b in (16, 8, 4):
        if row % b == 0:
            return b // dtype.itemsize
    return 1


def staging_stats(params13: torch.Tensor, nu: int, nv: int,
                  nx: int, ny: int, nzh: int, t,
                  stage_bytes: Optional[int], dtype: torch.dtype) -> dict:
    """The kernel's staging decisions for one launch, over every (tile,
    projection) pair of the projections in `params13`: `direct` (gathered
    from global memory: the boxes exceed a staging buffer, or z changes
    sign over the tile; the kernel's `direct_pairs`), `staged` (boxes
    copied to shared memory), `empty` (no tap on the detector), `pairs`
    (all of them), `staged_bytes` (bytes the staged pairs copy, ring and
    alignment included), `voxel_pairs` (mirrored voxel pairs of the
    direct and staged (tile, projection)s) and `direct_voxel_pairs`.

    The same rule as the kernel's `prepare` and `footprint_boxes`, made
    for all tiles at once from the tile corners' f32 coordinates, 32
    projections at a time. Q^T's start is taken to be 16-byte aligned, as
    torch allocates it."""
    if stage_bytes is None:
        stage_bytes = default_stage_bytes(dtype)
    p = params13.to(torch.float32)
    out: dict = {}
    for lo in range(0, p.shape[0], 32):
        part = _staging_chunk(p[lo:lo + 32], nu, nv, nx, ny, nzh,
                              tuple(int(x) for x in t),
                              _buf_elems(stage_bytes, dtype.itemsize),
                              copy_elems(nv, dtype), dtype.itemsize)
        for key, val in part.items():
            out[key] = out.get(key, 0) + val
    return out


def _staging_chunk(p, nu, nv, nx, ny, nzh, t, buf, vec, itemsize) -> dict:
    ti, tj, tk = t
    dev = p.device
    i_lo, i_hi = _edges(nx, ti, dev)
    j_lo, j_hi = _edges(ny, tj, dev)
    k_lo, k_hi = _edges(nzh, tk, dev)
    # corner coordinates, (Np, i corner, j corner [, k corner]) with each
    # corner axis holding (tile lo edges, tile hi edges)
    ic = torch.stack([i_lo, i_hi], 1).reshape(1, -1, 1).float()
    jc = torch.stack([j_lo, j_hi], 1).reshape(1, 1, -1).float()
    kc = torch.stack([k_lo, k_hi], 1).reshape(1, 1, 1, -1).float()
    ni, nj, nk = len(i_lo), len(j_lo), len(k_lo)
    pp = p[:, :, None, None]

    def chain(q):
        x0 = q[:, 0] * ic + q[:, 1] * jc + q[:, 3]
        y0 = q[:, 4] * ic + q[:, 5] * jc + q[:, 7]
        z = q[:, 8] * ic + q[:, 9] * jc + q[:, 11]
        f = 1.0 / z
        v = (y0[..., None] + q[:, 6, ..., None] * kc) * f[..., None]
        return x0 * f, v, z

    u, v, z = chain(pp)

    def over_ij(x, red):   # (Np, 2ni, 2nj[, ...]) -> (Np, ni, nj[, ...])
        x = x.reshape((x.shape[0], ni, 2, nj, 2) + x.shape[3:])
        return red(red(x, 2), 3)

    def amin(x, d):
        return x.amin(d)

    def amax(x, d):
        return x.amax(d)

    umin, umax = over_ij(u, amin), over_ij(u, amax)
    zpos = over_ij(z > 0, lambda x, d: x.all(d))
    vk = v.reshape(v.shape[:3] + (nk, 2))
    vmin, vmx = over_ij(vk.amin(-1), amin), over_ij(vk.amax(-1), amax)
    vmaxd = float(nv - 1)
    rlo, rhi = _box_range(umin, umax, nu)
    cflo, cfhi = _box_range(vmin, vmx, nv)
    cmlo, cmhi = _box_range(vmaxd - vmx, vmaxd - vmin, nv)
    rlo, rhi, zpos = rlo[..., None], rhi[..., None], zpos[..., None]
    front, mirror = cflo <= cfhi, cmlo <= cmhi
    nonempty = (rlo <= rhi) & (front | mirror)
    rows = rhi - rlo + 3
    cf, cm = (cflo - 1) & -vec, (cmlo - 1) & -vec
    width = torch.maximum(torch.where(front, cfhi + 2 - cf, 0),
                          torch.where(mirror, cmhi + 2 - cm, 0))
    pitch = (width + vec - 1) & -vec
    fits = 2 * rows * pitch <= buf
    direct = ~zpos | (nonempty & ~fits)
    staged = zpos & nonempty & fits
    nvox = ((i_hi - i_lo + 1)[:, None, None] * (j_hi - j_lo + 1)[None, :, None]
            * (k_hi - k_lo + 1)[None, None, :])
    return {
        "direct": int(direct.sum()),
        "staged": int(staged.sum()),
        "empty": int((~direct & ~staged).sum()),
        "pairs": int(direct.numel()),
        "staged_bytes": int(torch.where(staged, 2 * rows * pitch, 0).sum())
        * itemsize,
        "voxel_pairs": int(((direct | staged) * nvox).sum()),
        "direct_voxel_pairs": int((direct * nvox).sum()),
    }


def backproject_dual(params13: torch.Tensor, qt: torch.Tensor,
                     nx: int, ny: int, nz: int,
                     tile: Optional[Tuple[int, int, int]] = None,
                     stage_bytes: Optional[int] = None) -> torch.Tensor:
    """Dual-slab back-projection: the CUDA kernel for tensors on the card,
    the plain torch version for tensors on the CPU.

    `tile` is one of `TILES` (None: the default, TILES[0]). `stage_bytes`
    is the kernel's shared-memory staging budget (None: the CUDA source's
    default); a (tile, projection) whose boxes exceed half of it is
    gathered from global memory with the same arithmetic, and counted in
    `direct_pairs`. With 0, every projection is gathered so. A launch
    shape the card refuses (too much shared memory) raises."""
    _check(params13, qt, nx, ny, nz)
    t = DEFAULT_TILE if tile is None else tuple(int(x) for x in tile)
    t_index = _tile_index(t)
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
                                WIRE_DTYPES[qt.dtype], t_index,
                                -1 if stage_bytes is None else stage_bytes,
                                count.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"back-projection kernel launch failed (tile {t}, stage_bytes "
            f"{stage_bytes}): {lib.bp_error_string(rc).decode()} "
            f"(cudaError {rc})")
    launches += 1
    direct_pairs = count
    tile_pairs = n_p * math.prod(-(-n // d) for n, d in
                                 zip((nx, ny, nz // 2), t))
    return out
