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
rule in plain torch. The boxes are staged with `RING` more pixels, zero
where they leave the detector, and every gather is clamped into them with
no test: one with no tap on the detector lands on ring zeros. A (tile,
projection) whose boxes exceed the staging buffer is gathered from global
memory inside the same kernel with the same arithmetic; the kernel counts
them on the card.

The launch shape is (tile, staging bytes). The tile is a template
parameter of the kernel, compiled for each of `TILES` (the library lists
them, `tiles()`; the first is the default); the staging budget is a launch
argument. `smem_bytes` is a launch's shared memory and `staging_stats` the
kernel's staging decisions for a launch, both computed here without the
card: the tuner (tune.py) ranks launch shapes with them.

`backproject_dual_torch` is the plain torch version of the same function
with the kernel's coordinate chain (the kernel weights its staged taps as
lerps, a round-off apart); `backproject_dual` takes it only for tensors on
the CPU. For a CUDA tensor it launches the kernel or raises.

The launches count into the default metrics registry (obs/metrics.py):
``kernels.backproject.launches`` every launch. The count of directly
gathered pairs stays on the card unless the tracer is on: then each launch
hands it, with its number of (tile, projection) pairs, to the enclosing
fencing span (`obs.trace.device_count`), which reads it after its wait,
carries both as its ``direct_pairs`` and ``tile_pairs`` args and advances
``kernels.backproject.direct_pairs`` and ``kernels.backproject.tile_pairs``.

The launch is the operator `torch.ops.repro_torch.backproject_dual_launch`
(`backproject_dual_launch`): on fake tensors (a dry run,
`launch/dryrun.py`) its fake implementation gives the output's shape and
launches nothing, and `torch.utils.flop_counter` counts it by
`backproject_ops`.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from ...device import on_card
from ...obs import metrics
from ...obs.trace import device_count
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
    (8, 8, 128), (16, 8, 128), (16, 8, 64), (8, 8, 64))
DEFAULT_TILE = TILES[0]
PREP = 2          # projections whose terms and boxes are made at once
# The default staging budget in Q^T pixels, both buffers (kStagePixels).
STAGE_PIXELS = 52 * 1024
# Zero pixels staged around a footprint box where it meets the detector's
# edge (kRing): the kernel clamps every gather into the box untested.
RING = 2
# f32 operations the back-projection needs (a multiply-add counts 2). Per
# voxel column (i, j) and projection, the Theorem 2/3 invariants: x0, y0,
# z (4 each), 1/z, u = x0/z, w = s/z^2 (2), floor(u), its fraction and
# complement (3), and v(k) = a + b k's a = y0/z and b = p6/z (1 each): 21.
# Per mirrored pair (i, j, k < nz/2) whose gathers touch the detector:
# v(k) (2), the mirror v~ (1), two 4-tap gathers at 14 (floor(v),
# fraction, complement, 4 tap weights, 4 tap products, 3 sums) and two
# weighted accumulates (2 each): 35.
COLUMN_OPS = 21
PAIR_OPS = 35

# The registry counters this module advances (see the module docstring).
LAUNCHES = "kernels.backproject.launches"
TILE_PAIRS = "kernels.backproject.tile_pairs"
DIRECT_PAIRS = "kernels.backproject.direct_pairs"

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
    rows = rhi - rlo + 1 + 2 * RING
    past = (nv + vec) & -vec     # a side off the detector: zero columns
    cf = torch.where(front, (cflo - RING) & -vec, past)
    cm = torch.where(mirror, (cmlo - RING) & -vec, past)
    width = torch.maximum(torch.where(front, cfhi + 1 + RING - cf, 0),
                          torch.where(mirror, cmhi + 1 + RING - cm, 0))
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
    gathered from global memory with the same arithmetic, and counted on
    the card (read at a traced fence, see the module docstring). With 0,
    every projection is gathered so. A launch shape the card refuses (too
    much shared memory) raises."""
    _check(params13, qt, nx, ny, nz)
    t = DEFAULT_TILE if tile is None else tuple(int(x) for x in tile)
    t_index = _tile_index(t)
    if stage_bytes is not None and stage_bytes < 0:
        raise ValueError(f"stage_bytes must be >= 0, got {stage_bytes}")
    if not on_card(qt):
        if qt.device.type == "cpu":
            return backproject_dual_torch(params13, qt, nx, ny, nz)
        raise ValueError(f"no back-projection kernel for device {qt.device}")
    out, direct = backproject_dual_launch(
        params13.contiguous(), qt.contiguous(), nx, ny, nz, t_index,
        -1 if stage_bytes is None else stage_bytes)
    pairs = qt.shape[0] * math.prod(-(-n // d) for n, d in
                                    zip((nx, ny, nz // 2), t))
    device_count("tile_pairs", pairs, TILE_PAIRS)
    if not is_fake(direct):    # a dry run's launch counts nothing
        device_count("direct_pairs", direct, DIRECT_PAIRS)
    return out


@torch.library.custom_op("repro_torch::backproject_dual_launch",
                         mutates_args=(), device_types="cuda")
def backproject_dual_launch(params13: torch.Tensor, qt: torch.Tensor,
                            nx: int, ny: int, nz: int, tile_index: int,
                            stage_bytes: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch as a PyTorch operator (checked, contiguous
    operands; stage_bytes -1 for the source's default): the volume, and
    the count of directly gathered (tile, projection) pairs as a 1-element
    int64 tensor. A fake tensor gets both shapes from the fake
    implementation below, without the library, and a FlopCounterMode the
    count of `backproject_ops`."""
    lib = _bound_library()
    n_p, nu, nv = qt.shape
    out = torch.empty((nx, ny, 2, nz // 2), dtype=torch.float32,
                      device=qt.device)
    count = torch.zeros(1, dtype=torch.int64, device=qt.device)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        rc = lib.bp_dual_launch(params13.data_ptr(), qt.data_ptr(),
                                out.data_ptr(), n_p, nu, nv, nx, ny, nz // 2,
                                WIRE_DTYPES[qt.dtype], tile_index,
                                stage_bytes, count.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"back-projection kernel launch failed (tile "
            f"{TILES[tile_index]}, stage_bytes {stage_bytes}): "
            f"{lib.bp_error_string(rc).decode()} (cudaError {rc})")
    metrics.counter(LAUNCHES).inc()
    return out, count


@backproject_dual_launch.register_fake
def _(params13, qt, nx, ny, nz, tile_index, stage_bytes):
    return (qt.new_empty((nx, ny, 2, nz // 2), dtype=torch.float32),
            qt.new_empty((1,), dtype=torch.int64))


def backproject_ops(n_p: int, nx: int, ny: int, nz: int) -> int:
    """f32 operations of one back-projection, counted as the operations
    bound counts them: COLUMN_OPS per voxel column and projection, and
    PAIR_OPS per mirrored pair (i, j, k < nz/2) and projection. Every pair
    is counted as touching the detector, so this is an upper count: a
    pair whose gathers all fall outside the detector needs only its
    column's terms."""
    return n_p * nx * ny * (COLUMN_OPS + PAIR_OPS * (nz // 2))


@register_flop_formula(torch.ops.repro_torch.backproject_dual_launch)
def _(params13_shape, qt_shape, nx, ny, nz, *args, out_shape=None,
      **kwargs) -> int:
    return backproject_ops(qt_shape[0], nx, ny, nz)
