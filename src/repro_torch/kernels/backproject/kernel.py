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
rule in plain torch. Where a box meets the detector's edge it is staged
with `RING` more pixels, zeros, and every gather is clamped into the
boxes with no test: one with no tap on the detector lands on ring zeros.
Front and mirror boxes that lie side by side are staged as one, a copy a
row. A (tile, projection) whose boxes, ringed on every side at one pitch,
exceed half the staging budget is gathered from global memory inside the
same kernel with the same arithmetic; the kernel counts them on the
card.

The staged projections flow through a ring of `records(tile)` stages
with no block-wide barrier: each stage holds one projection's column
terms and boxes, a warp waits only for the stage it gathers next, and the
warps take turns making the stages ahead. Each projection's pixels are
placed in the staging right after the previous one's, wrapping to its
start, and copied once every warp is done with what was there, so the
copies run as many steps ahead as the staging holds boxes (`ring_depths`
computes each block's depth).

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
``kernels.backproject.launches`` every launch. The kernel's two counts,
the directly gathered (tile, projection) pairs and the ring waits (the
(warp, projection) steps at which a warp found its stage not yet full),
stay on the card unless the tracer is on: then each launch hands them,
with its number of (tile, projection) pairs, to the enclosing fencing
span (`obs.trace.device_count`), which reads them after its wait, carries
them as its ``direct_pairs``, ``ring_waits`` and ``tile_pairs`` args and
advances ``kernels.backproject.direct_pairs``, ``.ring_waits`` and
``.tile_pairs``.

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
# The default staging budget in Q^T pixels, all slots (kStagePixels).
STAGE_PIXELS = 52 * 1024
# Stage records a tile's kernel keeps (kMaxRecords, kSmemOptin): as many
# as fit beside the default f32 staging in an H100 block's 227 KiB; a
# record's table is made RECORDS - 1 steps ahead of its gathers.
MAX_RECORDS = 8
SMEM_OPTIN = 232_448
TILE_BYTES = 48   # the block's shared launch values (kTileBytes)
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
RING_WAITS = "kernels.backproject.ring_waits"

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


def _record_bytes(t) -> int:
    """A stage record (a float4 and an int per column, the 32-byte boxes,
    the place of its pixels) and its two barriers."""
    return 20 * t[0] * t[1] + 64


def records(t) -> int:
    """Stage records of a tile's kernel (the CUDA source's `records`)."""
    return min(MAX_RECORDS, (SMEM_OPTIN - 4 * STAGE_PIXELS - TILE_BYTES)
               // _record_bytes(t))


def static_smem_bytes(t) -> int:
    """Static shared memory of a tile's kernel: its stage records and the
    block's launch values; `compiled_static_smem` reads it on the card."""
    return records(t) * _record_bytes(t) + TILE_BYTES


def _buf_elems(stage_bytes: int, itemsize: int) -> int:
    """Elements in half the staging budget, a multiple of 16 bytes: the
    largest box the kernel stages."""
    return stage_bytes // 2 // 16 * 16 // itemsize


def smem_bytes(t, stage_bytes: Optional[int], dtype: torch.dtype) -> int:
    """Shared memory of one block of a launch: the tile's static records
    plus the staging (`stage_bytes` None: the default)."""
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
    from global memory: the two boxes, ringed on every side at one pitch,
    exceed half the staging budget, or z changes sign over the tile; the
    kernel's `direct_pairs`), `staged` (boxes copied to shared memory),
    `empty` (no tap on the detector), `pairs` (all of them),
    `staged_bytes` (bytes of the staged boxes, ring and alignment
    included), `voxel_pairs` (mirrored voxel pairs of the direct and
    staged (tile, projection)s) and `direct_voxel_pairs`.

    The same rule as the kernel's `footprint` and `footprint_boxes`, made
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


def ring_depths(params13: torch.Tensor, nu: int, nv: int,
                nx: int, ny: int, nzh: int, t,
                stage_bytes: Optional[int], dtype: torch.dtype
                ) -> torch.Tensor:
    """The depth of each block's ring, int64 (tiles along i, j, k): how
    many steps ahead of its gathers the block's copies are issued at
    worst, over its staged projections. The kernel's placement, replayed:
    projection p's pixels (16-byte units) go right after p - 1's, or at
    the start of the staging where they would pass its end; they are
    copied at the end of the step of the newest projection whose pixels
    overlap them, or of p - (records - 2), when its table is made,
    whichever is later. A block with no staged projection reads
    records - 2. From the same boxes as `staging_stats`."""
    if stage_bytes is None:
        stage_bytes = default_stage_bytes(dtype)
    p = params13.to(torch.float32)
    t = tuple(int(x) for x in t)
    buf = _buf_elems(stage_bytes, dtype.itemsize)
    gran = max(16 // dtype.itemsize, 1)
    sizes = []
    for lo in range(0, p.shape[0], 32):
        b = _chunk_boxes(p[lo:lo + 32], nu, nv, nx, ny, nzh, t, buf,
                         copy_elems(nv, dtype))
        sizes.append(torch.where(b["staged"], (b["elems"] + gran - 1)
                                 // gran * gran, 0))
    size = torch.cat(sizes)
    shape = size.shape[1:]
    size = size.reshape(size.shape[0], -1)
    rec = records(t)
    lead = torch.full(size.shape[1:], rec - 2, dtype=torch.int64)
    end = torch.zeros_like(lead)
    offs, sizes = [], []
    for q in range(size.shape[0]):
        n = size[q]
        off = torch.where(end + n > 2 * buf, 0, end)
        wait = torch.full_like(lead, q - rec)
        found = n == 0
        for o in range(q - 1, max(q - rec, -1), -1):
            hit = ~found & (sizes[o] > 0) & (offs[o] < off + n) \
                & (off < offs[o] + sizes[o])
            wait = torch.where(hit, o, wait)
            found = found | hit
        ahead = q - torch.clamp(wait, min=q - (rec - 2))
        lead = torch.where(n > 0, torch.minimum(lead, ahead), lead)
        offs.append(off)
        sizes.append(n)
        end = off + n
    return lead.reshape(shape)


def _staging_chunk(p, nu, nv, nx, ny, nzh, t, buf, vec, itemsize) -> dict:
    b = _chunk_boxes(p, nu, nv, nx, ny, nzh, t, buf, vec)
    direct, staged, nvox = b["direct"], b["staged"], b["nvox"]
    return {
        "direct": int(direct.sum()),
        "staged": int(staged.sum()),
        "empty": int((~direct & ~staged).sum()),
        "pairs": int(direct.numel()),
        "staged_bytes": int(torch.where(staged, b["elems"], 0).sum())
        * itemsize,
        "voxel_pairs": int(((direct | staged) * nvox).sum()),
        "direct_voxel_pairs": int((direct * nvox).sum()),
    }


def _chunk_boxes(p, nu, nv, nx, ny, nzh, t, buf, vec) -> dict:
    """The kernel's decisions for projections `p` on every tile: bool
    (Np, tiles along i, j, k) `direct` and `staged`, the staged elements
    of both boxes `elems` (2 rows x pitch), and the voxel pairs of each
    tile `nvox`."""
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
    # what is staged: both boxes with the ring on every side, at one
    # pitch, no larger than half the budget
    rows = rhi - rlo + 1 + 2 * RING
    width = torch.maximum(
        torch.where(front, cfhi + 1 + RING - ((cflo - RING) & -vec), 0),
        torch.where(mirror, cmhi + 1 + RING - ((cmlo - RING) & -vec), 0))
    fits = 2 * rows * ((width + vec - 1) & -vec) <= buf
    direct = ~zpos | (nonempty & ~fits)
    staged = zpos & nonempty & fits
    # the staged box: the ring only where it meets the detector's edge, a
    # side off the detector staged from zero columns past it, and one box
    # for both where it is no wider than the two
    rows = (rhi + torch.where(rhi == nu - 1, RING, 0) + 1
            - (rlo - torch.where(rlo == 0, RING, 0)))
    past = (nv + vec) & -vec

    def first(c):
        return (c - torch.where(c == 0, RING, 0)) & -vec

    def end(c):
        return c + 1 + torch.where(c == nv - 1, RING, 0)

    cf = torch.where(front, first(cflo), past)
    cm = torch.where(mirror, first(cmlo), past)
    wf = torch.where(front, end(cfhi) - cf, 0)
    wm = torch.where(mirror, end(cmhi) - cm, 0)
    pitch = (torch.maximum(wf, wm) + vec - 1) & -vec
    both = (torch.maximum(cf + wf, cm + wm) - torch.minimum(cf, cm) + vec
            - 1) & -vec
    one = front & mirror & (both <= 2 * pitch)
    elems = torch.where(one, rows * both, 2 * rows * pitch)
    nvox = ((i_hi - i_lo + 1)[:, None, None] * (j_hi - j_lo + 1)[None, :, None]
            * (k_hi - k_lo + 1)[None, None, :])
    return {"direct": direct, "staged": staged, "elems": elems, "nvox": nvox}


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
    the card, as are the ring's waits (both read at a traced fence, see
    the module docstring). With 0, every projection is gathered so. A
    launch shape the card refuses (too much shared memory) raises."""
    _check(params13, qt, nx, ny, nz)
    t = DEFAULT_TILE if tile is None else tuple(int(x) for x in tile)
    t_index = _tile_index(t)
    if stage_bytes is not None and stage_bytes < 0:
        raise ValueError(f"stage_bytes must be >= 0, got {stage_bytes}")
    if not on_card(qt):
        if qt.device.type == "cpu":
            return backproject_dual_torch(params13, qt, nx, ny, nz)
        raise ValueError(f"no back-projection kernel for device {qt.device}")
    out, counts = backproject_dual_launch(
        params13.contiguous(), qt.contiguous(), nx, ny, nz, t_index,
        -1 if stage_bytes is None else stage_bytes)
    pairs = qt.shape[0] * math.prod(-(-n // d) for n, d in
                                    zip((nx, ny, nz // 2), t))
    device_count("tile_pairs", pairs, TILE_PAIRS)
    if not is_fake(counts):    # a dry run's launch counts nothing
        device_count("direct_pairs", counts[:1], DIRECT_PAIRS)
        device_count("ring_waits", counts[1:], RING_WAITS)
    return out


@torch.library.custom_op("repro_torch::backproject_dual_launch",
                         mutates_args=(), device_types="cuda")
def backproject_dual_launch(params13: torch.Tensor, qt: torch.Tensor,
                            nx: int, ny: int, nz: int, tile_index: int,
                            stage_bytes: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch as a PyTorch operator (checked, contiguous
    operands; stage_bytes -1 for the source's default): the volume, and
    its counts as a 2-element int64 tensor, the directly gathered (tile,
    projection) pairs and the ring waits. A fake tensor gets both shapes
    from the fake implementation below, without the library, and a
    FlopCounterMode the count of `backproject_ops`."""
    lib = _bound_library()
    n_p, nu, nv = qt.shape
    out = torch.empty((nx, ny, 2, nz // 2), dtype=torch.float32,
                      device=qt.device)
    count = torch.zeros(2, dtype=torch.int64, device=qt.device)
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
            qt.new_empty((2,), dtype=torch.int64))


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
