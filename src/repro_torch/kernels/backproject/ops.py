"""Public wrappers around the back-projection kernel.

Port of `repro/kernels/backproject/ops.py`:

  backproject_kernel : counterpart of `backproject_pallas`, the same
                       signature and result as the oracles in
                       `core/backprojection.py`. It lays the projections
                       out as Q^T, builds the (Np, 13) parameter rows with
                       the codec scale in column 12, and restores the
                       canonical volume from the dual-slab output. The CUDA
                       kernel loops over every projection itself, so there
                       is no projection-batch block and no padding. The
                       launch shape (tile, staging bytes) not given
                       explicitly comes from the tuner (tune.pick_blocks),
                       as the reference's block shape does. With the
                       tracer on, its three parts are device stages of
                       the enclosing fence (`obs.trace.device_stage`):
                       ``bp.operands`` (the Q^T relayout and parameter
                       rows), ``bp.kernel`` (the launch) and ``bp.unfold``
                       (the dual slab restored).
  backproject_mxu    : the gather-free formulation — bilinear
                       interpolation recast as two products with relu-hat
                       weight matrices — in plain torch (the reference
                       computes it outside any Pallas kernel too). Not an
                       `impl` of the plan.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.backprojection import _stream_scales, from_dual_slab
from ...obs.trace import device_stage
from . import tune
from .kernel import backproject_dual


def kernel_operands(pmats: torch.Tensor, proj: torch.Tensor,
                    scales: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operands for `proj`: (params13, qt).

    pmats: (Np, 3, 4); proj: (Np, N_v, N_u) filtered projections (row = v)
    in any wire dtype; `scales` is the codec's per-projection sidecar (None
    = unscaled). Returns the (Np, 13) float32 parameter rows (the matrix
    row-major, the scale in column 12) and Q^T (Np, N_u, N_v), v contiguous.
    """
    dev = proj.device
    n_p = proj.shape[0]
    qt = proj.transpose(-1, -2).contiguous()
    pm = torch.as_tensor(pmats, device=dev).reshape(n_p, 12).to(torch.float32)
    sc = (torch.ones((n_p, 1), dtype=torch.float32, device=dev)
          if scales is None
          else torch.as_tensor(scales, device=dev).reshape(n_p, 1)
          .to(torch.float32))
    return torch.cat([pm, sc], dim=1).contiguous(), qt


def backproject_kernel(pmats: torch.Tensor, proj: torch.Tensor,
                       nx: int, ny: int, nz: int,
                       scales: Optional[torch.Tensor] = None,
                       tile: Optional[Tuple[int, int, int]] = None,
                       stage_bytes: Optional[int] = None) -> torch.Tensor:
    """Alg. 4 via the hand-written kernel. Same signature/result as the
    oracles: operands as in `kernel_operands`; returns (nx, ny, nz) float32
    on the projections' device.

    `tile` and `stage_bytes` not given come from the tuner
    (tune.pick_blocks) for this call's shapes and matrices, under the
    device's shared-memory budget; a given one is pinned and the other
    tuned around it. Plans resolve both once, at build time.
    """
    dev = proj.device
    with device_stage("bp.operands", dev):
        params, qt = kernel_operands(pmats, proj, scales)
    if tile is None or stage_bytes is None:
        n_p, nu, nv = qt.shape
        tile, stage_bytes = tune.pick_blocks(
            nx, ny, nz, params, nu, nv, qt_dtype=qt.dtype,
            fix_tile=tile, fix_stage=stage_bytes)
    with device_stage("bp.kernel", dev):
        dual = backproject_dual(params, qt, nx, ny, nz, tile=tile,
                                stage_bytes=stage_bytes)
    with device_stage("bp.unfold", dev):
        return from_dual_slab(dual)


# backproject_mxu's f32 working set per projection above which it refuses
# to run (its hat matrices grow as nx * ny * nz/2 * N_v).
MXU_MAX_WORKING_SET = 4 * 2**30


def mxu_working_set(nx: int, ny: int, nz: int, n_u: int, n_v: int) -> int:
    """Bytes of backproject_mxu's per-projection f32 intermediates: the u
    hat matrix and its product (nx, ny, N_u + N_v) and the two v hat
    matrices (nx, ny, nz/2, N_v) each."""
    return 4 * nx * ny * (n_u + n_v + 2 * (nz // 2) * n_v)


def backproject_mxu(pmats: torch.Tensor, proj: torch.Tensor,
                    nx: int, ny: int, nz: int,
                    scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather-free back-projection: interpolation as relu-hat products.

    For a voxel column (i,j):  val(k) = sum_{a,b} A[ij,a] * B[ij,k,b] * Q^T[a,b]
    with A[ij,a] = hat(a - u_ij), B[ij,k,b] = hat(b - v_ijk) and
    hat(t) = max(0, 1-|t|). Out-of-range coordinates get zero weight, so
    nothing is masked. Two einsums per projection:
        rows = A @ Q^T          (columns, N_v)    <- a matrix product
        val  = sum_b B * rows   (columns, nz/2)   <- a batched reduction
    Same signature and result as the oracles, (nx, ny, nz) float32. Raises
    ValueError when `mxu_working_set` exceeds MXU_MAX_WORKING_SET (it is
    518 GB at 512^3 from a 1248 x 960 detector) instead of running the
    device out of memory.
    """
    if nz % 2 != 0:
        raise ValueError("requires even N_z")
    nzh = nz // 2
    n_p, n_v, n_u = proj.shape
    need = mxu_working_set(nx, ny, nz, n_u, n_v)
    if need > MXU_MAX_WORKING_SET:
        raise ValueError(
            f"backproject_mxu needs {need / 2**30:.2f} GiB of f32 "
            f"intermediates per projection for a ({nx}, {ny}, {nz}) volume "
            f"from a {n_u} x {n_v} detector, above its "
            f"{MXU_MAX_WORKING_SET / 2**30:.0f} GiB bound; use "
            "backproject_kernel")
    dev = proj.device
    qt = proj.transpose(-1, -2).to(torch.float32)  # (Np, Nu, Nv)
    pm = torch.as_tensor(pmats, device=dev).to(torch.float32)
    sc = _stream_scales(proj, scales)
    i = torch.arange(nx, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(ny, dtype=torch.float32, device=dev)[None, :]
    k = torch.arange(nzh, dtype=torch.float32, device=dev)
    ua = torch.arange(n_u, dtype=torch.float32, device=dev)
    va = torch.arange(n_v, dtype=torch.float32, device=dev)

    def hat(t):
        return torch.clamp(1.0 - t.abs(), min=0.0)

    dual = torch.zeros((nx, ny, 2, nzh), dtype=torch.float32, device=dev)
    for p, q, s in zip(pm, qt, sc):
        x0 = p[0, 0] * i + p[0, 1] * j + p[0, 3]
        y0 = p[1, 0] * i + p[1, 1] * j + p[1, 3]
        z = p[2, 0] * i + p[2, 1] * j + p[2, 3]
        f = 1.0 / z
        u = x0 * f
        w = f * f * s                   # codec decode folded into the weight
        v = (y0[..., None] + p[1, 2] * k) * f[..., None]       # (nx, ny, nzh)
        a = hat(ua - u[..., None])                             # (nx, ny, Nu)
        rows = torch.einsum("xyu,uv->xyv", a, q)
        b = hat(va - v[..., None])                             # (nx,ny,nzh,Nv)
        bm = hat(va - ((n_v - 1.0) - v)[..., None])
        front = w[..., None] * torch.einsum("xykv,xyv->xyk", b, rows)
        back = w[..., None] * torch.einsum("xykv,xyv->xyk", bm, rows)
        dual = dual + torch.stack([front, back], dim=-2)
    return from_dual_slab(dual)
