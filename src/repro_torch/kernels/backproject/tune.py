"""Launch-shape tuner for the Hopper back-projection kernel.

Port of `repro/kernels/backproject/tune.py`. The Pallas kernel's search
space was its (bi, bj, bs) block under a VMEM budget. This kernel's launch
shape is (tile, staging bytes): the tile, a template parameter compiled
for each of `kernel.TILES`, and the bytes of the two shared-memory buffers
that stage the tiles' footprint boxes (0: every projection gathered from
global memory). The tuner

  1. enumerates candidates: every compiled tile x the staging budgets
     `STAGE_PIXELS` (in Q^T pixels of the wire dtype, the source's default
     among them), pruned against a per-block SHARED-MEMORY budget with
     `smem_bytes` (the tile's static tables plus the two buffers; a
     narrow wire type stages more pixels in the same bytes);
  2. ranks the survivors with the kernel's own staging rule
     (`kernel.staging_stats`, the footprint boxes of `footprint_boxes`)
     evaluated on the call's projection matrices: the voxel pairs staged
     and gathered directly, the bytes the staged pairs copy, and each
     warp's per-column work per (tile, projection), weighted in
     `_model_cost` by weights fitted to the tiles' times on an H100; a
     candidate displaces the source's default launch only when it is
     modeled more than `DEFAULT_MARGIN` faster;
  3. in measured mode, times the best few on the card with CUDA events on
     the call's real matrices (the kernel's time depends on P: its boxes
     and which pairs overflow to direct gathers, not only on the shapes),
     and keeps the fastest.

Results are memoized in-process and in a JSON file (the reference's
two-level memo; a measured winner satisfies later unmeasured requests).
The key is the tuning problem: shapes, wire dtype, budget, pins and a
digest of the matrices (what they depend on: the geometry), under a key
space of its own -- a leading "hopper" tag and the device's name -- so a
file shared with the JAX package never serves one package's entry to the
other.

Knobs:
  REPRO_BP_AUTOTUNE  "time" to measure the survivors on the first use of a
                     tuning key (default: the model-ranked pick). On a CPU
                     tensor measuring raises: there is no kernel to time.
  REPRO_TUNE_CACHE   path of the file-backed tuning cache (JSON). Default
                     ~/.cache/repro/bp_tune_cache.json; "off"/"0"/""/
                     "none" disables persistence.

The budget defaults to the card's opt-in per-block shared-memory maximum
(cudaDevAttrMaxSharedMemoryPerBlockOptin, read on the card); off the card
to `DEFAULT_SMEM_BUDGET`, the H100's (227 KiB).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from ...device import resolve_device
from ...filecache import JsonFileCache
from . import kernel as bpk
from .kernel import TILES, smem_bytes, staging_stats

# The H100's opt-in per-block shared memory (232,448 bytes, 227 KiB): the
# budget where no card is asked (the planner's feasibility check, CPU).
DEFAULT_SMEM_BUDGET = 232_448
# Staging budgets tried, in Q^T pixels (bytes = pixels x wire itemsize);
# 26 Ki is the source's default (kernel.STAGE_PIXELS).
STAGE_PIXELS = (0, 13 * 1024, 26 * 1024, 52 * 1024)
# A candidate must beat the default launch by more than this share of
# modeled cost to displace it without a measurement.
DEFAULT_MARGIN = 0.15
# Projections the model samples (evenly spaced) per call.
MODEL_PROJECTIONS = 16
_KEY_TAG = "hopper"

# _model_cost weights, ms per 1e9 units: a staged voxel pair (front and
# mirror gathers), a directly gathered one, a staged byte, and a column of
# a warp in one (tile, projection) step (its column terms, row pointers
# and loop over its lane's k values). Fitted (non-negative least squares)
# to the four tiles' times at the full RabbitCT shape, f32 and fp16, on an
# H100 80GB HBM3 at 700 W (chip_smoke.py [tiles], PERF.md §6); they
# predict the delta shape's within 10 %. The direct weight comes from the
# same card's staging-budget-0 time ([bp-time]): 456 ms where every pair
# is gathered directly.
_W_STAGED = 0.640
_W_DIRECT = 12.0
_W_BYTE = 0.370
_W_WARP_COLUMN = 1144.5


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One launch shape: tile (ti, tj, tk) and staging bytes."""

    tile: Tuple[int, int, int]
    stage_bytes: int
    smem: int              # bytes of shared memory per block (smem_bytes)
    cost: float = 0.0      # modeled ms per launch (0.0: not ranked)
    elapsed: float = 0.0   # measured seconds per call (0.0: not measured)

    def as_tuple(self) -> Tuple[Tuple[int, int, int], int]:
        return self.tile, self.stage_bytes


_CACHE: Dict[tuple, BlockConfig] = {}
_FILE_CACHE = JsonFileCache("REPRO_TUNE_CACHE", "bp_tune_cache.json")


def clear_cache() -> None:
    """Drop the in-process memo (the file cache, if any, is untouched)."""
    _CACHE.clear()


def cache_info() -> Dict[tuple, BlockConfig]:
    return dict(_CACHE)


def file_cache_hits() -> int:
    """How many tuning keys this process served from the file cache."""
    return _FILE_CACHE.hits


def cache_path() -> Optional[str]:
    """Resolved file-cache path, or None when persistence is disabled."""
    return _FILE_CACHE.path()


def _file_cache_get(key: tuple) -> Optional[BlockConfig]:
    entry = _FILE_CACHE.get(key)
    if not isinstance(entry, dict):
        return None
    try:
        entry = dict(entry, tile=tuple(entry["tile"]))
        return BlockConfig(**entry)
    except (KeyError, TypeError):
        return None


def _file_cache_put(key: tuple, cfg: BlockConfig) -> None:
    _FILE_CACHE.put(key, dataclasses.asdict(cfg))


def default_budget(device="cuda") -> int:
    """The per-block shared-memory budget: the card's opt-in maximum for a
    CUDA device (builds the kernel library; the default, which raises and
    names ``device="cpu"`` on a host without one), else
    DEFAULT_SMEM_BUDGET."""
    device = resolve_device(device)
    if device.type == "cuda":
        return bpk.smem_optin(device)
    return DEFAULT_SMEM_BUDGET


def stage_candidates(qt_dtype: torch.dtype) -> Tuple[int, ...]:
    """Staging budgets tried for a wire dtype, in bytes."""
    return tuple(px * qt_dtype.itemsize for px in STAGE_PIXELS)


def default_config(qt_dtype: torch.dtype) -> BlockConfig:
    """The source's default launch: TILES[0] at the default staging."""
    sb = bpk.default_stage_bytes(qt_dtype)
    return BlockConfig(TILES[0], sb, smem_bytes(TILES[0], sb, qt_dtype))


def candidate_blocks(qt_dtype: torch.dtype = torch.float32,
                     budget: Optional[int] = None,
                     fix_tile: Optional[Tuple[int, int, int]] = None,
                     fix_stage: Optional[int] = None) -> List[BlockConfig]:
    """Every (tile, staging bytes) whose shared memory fits `budget`.

    fix_* pins a dimension the caller chose; the other is tuned around it.
    The kernel handles partial tiles, so no shape enters: no tile has to
    divide the volume."""
    budget = DEFAULT_SMEM_BUDGET if budget is None else budget
    tiles = [tuple(fix_tile)] if fix_tile is not None else list(TILES)
    for t in tiles:
        bpk._tile_index(t)     # raises for a tile that is not compiled
    stages = ([fix_stage] if fix_stage is not None
              else stage_candidates(qt_dtype))
    out = []
    for t in tiles:
        for sb in stages:
            sm = smem_bytes(t, sb, qt_dtype)
            if sm <= budget:
                out.append(BlockConfig(t, sb, sm))
    return out


def min_smem_bytes(qt_dtype: torch.dtype = torch.float32) -> int:
    """Smallest shared memory any launch shape needs: the kernel-level
    feasibility floor (planner/feasibility.py). A staging budget of 0
    gathers every projection directly, so no detector is too wide: the
    floor is the smallest tile's static tables."""
    return min(c.smem for c in candidate_blocks(qt_dtype, budget=2**62))


def _pmat_rows(pmats: torch.Tensor) -> torch.Tensor:
    """(Np, 13) f32 parameter rows with unit scales from (Np, 3, 4),
    (Np, 12) or (Np, 13) matrices (the scale does not move the boxes)."""
    p = torch.as_tensor(pmats).reshape(pmats.shape[0], -1)[:, :12]
    p = p.to(torch.float32)
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=1)


def pmats_digest(pmats: torch.Tensor) -> str:
    """Digest of the matrices' f32 bytes: the part of the tuning key that
    stands for the geometry."""
    rows = _pmat_rows(pmats)[:, :12].detach().cpu().contiguous()
    return hashlib.sha256(rows.numpy().tobytes()).hexdigest()[:16]


def _model_cost(c: BlockConfig, params: torch.Tensor, shape, qt_dtype,
                scale: float) -> float:
    """Modeled ms of one launch of `c` on the sampled matrices `params`
    (`scale` = projections per sampled one)."""
    nx, ny, nz, nu, nv = shape
    st = staging_stats(params, nu, nv, nx, ny, nz // 2, c.tile,
                       c.stage_bytes, qt_dtype)
    staged_vox = st["voxel_pairs"] - st["direct_voxel_pairs"]
    steps = st["staged"] + st["direct"]
    work = (_W_STAGED * staged_vox + _W_DIRECT * st["direct_voxel_pairs"]
            + _W_BYTE * st["staged_bytes"]
            + _W_WARP_COLUMN * steps * c.tile[0] * c.tile[1] / bpk.WARPS)
    return work * scale * 1e-9


def _rank(cands: List[BlockConfig], params: torch.Tensor, shape,
          qt_dtype) -> List[BlockConfig]:
    """Candidates with their modeled cost, best first; the default launch
    first unless another beats it by more than DEFAULT_MARGIN."""
    n_p = params.shape[0]
    idx = torch.linspace(0, n_p - 1, min(n_p, MODEL_PROJECTIONS)).round()
    sample = params[idx.to(torch.int64).unique()]
    scale = n_p / sample.shape[0]
    ranked = sorted(
        (dataclasses.replace(c, cost=_model_cost(c, sample, shape, qt_dtype,
                                                 scale)) for c in cands),
        key=lambda c: c.cost)
    dflt = default_config(qt_dtype)
    for i, c in enumerate(ranked):
        if c.as_tuple() == dflt.as_tuple() and \
                c.cost <= ranked[0].cost * (1 + DEFAULT_MARGIN):
            ranked.insert(0, ranked.pop(i))
            break
    return ranked


def _time_candidate(c: BlockConfig, params: torch.Tensor, qt: torch.Tensor,
                    nx: int, ny: int, nz: int, iters: int) -> float:
    """Seconds per launch by CUDA events, after one warm-up launch."""
    def run():
        return bpk.backproject_dual(params, qt, nx, ny, nz, tile=c.tile,
                                    stage_bytes=c.stage_bytes)

    with torch.cuda.device(qt.device):
        run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def autotune(nx: int, ny: int, nz: int, pmats: torch.Tensor, nu: int,
             nv: int, qt_dtype: torch.dtype = torch.float32,
             budget: Optional[int] = None, measure: bool = False,
             max_measure: int = 4, iters: int = 3,
             fix_tile: Optional[Tuple[int, int, int]] = None,
             fix_stage: Optional[int] = None,
             strict: bool = True) -> BlockConfig:
    """Best launch shape for one call: (nx, ny, nz) volume from the
    projections with matrices `pmats` ((Np, 3, 4), or the kernel's (Np,
    13) rows) on a (nu, nv) detector in `qt_dtype`.

    The model ranks on `pmats`' device; measure=True also times the best
    `max_measure` (and the default launch) with the kernel on that device,
    on the real matrices and a zero Q^T, and needs it to be a CUDA device
    (ValueError otherwise). A measured winner cached for the same key is
    preferred either way. budget=None is the device's default.

    strict=True raises ValueError when nothing fits the budget;
    strict=False warns and takes the smallest working set."""
    if nz % 2:
        raise ValueError("back-projection kernel requires even N_z")
    pmats = torch.as_tensor(pmats)
    dev = pmats.device
    if measure and dev.type != "cuda":
        raise ValueError(
            "measured tuning times the CUDA kernel; the matrices are on "
            f"{dev}, where there is no kernel to time (pass CUDA tensors, "
            "or measure=False)")
    budget = default_budget(dev) if budget is None else int(budget)
    qt_dtype = torch.empty((), dtype=qt_dtype).dtype
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    n_p = pmats.shape[0]
    key = (_KEY_TAG, name, nx, ny, nz, n_p, nu, nv, str(qt_dtype), budget,
           pmats_digest(pmats), None if fix_tile is None else tuple(fix_tile),
           fix_stage, strict)
    hit = _CACHE.get(key)
    from_file = False
    if hit is None:
        hit = _file_cache_get(key)
        from_file = hit is not None
    if hit is not None and (not measure or hit.elapsed > 0.0):
        if from_file:
            _FILE_CACHE.hits += 1
        _CACHE[key] = hit
        return hit

    cands = candidate_blocks(qt_dtype, budget, fix_tile, fix_stage)
    if not cands:
        if strict:
            raise ValueError(
                f"no launch shape of the back-projection kernel fits the "
                f"shared-memory budget of {budget} bytes per block (the "
                f"smallest needs {min_smem_bytes(qt_dtype)} bytes); raise "
                "the budget (ReconstructionPlan.vmem_budget)")
        pool = candidate_blocks(qt_dtype, 2**62, fix_tile, fix_stage)
        best = min(pool, key=lambda c: c.smem)
        warnings.warn(
            f"no back-projection launch shape fits the shared-memory budget "
            f"of {budget} bytes; proceeding with tile {best.tile} staging "
            f"{best.stage_bytes} bytes ({best.smem} bytes)")
        _CACHE[key] = best
        _file_cache_put(key, best)
        return best
    params = _pmat_rows(pmats).to(dev)
    ranked = _rank(cands, params, (nx, ny, nz, nu, nv), qt_dtype)
    if measure and len(ranked) > 1:
        pool = ranked[:max_measure]
        dflt = default_config(qt_dtype).as_tuple()
        pool += [c for c in ranked[max_measure:] if c.as_tuple() == dflt]
        qt = torch.zeros((n_p, nu, nv), dtype=qt_dtype, device=dev)
        timed = [dataclasses.replace(
                     c, elapsed=_time_candidate(c, params, qt, nx, ny, nz,
                                                iters))
                 for c in pool]
        best = min(timed, key=lambda c: c.elapsed)
    else:
        best = ranked[0]
    _CACHE[key] = best
    _file_cache_put(key, best)
    return best


def pick_blocks(nx: int, ny: int, nz: int, pmats: torch.Tensor, nu: int,
                nv: int, qt_dtype: torch.dtype = torch.float32,
                budget: Optional[int] = None,
                measure: Optional[bool] = None,
                fix_tile: Optional[Tuple[int, int, int]] = None,
                fix_stage: Optional[int] = None
                ) -> Tuple[Tuple[int, int, int], int]:
    """ops.py and plan entry point: (tile, staging bytes) for one call.

    measure=None defers to REPRO_BP_AUTOTUNE ("time" enables measured
    tuning). An explicitly passed budget is a hard constraint; the
    default budget degrades to the smallest working set with a warning."""
    if measure is None:
        measure = os.environ.get("REPRO_BP_AUTOTUNE", "") == "time"
    return autotune(nx, ny, nz, pmats, nu, nv, qt_dtype=qt_dtype,
                    budget=budget, measure=measure, fix_tile=fix_tile,
                    fix_stage=fix_stage,
                    strict=budget is not None).as_tuple()
