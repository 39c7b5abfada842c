"""Shard-level array store: one file per shard + a manifest.

Port of `repro/io/shard_store.py`, byte-compatible with it both ways:

  <dir>/
    MANIFEST.json            {shape, dtype, spec, shards: [...]}
    shards/shard_00000.bin   raw little-endian C-order bytes, one file per
    shards/shard_00001.bin   distinct shard (replicas deduplicated)
    ...

The manifest's dtype is numpy's name for it ("float32", "float16",
"bfloat16", "float8_e4m3fn", "float8_e5m2", ...), mapped here to torch
dtypes; shard bytes are read and written through a same-width integer
view, so no bfloat16/float8 numpy type is needed. Reads return CPU
tensors.

Write side — `save_array`: a tensor or array as one file or a regular
`chunks=` grid, or a `HostShardedArray` from `snapshot`: on a mesh each
rank snapshots its own part of the engine's output (its slab), names the
mesh axes each dimension is cut over (`spec`, the list the JAX writer
records for the same layout), and writes only its own shard file, and only
if it is the first replica of that shard; rank 0 writes the manifest after
a barrier, so the manifest is the commit point there too.

Read side — `read_region`: for a region in global coordinates (on a mesh,
`mesh_region` gives this rank's part of a stored spec), only the
shard files that intersect it are opened (memory-mapped, after a size
check: truncation by a crashed or out-of-quota writer raises before any
data is trusted). All corruption paths raise `StoreError` with the
offending path; `open_count()` counts the shard files opened.

Growing stores (`init_store` + `append_region`) commit each region by an
atomic manifest replace after the shard file is fsync'ed: a reader polling
the store never sees an entry whose bytes are not on disk.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Index = Tuple[Tuple[int, int], ...]     # ((lo, hi), ...) per dimension

MANIFEST = "MANIFEST.json"
SHARD_DIR = "shards"


class StoreError(RuntimeError):
    """A shard store is unreadable: truncated shard file, missing manifest
    or manifest entry, unknown dtype."""


# ---------------------------------------------------------------------------
# file-open accounting (scatter-read tests)

_OPEN_COUNT = 0


def reset_open_count() -> None:
    global _OPEN_COUNT
    _OPEN_COUNT = 0


def open_count() -> int:
    """Shard files opened since `reset_open_count()` (reads only)."""
    return _OPEN_COUNT


# ---------------------------------------------------------------------------
# dtypes: the manifest's numpy names <-> torch dtypes

# Storage types numpy has no native name for (the JAX writer names them
# after ml_dtypes).
_EXTRA_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_EXTRA_NAMES = {v: k for k, v in _EXTRA_DTYPES.items()}
# Same-width integer types that carry the raw bytes through numpy.
_RAW = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def dtype_from_name(name: str) -> torch.dtype:
    """The torch dtype of a manifest's dtype name."""
    if name in _EXTRA_DTYPES:
        return _EXTRA_DTYPES[name]
    try:
        return torch.from_numpy(np.empty(0, dtype=np.dtype(name))).dtype
    except TypeError:
        raise StoreError(f"manifest names unknown dtype {name!r}")


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's (numpy) name of a torch dtype."""
    if dtype in _EXTRA_NAMES:
        return _EXTRA_NAMES[dtype]
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


def _host_tensor(value) -> torch.Tensor:
    """`value` (tensor, numpy array or scalar) as a CPU tensor that owns
    its memory: a copy, so a caller that goes on writing into `value` (or
    a card kernel still producing it) cannot change what is stored."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(value))


def _to_bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# indices

def _normalize_index(index: Sequence[slice], shape: Sequence[int]) -> Index:
    """Tuple-of-slices (possibly with None bounds) -> ((lo, hi), ...) in
    global coordinates."""
    out = []
    for sl, dim in zip(index, shape):
        lo, hi, step = sl.indices(dim)
        if step != 1:
            raise StoreError(f"non-unit-stride shard index {sl} unsupported")
        out.append((lo, hi))
    return tuple(out)


def _as_index(index, shape) -> Index:
    if index and isinstance(index[0], slice):
        return _normalize_index(index, shape)
    return tuple(tuple(b) for b in index)


def _extent(index: Index) -> Tuple[int, ...]:
    return tuple(hi - lo for lo, hi in index)


def _size(index: Index) -> int:
    n = 1
    for lo, hi in index:
        n *= hi - lo
    return n


def _intersect(a: Index, b: Index) -> Optional[Index]:
    out = []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def _rel_slices(outer: Index, inner: Index) -> Tuple[slice, ...]:
    """`inner` (global coords) as slices into an array spanning `outer`."""
    return tuple(slice(ilo - olo, ihi - olo)
                 for (olo, _), (ilo, ihi) in zip(outer, inner))


def _grid(shape: Sequence[int], parts: Sequence[int]) -> List[Index]:
    """Every cell of a regular grid of `parts[d]` pieces along each dim,
    in row-major (sorted) order."""
    out: List[Index] = [()]
    for dim, n in zip(shape, parts):
        step = dim // n
        out = [idx + ((i * step, (i + 1) * step),)
               for idx in out for i in range(n)]
    return out


def _chunk_indices(shape: Tuple[int, ...],
                   chunks: Sequence[int]) -> List[Index]:
    """Regular grid of `chunks[d]` pieces along each dim (host-array
    writes: a preprocessing job laying out slice-per-rank files)."""
    if len(chunks) != len(shape):
        raise ValueError(f"chunks {tuple(chunks)} must have one entry per "
                         f"dimension of shape {shape}")
    for dim, n in zip(shape, chunks):
        if n < 1 or dim % n:
            raise ValueError(
                f"chunks {tuple(chunks)} must positively divide {shape}")
    return _grid(shape, chunks)


# ---------------------------------------------------------------------------
# host-side snapshot of one rank's part of a sharded tensor

@dataclasses.dataclass
class HostShardedArray:
    """A tensor snapshotted to host memory shard by shard: the global
    shape, the dtype, the logical spec (the mesh axes each dimension is cut
    over, JSON form; None = no spec recorded), the GLOBAL shard index table
    (so every rank numbers its files alike), and the (index, data) pairs
    this rank owns. `rank`/`world` are the writer's place in the default
    process group: with world > 1 `save_array` synchronises the ranks."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Optional[list]
    shards: list            # [(Index, CPU tensor)] owned by this rank
    table: list             # [Index], every shard's, global and sorted
    rank: int = 0
    world: int = 1


def snapshot(value, mesh=None, spec: Optional[Sequence] = None):
    """A host copy of `value` for a later `save_array`.

    Without a mesh: a CPU tensor (the copy is taken here, so the caller may
    go on overwriting `value`). On a mesh, `value` is this rank's part of a
    global tensor whose dimension d is cut over the mesh axes `spec[d]` (an
    axis name, a list of names in row-major order, or None; missing
    trailing entries are None), as `DeviceMesh.get_coordinate()` places
    the rank. The global shape, the shard table and whether this rank is
    the first replica of its shard (every coordinate on the axes `spec`
    does not name is 0) follow from that.
    """
    if mesh is None:
        return _host_tensor(value)
    local = tuple(value.shape)
    spec = list(spec or [])
    cuts, owner = _spec_cuts(mesh, spec, len(local))
    parts = [n for n, _ in cuts]
    mine = tuple((i * ext, (i + 1) * ext) for ext, (_, i) in zip(local, cuts))
    shape = tuple(e * n for e, n in zip(local, parts))
    shards = [(mine, _host_tensor(value))] if owner else []
    return HostShardedArray(
        shape=shape, dtype=value.dtype,
        spec=[list(e) if isinstance(e, (tuple, list)) else e for e in spec],
        shards=shards, table=_grid(shape, parts),
        rank=dist.get_rank(), world=dist.get_world_size())


def _spec_cuts(mesh, spec: Sequence, ndim: int):
    """([(pieces, this rank's piece)] per dimension, whether this rank is
    the first replica of its piece) for `spec` on `mesh`: dimension d is cut
    over the mesh axes `spec[d]` (a name, a list of names in row-major
    order, or None; missing trailing entries are None), as
    `DeviceMesh.get_coordinate()` places the rank."""
    names = list(mesh.mesh_dim_names)
    sizes = list(mesh.shape)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank holds no coordinate in the mesh "
                         f"{tuple(names)} {tuple(sizes)}")
    spec = list(spec or [])
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{ndim} dimensions of the tensor")
    used, cuts = set(), []
    for d in range(ndim):
        entry = spec[d] if d < len(spec) else None
        axes = (() if entry is None
                else (entry,) if isinstance(entry, str) else tuple(entry))
        n, i = 1, 0
        for a in axes:
            if a not in names or a in used:
                raise ValueError(
                    f"spec {spec} names axis {a!r} that the mesh "
                    f"{tuple(names)} lacks, or names it twice")
            k = names.index(a)
            n, i = n * sizes[k], i * sizes[k] + coord[k]
            used.add(a)
        cuts.append((n, i))
    owner = all(c == 0 for a, c in zip(names, coord) if a not in used)
    return cuts, owner


def mesh_region(shape: Sequence[int], mesh, spec: Sequence) -> Index:
    """This rank's region, in global coordinates, of an array of global
    `shape` laid out on `mesh` by `spec` (see `snapshot`): the part a
    restarted job reads back on whatever mesh it has."""
    cuts, _ = _spec_cuts(mesh, spec, len(shape))
    out = []
    for dim, (n, i) in zip(shape, cuts):
        if dim % n:
            raise ValueError(
                f"dimension of {dim} does not divide into the {n} pieces "
                f"spec {list(spec)} cuts it into on this mesh")
        ext = dim // n
        out.append((i * ext, (i + 1) * ext))
    return tuple(out)


# ---------------------------------------------------------------------------
# write side

def save_array(path: str, arr, *, chunks: Optional[Sequence[int]] = None,
               extra_manifest: Optional[dict] = None) -> str:
    """Write `arr` as a shard store at `path` (clearing any stale store).

    HostShardedArray  the snapshot path: this rank writes the shards it
                      owns; with world > 1 every rank of the default
                      process group must call this (rank 0 clears the
                      store, the ranks write, rank 0 commits the manifest,
                      with a barrier between each step).
    tensor / array    one file, or a `chunks=(c0, c1, ...)` regular grid.

    `extra_manifest` merges additional keys into MANIFEST.json (reserved
    keys shape/dtype/spec/shards win) — the stream layer records the codec
    of an encoded projection store and a volume's engine layout there.
    """
    if isinstance(arr, HostShardedArray):
        shape, dtype, spec = tuple(arr.shape), arr.dtype, arr.spec
        table = sorted(tuple(tuple(b) for b in i) for i in arr.table)
        owned = dict(arr.shards)
        rank, world = arr.rank, arr.world
    else:
        data = _host_tensor(arr)
        shape, dtype, spec = tuple(data.shape), data.dtype, None
        table = (_chunk_indices(shape, chunks) if chunks is not None
                 else [tuple((0, d) for d in shape)])
        owned = {idx: data[tuple(slice(lo, hi) for lo, hi in idx)]
                 for idx in table}
        rank, world = 0, 1
    if rank == 0 and os.path.exists(path):
        shutil.rmtree(path)
    if world > 1:
        dist.barrier()
    shard_dir = os.path.join(path, SHARD_DIR)
    os.makedirs(shard_dir, exist_ok=True)

    entries = []
    for i, idx in enumerate(table):
        fname = f"shard_{i:05d}.bin"
        entries.append({"file": fname, "index": [list(b) for b in idx]})
        if idx in owned:
            with open(os.path.join(shard_dir, fname), "wb") as f:
                _to_bytes(owned[idx]).tofile(f)
    if world > 1:
        dist.barrier()
    if rank == 0:
        manifest = dict(extra_manifest or {})
        manifest.update({
            "shape": list(shape),
            "dtype": dtype_name(dtype),
            "spec": spec,
            "shards": entries,
        })
        with open(os.path.join(path, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
    if world > 1:
        dist.barrier()
    return path


# ---------------------------------------------------------------------------
# streaming append (growing store: the scanner writes while readers poll)

def _write_manifest(path: str, manifest: dict) -> None:
    """Atomic manifest replace: readers polling a growing store either see
    the old manifest or the new one, never a torn write."""
    mpath = os.path.join(path, MANIFEST)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, mpath)


def init_store(path: str, shape: Sequence[int], dtype: torch.dtype,
               extra_manifest: Optional[dict] = None) -> str:
    """Create an EMPTY shard store of a known final shape — the head of a
    streaming write (`append_region`): the manifest declares the full array
    up front with no shards and grows one entry per committed append."""
    os.makedirs(os.path.join(path, SHARD_DIR), exist_ok=True)
    manifest = dict(extra_manifest or {})
    manifest.update({
        "shape": list(shape),
        "dtype": dtype_name(dtype),
        "spec": None,
        "shards": [],
    })
    _write_manifest(path, manifest)
    return path


def append_region(path: str, index: Sequence, data) -> dict:
    """Append one region to a growing store and COMMIT it.

    Write protocol: the shard file lands fully on disk first (written,
    flushed, fsync'ed), then the manifest is atomically replaced with the
    new entry appended — the manifest entry is the commit point, so a
    reader never sees an entry whose bytes are not durable, and a crashed
    writer leaves at worst an orphaned (inert) shard file. `data` is cast
    to the store's dtype. Returns the new entry."""
    m = read_manifest(path)
    shape = tuple(m["shape"])
    idx = _as_index(index, shape)
    dtype = dtype_from_name(m["dtype"])
    piece = torch.as_tensor(data).detach().to("cpu").to(dtype)
    if tuple(piece.shape) != _extent(idx):
        raise ValueError(
            f"append data shape {tuple(piece.shape)} does not span index "
            f"{idx}")
    for entry in m["shards"]:
        prev = tuple(tuple(b) for b in entry["index"])
        if _intersect(idx, prev) is not None:
            raise StoreError(
                f"append region {idx} overlaps committed shard "
                f"{entry['file']} ({prev}) in {path!r}")
    fname = f"shard_{len(m['shards']):05d}.bin"
    with open(os.path.join(path, SHARD_DIR, fname), "wb") as f:
        _to_bytes(piece).tofile(f)
        f.flush()
        os.fsync(f.fileno())
    entry = {"file": fname, "index": [list(b) for b in idx]}
    m["shards"].append(entry)
    _write_manifest(path, m)
    return entry


# ---------------------------------------------------------------------------
# read side

def read_manifest(path: str) -> dict:
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        raise StoreError(f"no shard store at {path!r} (missing {MANIFEST})")
    try:
        with open(mpath) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise StoreError(f"unreadable manifest {mpath!r}: {e}") from e


def entry_nbytes(entry: dict, dtype: torch.dtype) -> int:
    """The size a manifest entry's shard file must have."""
    return _size(tuple(tuple(b) for b in entry["index"])) * _itemsize(dtype)


def _open_shard(path: str, entry: dict, dtype: torch.dtype) -> np.ndarray:
    """Memory-map one shard file as its same-width integer type, verifying
    its size first (truncation must fail loudly, not read garbage)."""
    global _OPEN_COUNT
    extent = _extent(tuple(tuple(b) for b in entry["index"]))
    fpath = os.path.join(path, SHARD_DIR, entry["file"])
    if not os.path.exists(fpath):
        raise StoreError(f"missing shard file {fpath!r}")
    expected = entry_nbytes(entry, dtype)
    actual = os.path.getsize(fpath)
    if actual != expected:
        raise StoreError(
            f"truncated shard file {fpath!r}: {actual} bytes on disk, "
            f"expected {expected} ({extent} x {dtype_name(dtype)})")
    _OPEN_COUNT += 1
    raw = _RAW[_itemsize(dtype)]
    if expected == 0 or extent == ():
        return np.fromfile(fpath, dtype=raw).reshape(extent)
    return np.memmap(fpath, dtype=raw, mode="r", shape=extent, order="C")


def read_region(path: str, index: Sequence[slice] | Index,
                manifest: Optional[dict] = None) -> torch.Tensor:
    """Assemble one global-coordinate region as a CPU tensor, opening only
    the shard files that intersect it. Raises StoreError when the
    manifest's shards do not cover the region (a deleted/missing manifest
    entry)."""
    m = manifest if manifest is not None else read_manifest(path)
    shape = tuple(m["shape"])
    dtype = dtype_from_name(m["dtype"])
    region = _as_index(index, shape)
    out = np.empty(_extent(region), dtype=_RAW[_itemsize(dtype)])
    covered = 0
    for entry in m["shards"]:
        sidx = tuple(tuple(b) for b in entry["index"])
        inter = _intersect(region, sidx)  # () for 0-d: the shard covers it
        if inter is None:
            continue
        data = _open_shard(path, entry, dtype)
        out[_rel_slices(region, inter)] = data[_rel_slices(sidx, inter)]
        covered += _size(inter)
        if covered == _size(region):
            break
    if covered != _size(region):
        raise StoreError(
            f"shard store {path!r} does not cover region {region}: "
            f"{covered}/{_size(region)} elements present — missing or "
            "deleted manifest entries")
    return torch.from_numpy(out).view(dtype)


def load_array(path: str) -> torch.Tensor:
    """The whole stored array as a CPU tensor."""
    m = read_manifest(path)
    return read_region(path, tuple((0, d) for d in m["shape"]), manifest=m)


def stored_spec(path: str) -> Optional[list]:
    """The writer's logical spec as recorded (a list of axis names, lists
    of names and None per dimension), or None if none was recorded."""
    return read_manifest(path).get("spec")
