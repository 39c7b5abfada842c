"""Sharded checkpoint I/O on the shard-store core (io/shard_store.py).

Port of `repro/checkpoint/io.py`, byte-compatible with it both ways. Layout
of a checkpoint directory:

  step_000100/
    MANIFEST.json              {step, format, leaf keys/shapes/dtypes/specs,
                                treedef}
    leaves/leaf_00000/         one shard STORE per pytree leaf:
      MANIFEST.json              shard index -> global slice
      shards/shard_00000.bin     one file per distinct shard
    .COMMITTED                 written last -> atomic visibility

A pytree here is nested dicts (flattened in sorted key order, as JAX
does), lists, tuples and namedtuples; None is an empty subtree; anything
else is a leaf (a tensor, a numpy array or scalar, or a
`shard_store.HostShardedArray` snapshot). Leaf keys are JAX's `keystr`
strings (``['acc']``, ``[0]``, ``.field``), so a manifest written by either
package names its leaves alike. `treedef` is informational: each package
writes its own string there and neither loader reads it.

Semantics:
  * On a mesh each rank snapshots its own part of a leaf
    (`shard_store.snapshot(part, mesh, spec)`; the spec travels in the
    leaf) and writes only its own shards; the global array is never
    gathered. Rank 0 writes the manifest and `.COMMITTED` after a barrier,
    so the commit stays the last write.
  * Restore is mesh-agnostic: the manifest stores the logical spec (None
    when the leaf recorded none, a tensor saved without a mesh; an empty
    list is a real, fully replicated spec), and `load_checkpoint(...,
    mesh=)` reads each rank's region of that spec on whatever mesh the
    restarted job has, opening only the shard files the region intersects
    (`shard_store.mesh_region`, `read_region`) — the elastic restart is the
    same code path as a plain one.
  * Corruption fails loudly: a truncated shard file, a missing manifest
    entry and a missing `.COMMITTED` marker each raise `StoreError` naming
    the offending path, and `CheckpointManager.restore_latest` falls back
    to the newest step that does load.
  * `CheckpointManager` takes its host snapshot before `save` returns and
    writes on a background thread, keeps the newest K checkpoints, never
    deletes the last committed one, and sweeps `step_*.tmp` directories
    orphaned by a crashed writer.
  * Sharded LM state: a DTensor leaf (`parallel/sharding.py`) is saved
    as its rank's local part with the spec of its placements
    (`sharding.spec_of`), so each rank writes only its own shards; a tree
    that spans several ranks is saved by every rank, and by the manager
    with `blocking=True`. Restoring into DTensor leaves of `like` (or
    into meta leaves with `shardings=`) reads each rank's region of the
    TARGET layout and returns DTensors laid out so: a state written on a
    (data 2, model 2) mesh restores onto (1, 4), (4, 1) or, with plain
    leaves, whole. A mesh axis of size 1 is Replicate() in a DTensor, so
    the recorded spec does not name it (the layout is the same); a
    Partial() or unevenly sharded leaf raises.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import warnings
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..device import resolve_device
from ..io import shard_store
from ..io.shard_store import HostShardedArray, StoreError
from ..parallel.sharding import spec_of, wrap_local

PyTree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^step_(\d+)\.tmp$")


# ---------------------------------------------------------------------------
# pytrees: JAX's leaf order and key strings, without JAX

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten(tree, key: str = "") -> Tuple[List[Tuple[str, Any]], Any]:
    """([(keystr, leaf)] in JAX's leaf order, treedef)."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k], f"{key}[{k!r}]") for k in keys]
        kind = ("dict", type(tree), keys)
    elif _is_namedtuple(tree):
        parts = [_flatten(v, f"{key}.{f}")
                 for f, v in zip(type(tree)._fields, tree)]
        kind = ("namedtuple", type(tree), None)
    elif isinstance(tree, (list, tuple)):
        parts = [_flatten(v, f"{key}[{i}]") for i, v in enumerate(tree)]
        kind = (type(tree).__name__, type(tree), None)
    else:
        return [(key, tree)], "*"
    return ([leaf for flat, _ in parts for leaf in flat],
            (kind, [td for _, td in parts]))


def _unflatten(treedef, leaves):
    """Rebuild the tree of `treedef` from an iterator of leaves."""
    if treedef is None:
        return None
    if treedef == "*":
        return next(leaves)
    (kind, cls, keys), children = treedef
    vals = [_unflatten(td, leaves) for td in children]
    if kind == "dict":
        return cls(zip(keys, vals))
    if kind == "namedtuple":
        return cls(*vals)
    return cls(vals)


def _tree_map(fn: Callable, tree: PyTree) -> PyTree:
    flat, treedef = _flatten(tree)
    return _unflatten(treedef, iter([fn(leaf) for _, leaf in flat]))


# ---------------------------------------------------------------------------
# leaves

def _shape(leaf) -> tuple:
    """A leaf's GLOBAL shape (a snapshot's is its global array's)."""
    if isinstance(leaf, (HostShardedArray, torch.Tensor)):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def _dtype_name(leaf) -> str:
    if isinstance(leaf, (HostShardedArray, torch.Tensor)):
        return shard_store.dtype_name(leaf.dtype)
    return str(np.asarray(leaf).dtype)


def _leaf_spec(leaf) -> Optional[list]:
    """The leaf's spec in JSON form, or None when none is recorded. The
    None/[] distinction is real: [] is a fully replicated layout on a mesh
    (re-applied on restore), None means the leaf was saved without a mesh
    (restored whole)."""
    return leaf.spec if isinstance(leaf, HostShardedArray) else None


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _snapshot(leaf):
    """A host copy of one leaf (snapshots pass through); a DTensor's is its
    rank's local part on its mesh, with its spec."""
    if isinstance(leaf, HostShardedArray):
        return leaf
    if isinstance(leaf, DTensor):
        return shard_store.snapshot(leaf.to_local(), leaf.device_mesh,
                                    _spec_json(spec_of(
                                        leaf.device_mesh, leaf.placements,
                                        leaf.shape)))
    return shard_store.snapshot(leaf)


def _writer(flat) -> Tuple[int, int]:
    """(rank, world) of a save: that of its snapshots taken on a mesh, or
    (0, 1) when no leaf was."""
    for _, leaf in flat:
        if isinstance(leaf, HostShardedArray) and leaf.world > 1:
            return leaf.rank, leaf.world
    return 0, 1


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _sweep_orphaned_tmp(directory: str) -> List[str]:
    """Remove `step_*.tmp` directories a crashed writer left behind. They
    must neither accumulate nor shadow a later save of the same step (a
    stale tmp would leak its leaf files into the renamed checkpoint)."""
    removed = []
    if not os.path.isdir(directory):
        return removed
    for name in os.listdir(directory):
        if _TMP_RE.match(name):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
            removed.append(name)
    return removed


# ---------------------------------------------------------------------------
# save / load

def save_checkpoint(directory: str, step: int, tree: PyTree) -> str:
    """Write a committed checkpoint for `tree` at `step`. Returns its path.

    Leaves may be tensors (on any device; copied to the host here),
    DTensors (each rank's local part), numpy values, or
    `shard_store.HostShardedArray` snapshots. When the DTensors or
    snapshots span a mesh of several ranks, every rank of the default
    process group calls this with its own: each writes its own shards,
    other leaves are written by rank 0, and rank 0 commits after a
    barrier.
    """
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    leaves_dir = os.path.join(tmp, "leaves")
    flat, treedef = _flatten(tree)
    flat = [(k, _snapshot(v) if isinstance(v, DTensor) else v)
            for k, v in flat]
    rank, world = _writer(flat)
    if rank == 0:
        if os.path.exists(tmp):  # stale writer: do not inherit its files
            shutil.rmtree(tmp)
        os.makedirs(leaves_dir, exist_ok=True)
    if world > 1:
        dist.barrier()
    manifest = {"step": step, "format": "shard-store-v1", "leaves": []}
    for idx, (key, leaf) in enumerate(flat):
        name = f"leaf_{idx:05d}"
        if rank == 0 or isinstance(leaf, HostShardedArray):
            shard_store.save_array(os.path.join(leaves_dir, name), leaf)
        manifest["leaves"].append({
            "name": name,
            "key": key,
            "shape": list(_shape(leaf)),
            "dtype": _dtype_name(leaf),
            "spec": _leaf_spec(leaf),
        })
    manifest["treedef"] = repr(_unflatten(treedef, iter(["*"] * len(flat))))
    if world > 1:
        dist.barrier()
    if rank == 0:
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        open(os.path.join(tmp, ".COMMITTED"), "w").close()
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    if world > 1:
        dist.barrier()
    return path


def committed_steps(directory: str) -> List[int]:
    """All committed step numbers, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, ".COMMITTED")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, step: int, like: PyTree, mesh=None,
                    device="cuda", shardings: Optional[PyTree] = None
                    ) -> PyTree:
    """Restore into the structure of `like`, onto `device`.

    `like` gives the pytree structure and each leaf's GLOBAL shape (a
    tensor, a tensor on the "meta" device, a DTensor, or a snapshot).

    A DTensor leaf of `like`, or a leaf whose entry in `shardings` (a tree
    like `like`'s, of `parallel.sharding.Sharding`s or None) is a
    Sharding, gives the TARGET layout: the leaf comes back as a DTensor on
    that mesh and placements, each rank reading its region of it
    (whatever layout wrote the checkpoint), and only the shard files that
    region intersects are opened. Otherwise, without `mesh` the leaf comes
    back whole; with `mesh=` (a DeviceMesh, which may differ in shape
    from the mesh that wrote the checkpoint: an elastic restart), a leaf
    whose manifest records a spec comes back as this rank's region of
    that spec on `mesh`, and a leaf saved without a mesh whole on every
    rank.
    """
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    mpath = os.path.join(path, "MANIFEST.json")
    if not os.path.exists(mpath):
        raise StoreError(f"no checkpoint manifest at {mpath!r}")
    if not os.path.exists(os.path.join(path, ".COMMITTED")):
        raise StoreError(
            f"checkpoint {path!r} is uncommitted (no .COMMITTED marker): "
            "the writer crashed mid-save; restore an earlier step")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise StoreError(f"unreadable checkpoint manifest {mpath!r}: {e}"
                         ) from e
    flat, treedef = _flatten(like)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected "
            f"{len(flat)}")
    targets = ([None] * len(flat) if shardings is None
               else _target_shardings(shardings, like))
    out = []
    for (_, leaf_like), target, meta in zip(flat, targets,
                                            manifest["leaves"]):
        leaf_dir = os.path.join(path, "leaves", meta["name"])
        if tuple(meta["shape"]) != _shape(leaf_like):
            raise ValueError(
                f"{meta['key']}: checkpoint shape {tuple(meta['shape'])} != "
                f"expected {_shape(leaf_like)}")
        if isinstance(leaf_like, DTensor):
            target = (leaf_like.device_mesh, tuple(leaf_like.placements))
        if target is not None:
            t_mesh, placements = target
            shape = tuple(meta["shape"])
            region = shard_store.mesh_region(shape, t_mesh, _spec_json(
                spec_of(t_mesh, placements, shape)))
            local = shard_store.read_region(leaf_dir, region).to(dev)
            out.append(wrap_local(local, t_mesh, placements, shape))
            continue
        if mesh is not None and meta["spec"] is not None:
            region = shard_store.mesh_region(meta["shape"], mesh,
                                             meta["spec"])
            value = shard_store.read_region(leaf_dir, region)
        else:
            value = shard_store.load_array(leaf_dir)
        out.append(value.to(dev))
    return _unflatten(treedef, iter(out))


def _target_shardings(shardings: PyTree, like: PyTree) -> list:
    """The Sharding (or None) of each leaf of `like`, in its leaf order,
    from the tree `shardings` (a None subtree covers every leaf under
    it)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _target_shardings(
            None if shardings is None else shardings[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for i, v in enumerate(like) for x in _target_shardings(
            None if shardings is None else shardings[i], v)]
    return [] if like is None else [shardings]


class CheckpointManager:
    """Async checkpointing with retention + orphan sweep.

    With a process group initialised, rank 0 alone sweeps and deletes. A
    tree snapshotted on a mesh of several ranks is saved with
    `blocking=True`: its writes synchronise the ranks, which a background
    thread must not do beside the engine's collectives.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        if _is_rank0():
            _sweep_orphaned_tmp(directory)  # crashed-writer leftovers

    def save(self, step: int, tree: PyTree, blocking: bool = False) -> None:
        # Copy every leaf to host memory now (shard by shard for mesh
        # snapshots, which keep each shard's global index and the spec),
        # so the caller may overwrite its tensors as soon as save returns;
        # write on a background thread.
        host_tree = _tree_map(_snapshot, tree)
        if not blocking and _writer(_flatten(host_tree)[0])[1] > 1:
            raise ValueError(
                "a tree snapshotted on a mesh of several ranks must be "
                "saved with blocking=True (its writes synchronise the ranks)")
        self.wait()

        def _write():
            save_checkpoint(self.directory, step, host_tree)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: PyTree, mesh=None, device="cuda",
                       shardings: Optional[PyTree] = None):
        """(step, tree) from the newest loadable committed checkpoint.

        A corrupted newest step (truncated shard, gutted manifest — any
        StoreError) is skipped with the next-newest tried instead, so one
        bad write never strands a restart; (None, None) when nothing
        committed loads. The tree lands on `device`.
        """
        device = resolve_device(device)
        self.wait()
        last_err: Optional[StoreError] = None
        for step in reversed(committed_steps(self.directory)):
            try:
                return step, load_checkpoint(self.directory, step, like,
                                             mesh, device, shardings)
            except StoreError as e:
                last_err = e
                continue
        if last_err is not None:
            warnings.warn(f"no committed checkpoint loads cleanly; last "
                          f"error: {last_err}", RuntimeWarning)
        return None, None

    def _gc(self) -> None:
        if not _is_rank0():
            return
        _sweep_orphaned_tmp(self.directory)
        steps = committed_steps(self.directory)
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"),
                ignore_errors=True)
