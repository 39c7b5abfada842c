"""Dry run: trace every (arch x shape x mesh) cell on a fake world of H100
ranks, with no card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out artifacts/dryrun_torch.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fdk --fdk-problem 4k --both-meshes

Port of `repro/launch/dryrun.py`, which compiles each cell with XLA on 512
virtual devices and asks the compiled program for its memory and cost.
PyTorch has no compiler to ask, so the port runs the cell's function once
as rank 0 of a fake world:

* `torch.distributed` is initialised with the "fake" backend at the
  mesh's world size (`fake_world`): collectives return at once and move
  nothing. The dry run refuses to start beside a real default process
  group, and destroys its own on exit.
* The inputs are rank 0's local parts of the cell's abstract state and
  batch, as fake tensors (`FakeTensorMode`): shapes and dtypes, no
  storage. They are CPU tensors inside `device.fake_card()`, so every
  kernel wrapper takes its card branch, whose launch operator's fake
  implementation gives the output's shape (a torch built without CUDA
  cannot run autograd's engine on fake CUDA tensors).
* `TraceCounter`, a dispatch mode that sees the local tensor operations
  DTensor issues on this rank, counts what the rank does: FLOPs by
  `torch.utils.flop_counter`'s formulas (products only, and the kernels'
  registered formulas), the bytes each non-view operation reads and
  writes (eager execution moves them through HBM), each collective's
  kind, bytes and group, and the kernel operators' calls.
  `torch.utils.flop_counter.FlopCounterMode` itself counts a DTensor
  operation at its global size, so it is not used on a mesh.
* `torch.distributed._tools.mem_tracker.MemTracker` gives the rank's
  peak memory, its inputs included; a meta tensor counts nothing.

Each collective's wire bytes follow the ring algorithm for its group
(`roofline.CollectiveStats`); a group inside one node is priced at
NVLink's rate, any other at the network's. The rows are the reference's
JSON lines (`Roofline.row()` keys plus the trace's own), so
`benchmarks/roofline_table.py` renders them. An LM row's compute term is
the traced FLOPs and its memory term the reference's analytic bytes
(`analytic_costs`); an FDK row's terms are both traced.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import get_config, list_archs
from ..device import fake_card
from ..kernels.backproject.kernel import DEFAULT_TILE
from ..models.config import count_active_params, count_params
from ..parallel.sharding import local_bounds, wrap_local
from .cells import SHAPES, build_cell, make_rules, strategy_microbatches
from .mesh import NODES, make_production_mesh, mesh_name, production_shape
from .roofline import (
    GPUS_PER_NODE, CollectiveStats, Roofline, analytic_costs, model_flops_for,
)

# The device of the fake tensors (see the module's docstring).
DEVICE = torch.device("cpu")

# The kernels' launch operators, by the name the rows give them.
KERNEL_OPS = {"repro_torch::flash_attention_fwd": "flash_attention",
              "repro_torch::backproject_dual_launch": "backproject_dual",
              "repro_torch::filter_rows_launch": "filter_rows"}

# Collective operators by name: (kind, the argument whose bytes count,
# whether they count once per rank of the group). The all-gather counts
# its result (a functional one returns g inputs), the rest their operand.
_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0, True),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", 0, True),
    "_c10d_functional::all_gather_into_tensor_coalesced":
        ("all-gather", 0, True),
    "_c10d_functional::all_reduce": ("all-reduce", 0, False),
    "_c10d_functional::all_reduce_": ("all-reduce", 0, False),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0, False),
    "_c10d_functional::all_reduce_coalesced_": ("all-reduce", 0, False),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0, False),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0, False),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0, False),
    "_c10d_functional::broadcast": ("broadcast", 0, False),
    "_c10d_functional::broadcast_": ("broadcast", 0, False),
    "c10d::allreduce_": ("all-reduce", 0, False),
    "c10d::allreduce_coalesced_": ("all-reduce", 0, False),
    "c10d::_allgather_base_": ("all-gather", 0, False),
    "c10d::allgather_": ("all-gather", 0, False),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0, False),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1, False),
    "c10d::reduce_scatter_": ("reduce-scatter", 1, False),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, False),
    "c10d::alltoall_base_": ("all-to-all", 1, False),
    "c10d::broadcast_": ("broadcast", 0, False),
}

_NO_BYTES = {"aten::empty", "aten::empty_strided", "aten::new_empty",
             "aten::empty_like", "aten::new_empty_strided"}


# Operators that only read metadata (FlopCounterMode skips them too).
_METADATA_OPS = {
    torch.ops.aten.sym_is_contiguous.default,
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default, torch.ops.prim.layout.default,
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class TraceCounter(TorchDispatchMode):
    """Per-rank counts of the operations a step runs on local tensors.

    A DTensor operation is handed back to DTensor (NotImplemented), which
    runs it as local operations and collectives that this mode then sees:
    so every count is this rank's. FLOPs are `torch.utils.flop_counter`'s
    (an operation without a formula is decomposed first, as FlopCounterMode
    does); `bytes` is what each non-view operation reads and writes;
    `collectives` the ring wire bytes by group (`intra_node` if every rank
    of the group lies on one node of `gpus_per_node`); `kernel_calls` the
    calls of the kernels' launch operators; `ops` every operation."""

    def __init__(self, gpus_per_node: int = GPUS_PER_NODE):
        super().__init__()
        self.gpus_per_node = gpus_per_node
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives = CollectiveStats()
        self.by_group: Dict[str, Dict[str, float]] = {}
        self.kernel_calls: Dict[str, int] = {}

    def _group(self, func, args, kwargs) -> List[int]:
        """The global ranks of the collective's process group."""
        schema = func._schema.arguments
        values = list(args) + [kwargs.get(a.name) for a in
                               schema[len(args):]]
        for a, v in zip(schema, values):
            if "ProcessGroup" in str(a.type):
                pg = dist.ProcessGroup.unbox(v)
                break
            if a.name == "group_name":
                from torch.distributed.distributed_c10d import (
                    _resolve_process_group)
                pg = _resolve_process_group(v)
                break
        else:
            raise ValueError(f"{func} names no process group")
        return dist.get_process_group_ranks(pg)

    def _collective(self, name, func, args, kwargs) -> None:
        kind, arg, per_rank = _COLLECTIVES[name]
        ranks = self._group(func, args, kwargs)
        g = len(ranks)
        nbytes = _nbytes(args[arg]) * (g if per_rank else 1)
        intra = len({r // self.gpus_per_node for r in ranks}) == 1
        self.collectives.add(kind, float(nbytes), g, intra_node=intra)
        key = f"{kind} x{g}" + ("" if intra else " across nodes")
        entry = self.by_group.setdefault(key, {"count": 0, "bytes": 0.0})
        entry["count"] += 1
        entry["bytes"] += nbytes

    def __enter__(self):
        self._fake_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func in _METADATA_OPS or active_fake_mode() is not self._fake_mode:
            # metadata, or DTensor's sharding propagation on global shapes
            return func(*args, **kwargs)
        # as FlopCounterMode does: an operator with a decomposition runs
        # as that, and its parts are counted
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        name = func._schema.name
        packet = func._overloadpacket
        out = func(*args, **kwargs)
        self.ops += 1
        if name in _COLLECTIVES:
            self._collective(name, func, args, kwargs)
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if name in KERNEL_OPS:
            key = KERNEL_OPS[name]
            self.kernel_calls[key] = self.kernel_calls.get(key, 0) + 1
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += _nbytes(args) + _nbytes(list(kwargs.values())) \
                + _nbytes(out)
        return out


@contextlib.contextmanager
def fake_world(world: int):
    """A default process group of `world` fake ranks, this process rank 0:
    collectives return at once and move nothing. Refuses to start beside
    a real default group; destroys its own on exit."""
    if dist.is_initialized():
        raise RuntimeError(
            "the dry run makes its own fake world, but this process already "
            f"has a default process group (rank {dist.get_rank()} of "
            f"{dist.get_world_size()}); run it in a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_leaf(meta, sharding):
    """This rank's local part of a meta tensor (or a (shape, dtype) spec)
    laid out by `sharding` (None: whole), zeros; a DTensor when sharded.
    Inside a FakeTensorMode the zeros are fake."""
    shape, dtype = tuple(meta.shape), meta.dtype
    if sharding is None:
        return torch.zeros(shape, dtype=dtype, device=DEVICE)
    local = [n for _, n in local_bounds(shape, sharding.mesh,
                                        sharding.placements)]
    return wrap_local(torch.zeros(local, dtype=dtype, device=DEVICE),
                      sharding.mesh, sharding.placements, shape)


def local_inputs(tree, shardings):
    """The cell's abstract inputs (dicts, named tuples, meta tensors and
    TensorSpecs) as this rank's local parts (`_local_leaf`), under the
    same structure."""
    if isinstance(tree, dict):
        return {k: local_inputs(v, None if shardings is None
                                else shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, tuple) and not hasattr(tree, "dtype"):
        parts = [local_inputs(v, None if shardings is None else s)
                 for v, s in zip(tree, shardings or [None] * len(tree))]
        return type(tree)(*parts) if hasattr(type(tree), "_fields") \
            else tuple(parts)
    return _local_leaf(tree, shardings)


def local_parts(tree) -> List[torch.Tensor]:
    """Every tensor leaf of `tree`, a DTensor as its local part."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in local_parts(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in local_parts(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []


@contextlib.contextmanager
def _propagation_apart():
    """Keeps DTensor's own planning out of the dry run's fake mode.

    DTensor works out an operation's output layout by running it on fake
    tensors of the GLOBAL shape, in the fake mode it finds active: inside
    this context it finds none and makes its own, so that the counters
    (which count under the dry run's fake mode only, as MemTracker does)
    do not count those global operations. And it sizes a strided shard's
    local part (`_StridedShard.local_shard_size_and_offset`, reached when
    a reshape merges a sharded dim, as the audio head's does) from a
    small index tensor whose values it reads: that runs on real tensors
    here, since a fake one holds no values."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _sharding_prop, placement_types

    strided = placement_types._StridedShard
    found = (_sharding_prop.detect_fake_mode,
             strided.local_shard_size_and_offset)

    def on_real_tensors(self, *args, **kwargs):
        with unset_fake_temporarily():
            return found[1](self, *args, **kwargs)

    _sharding_prop.detect_fake_mode = lambda *a: None
    strided.local_shard_size_and_offset = on_real_tensors
    try:
        yield
    finally:
        (_sharding_prop.detect_fake_mode,
         strided.local_shard_size_and_offset) = found


def _rank_mem_tracker():
    """A MemTracker that counts only the operations run under the fake
    mode active when it is made (the dry run's), as TraceCounter does:
    the MemTracker of torch 2.11 also counts DTensor's sharding
    propagation, whose tensors have the GLOBAL shape (a train_4k cell's
    peak read 242 GB a rank on the card's machine, 4.84 GB here). Nor
    does it count a tensor on the meta device, wherever it is made (a
    cache's layout, an abstract state): on a card it allocates nothing."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class RankMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if active_fake_mode() is not mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _track(self, reftype, t):
            if t.device.type != "meta":
                super()._track(reftype, t)

    mode = active_fake_mode()
    return RankMemTracker()


def trace(fn, args, shardings, gpus_per_node: int = GPUS_PER_NODE) -> dict:
    """Runs `fn(*inputs)` once on fake local parts of `args` laid out by
    `shardings` (inside the fake world when on a mesh): the counts of a
    `TraceCounter`, the peak memory (inputs included) and its breakdown
    by kind from a MemTracker, and the trace's host seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    with FakeTensorMode(), fake_card(), _propagation_apart():
        inputs = [local_inputs(a, s) for a, s in zip(args, shardings)]
        mem = _rank_mem_tracker()
        mem.track_external(*local_parts(inputs))
        counter = TraceCounter(gpus_per_node)
        with mem, counter:
            fn(*inputs)
        peak = mem.get_tracker_snapshot("peak")
    by_kind: Dict[str, int] = {}
    for stats in peak.values():
        for k, v in stats.items():
            key = str(getattr(k, "value", k))
            by_kind[key] = by_kind.get(key, 0) + int(v)
    return {"counter": counter, "peak_bytes": by_kind.get("Total", 0),
            "memory": by_kind, "trace_s": time.perf_counter() - t0}


def _record(rl: Roofline, traced: dict, extra: dict) -> dict:
    c = traced["counter"]
    return {
        "status": "ok", **rl.row(), **extra,
        "trace_s": traced["trace_s"],
        "memory": traced["memory"],
        "collectives": {"counts": c.collectives.op_count,
                        "bytes": c.collectives.op_bytes,
                        "by_group": c.by_group,
                        "nvlink_wire_bytes": c.collectives.nvlink_wire_bytes},
        "traced_flops_per_dev": c.flops,
        "traced_bytes_per_dev": c.bytes,
        "traced_ops": c.ops,
        "kernel_calls": c.kernel_calls,
    }


def _print(tag: str, rec: dict) -> None:
    print(f"[dryrun] {tag}: OK (trace {rec['trace_s']:.1f}s, "
          f"{rec['traced_ops']} ops)")
    print(f"  peak memory {rec['peak_mem_bytes'] / 1e9:.3f} GB a rank: "
          f"{rec['memory']}")
    print(f"  traced flops {rec['traced_flops_per_dev']:.4e}, bytes "
          f"{rec['traced_bytes_per_dev']:.4e}, kernel calls "
          f"{rec['kernel_calls']}")
    print(f"  collectives: {rec['collectives']['by_group']} "
          f"wire={rec['wire_bytes_per_dev']:.3e}B")
    print(f"  roofline: compute={rec['t_compute_s']:.4f}s memory="
          f"{rec['t_memory_s']:.4f}s collective={rec['t_collective_s']:.4f}s "
          f"dominant={rec['dominant']} useful_ratio="
          f"{rec['useful_ratio'] and round(rec['useful_ratio'], 3)}")


def _write(out_file, rec: dict) -> None:
    if out_file:
        out_file.write(json.dumps(rec) + "\n")
        out_file.flush()


def run_cell(arch: str, shape: str, multi_pod: bool, out_file=None,
             verbose: bool = True, strategy: str = "baseline",
             nodes: int = NODES, gpus_per_node: int = GPUS_PER_NODE,
             cfg=None, shape_info: Optional[dict] = None,
             microbatches: Optional[int] = None,
             single: bool = False) -> dict:
    """Dry-runs one LM cell on the production mesh (`launch/mesh.py`;
    `multi_pod`: two node groups) and returns its row. `cfg`,
    `shape_info` and `microbatches` replace the registered config, the
    shape's sizes and the strategy's depth (smoke sizes). `single`: one
    rank without a mesh or rules, the program a one-card run takes."""
    groups = 2 if multi_pod else 1
    mshape = (1,) if single else production_shape(
        nodes, gpus_per_node, groups)[0]
    name, chips = mesh_name(mshape), math.prod(mshape)
    cfg = get_config(arch) if cfg is None else cfg
    info = SHAPES[shape] if shape_info is None else shape_info
    with fake_world(chips):
        mesh = None if single else make_production_mesh(
            nodes, gpus_per_node, groups, device_type=DEVICE.type)
        cell = build_cell(arch, shape, mesh, strategy=strategy, cfg=cfg,
                          shape_info=info, microbatches=microbatches)
        if cell.skip_reason:
            rec = {"arch": arch, "shape": shape, "mesh": name,
                   "status": "skipped", "reason": cell.skip_reason}
            if verbose:
                print(f"[dryrun] {arch} x {shape} x {name}: SKIP "
                      f"({cell.skip_reason})")
            _write(out_file, rec)
            return rec
        traced = trace(cell.fn, cell.args, cell.in_shardings, gpus_per_node)
        rules = make_rules(cfg, shape, mesh, strategy)
    mb = (strategy_microbatches(cfg, strategy) if microbatches is None
          else microbatches)
    ac = analytic_costs(cfg, info, chips, count_params(cfg),
                        microbatches=mb, tp=1 if single else gpus_per_node,
                        fsdp=rules.fsdp, zero3_gather=rules.zero3_gather,
                        moe_ep=not rules.gather_moe_experts)
    c = traced["counter"]
    rl = Roofline(
        arch=arch, shape=shape, mesh=name, chips=chips,
        hlo_flops=float(c.flops), hlo_bytes=ac.hbm_bytes_per_dev,
        wire_bytes=c.collectives.wire_bytes,
        nvlink_wire_bytes=c.collectives.nvlink_wire_bytes,
        model_flops=model_flops_for(cfg, info, count_active_params(cfg)),
        peak_mem_bytes=traced["peak_bytes"])
    rec = _record(rl, traced, {"strategy": strategy,
                               "analytic_flops_per_dev": ac.flops_per_dev,
                               "microbatches": mb})
    if verbose:
        _print(f"{arch} x {shape} x {name}", rec)
    _write(out_file, rec)
    return rec


def fdk_geometry(problem: str):
    """The paper's cells: 4096 projections of 2048^2 into {2k,4k,8k}^3."""
    from ..core.geometry import CBCTGeometry

    n = {"2k": 2048, "4k": 4096, "8k": 8192}[problem]
    return CBCTGeometry(
        n_proj=4096, n_u=2048, n_v=2048, d_u=2 * 2.4 / 2048,
        d_v=2 * 2.4 / 2048, d=4.0, dsd=8.0,
        n_x=n, n_y=n, n_z=n, d_x=2.0 / n, d_y=2.0 / n, d_z=2.0 / n,
    )


def run_fdk(multi_pod: bool, problem: str = "4k", out_file=None,
            fdk_impl: str = "pipelined", n_steps: int = 8,
            y_chunks: int = 16, impl: str = "factorized",
            nodes: int = NODES,
            gpus_per_node: int = GPUS_PER_NODE, geometry=None,
            verbose: bool = True) -> dict:
    """Dry-runs the paper's reconstruction on the production mesh: each
    rank's N_p/(R*C) projections through `ReconstructionPlan(mesh=...)`.
    `impl="kernel"` traces the back-projection kernel's launch operator
    with its default tile pinned (the tuner needs real matrices; its
    FLOPs are the kernel's registered count); the factorized
    back-projector's gathers count no FLOPs.
    `geometry` replaces the paper's (smoke sizes)."""
    from ..core.plan import ReconstructionPlan

    g = fdk_geometry(problem) if geometry is None else geometry
    groups = 2 if multi_pod else 1
    mshape = production_shape(nodes, gpus_per_node, groups)[0]
    name, chips = mesh_name(mshape), math.prod(mshape)
    kw = {"blocks": DEFAULT_TILE} if impl == "kernel" else {}
    if fdk_impl == "chunked":
        kw.update(schedule="chunked", n_steps=n_steps, y_chunks=y_chunks)
    elif fdk_impl == "pipelined":
        kw.update(schedule="pipelined", n_steps=n_steps)
    else:
        kw.update(schedule="fused")
    with fake_world(chips):
        mesh = make_production_mesh(nodes, gpus_per_node, groups,
                                    device_type=DEVICE.type)
        plan = ReconstructionPlan(geometry=g, mesh=mesh, impl=impl,
                                  reduce="scatter", device=DEVICE, **kw)
        proj = torch.empty((g.n_proj // chips, g.n_v, g.n_u), device="meta")

        def reconstruct(p):
            return plan.build()(p)

        traced = trace(reconstruct, (proj,), (None,), gpus_per_node)
    c = traced["counter"]
    # Useful work: N_x*N_y*N_z*N_p voxel updates, ~18 flops each.
    updates = g.n_x * g.n_y * g.n_z * float(g.n_proj)
    rl = Roofline(
        arch=f"ifdk-{problem}", shape="reconstruct", mesh=name, chips=chips,
        hlo_flops=float(c.flops), hlo_bytes=float(c.bytes),
        wire_bytes=c.collectives.wire_bytes,
        nvlink_wire_bytes=c.collectives.nvlink_wire_bytes,
        model_flops=18.0 * updates, peak_mem_bytes=traced["peak_bytes"])
    rec = _record(rl, traced, {"fdk_impl": fdk_impl, "n_steps": n_steps,
                               "impl": impl})
    if verbose:
        _print(f"iFDK {problem} x {name}", rec)
    _write(out_file, rec)
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fdk", action="store_true")
    ap.add_argument("--fdk-problem", default="4k", choices=["2k", "4k", "8k"])
    ap.add_argument("--fdk-impl", default="pipelined",
                    choices=["plain", "pipelined", "chunked"])
    ap.add_argument("--fdk-steps", type=int, default=8)
    ap.add_argument("--fdk-chunks", type=int, default=16)
    ap.add_argument("--bp-impl", default="factorized",
                    choices=["factorized", "kernel"],
                    help="the FDK cell's back-projector")
    ap.add_argument("--multi-pod", action="store_true",
                    help="two node groups (512 ranks)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--strategy", default="baseline",
                    choices=["baseline", "optimized"])
    args = ap.parse_args(argv)

    out_file = open(args.out, "a") if args.out else None
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    try:
        if args.fdk:
            for mp in meshes:
                run_fdk(mp, args.fdk_problem, out_file,
                        fdk_impl=args.fdk_impl, n_steps=args.fdk_steps,
                        y_chunks=args.fdk_chunks, impl=args.bp_impl)
            return 0
        if args.all:
            for arch in list_archs():
                for shape in SHAPES:
                    for mp in meshes:
                        try:
                            run_cell(arch, shape, mp, out_file,
                                     strategy=args.strategy)
                        except Exception as e:
                            failures.append((arch, shape, mp, repr(e)))
                            traceback.print_exc()
            if failures:
                print(f"[dryrun] {len(failures)} FAILURES:")
                for f in failures:
                    print("  ", f)
                return 1
            print("[dryrun] every cell traced or skipped")
            return 0
        if args.arch is None or args.shape is None:
            ap.error("give --arch and --shape, or --all, or --fdk")
        run_cell(args.arch, args.shape, args.multi_pod, out_file,
                 strategy=args.strategy)
        return 0
    finally:
        if out_file:
            out_file.close()


if __name__ == "__main__":
    raise SystemExit(main())
