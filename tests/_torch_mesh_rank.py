"""One rank of the port's mesh engine for tests/test_torch_mesh.py, and of
its sharded checkpoints for tests/test_torch_checkpoint_mesh.py.

    PYTHONPATH=src python tests/_torch_mesh_rank.py RANK WORLD INIT_FILE WORK_DIR [MODE]

MODE "checkpoint-save" (4 ranks, (1, 2, 2) mesh) and "checkpoint-load"
(2 ranks, (1, 1, 2) mesh) are described at `checkpoint_save` and
`checkpoint_load`, "lm" (4 ranks, (data 2, model 2) mesh, the sharded LM
substrate for tests/test_torch_parallel_lm.py) at `lm`; without a MODE:

Joins a gloo process group of WORLD ranks through INIT_FILE, builds the
(2, 2, 2) (pod, data, model) mesh, reconstructs WORK_DIR/proj.npy for every
case of CASES below through `ReconstructionPlan(mesh=...)`, and assembles
each rank's output into the global volume, and the traced engine
(`build_traced`) for each case of TRACED. Then, for each reduce of
SESSIONS, an incremental session polls the streaming store WORK_DIR/stream
(written by the test), folds its deltas and stores the volume to
WORK_DIR/sink_<reduce>. Rank 0 writes the volumes to WORK_DIR/volumes.npz
and what else the tests read to WORK_DIR/meta.json, among it whether every
rank's `column_pmats` is the model-axis AllGather of its ranks' P, for
each micro-batch, and whether every rank's `ProjectionSource.load(mesh)`
is its `local_projections`.
Imports only the port (never JAX), so it starts fast.
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import (
    assemble_volume, column_pmats, local_projections)
from repro_torch.core.geometry import default_geometry, projection_matrices
from repro_torch.core.plan import ReconstructionPlan
from repro_torch.io.streams import ProjectionSource, VolumeSink
from repro_torch.parallel.mesh import make_mesh

MESH_SHAPE = (2, 2, 2)
MESH_AXES = ("pod", "data", "model")
N, N_PROJ = 16, 32
SCHEDULES = {"fused": {}, "pipelined": {"n_steps": 2},
             "chunked": {"n_steps": 2, "y_chunks": 4}}


def cases():
    """name -> plan fields of every reconstruction the tests check."""
    out = {}
    for impl in ("factorized", "kernel"):
        for sched in SCHEDULES:
            for red in ("psum", "scatter"):
                out[f"{impl}/{sched}/{red}"] = dict(impl=impl, schedule=sched,
                                                    reduce=red)
    for sched in SCHEDULES:
        out[f"factorized/{sched}/scatter_bf16"] = dict(
            schedule=sched, reduce="scatter_bf16")
    out["fp8_e4m3/fused/psum"] = dict(precision="fp8_e4m3")
    out["fp8_e4m3/pipelined/scatter"] = dict(
        precision="fp8_e4m3", schedule="pipelined", reduce="scatter")
    out["bf16/chunked/psum"] = dict(precision="bf16", schedule="chunked")
    return {name: dict(kw, **SCHEDULES[kw.get("schedule", "fused")])
            for name, kw in out.items()}


CASES = cases()
SESSIONS = ("psum", "scatter", "scatter_bf16")
# build_traced runs every schedule as the fused stage decomposition; its
# output is the fused layout (x over model, y over data under scatter).
TRACED = (("fused", "psum"), ("pipelined", "scatter"), ("chunked", "scatter"))


def gathered_pmats_match(mesh, g, n_steps: int) -> bool:
    """column_pmats against an AllGather over `model` of each micro-batch
    of this rank's own P."""
    pm = torch.as_tensor(projection_matrices(g))
    mine = local_projections(pm, mesh)
    nb = mine.shape[0] // n_steps
    group = mesh.get_group("model")
    want = column_pmats(pm, mesh, n_steps)
    for s in range(n_steps):
        out = torch.empty((dist.get_world_size(group) * nb,) + pm.shape[1:])
        dist.all_gather_into_tensor(
            out, mine[s * nb:(s + 1) * nb].contiguous(), group=group)
        if not torch.equal(out, want[s]):
            return False
    return True


def main(rank: int, world: int, init_file: str, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, device_type="cpu")
        g = default_geometry(N, n_proj=N_PROJ)
        local = torch.as_tensor(local_projections(
            np.load(os.path.join(work, "proj.npy")), mesh))
        volumes, shapes = {}, {}
        for name, kw in CASES.items():
            plan = ReconstructionPlan(geometry=g, mesh=mesh, device="cpu",
                                      **kw)
            out = plan.build()(local)
            shapes[name] = list(out.shape)
            volumes[name] = assemble_volume(out, mesh, plan.reduce).reshape(
                g.volume_shape()).numpy()
        for sched, red in TRACED:
            plan = ReconstructionPlan(geometry=g, mesh=mesh, device="cpu",
                                      schedule=sched, reduce=red,
                                      **SCHEDULES[sched])
            volumes[f"traced/{sched}/{red}"] = assemble_volume(
                plan.build_traced()(local), mesh, red).numpy()
        errors = {}
        for key, geom in (("np_ranks", default_geometry(N, n_proj=30)),
                          ("nx_slabs", default_geometry(17, n_proj=N_PROJ))):
            try:
                ReconstructionPlan(geometry=geom, mesh=mesh,
                                   device="cpu").validate()
                errors[key] = ""
            except ValueError as e:
                errors[key] = str(e)
        polls = {}
        for red in SESSIONS:
            plan = ReconstructionPlan(geometry=g, mesh=mesh, device="cpu",
                                      schedule="incremental", n_steps=4,
                                      reduce=red)
            sess = plan.build_incremental(
                source=ProjectionSource(os.path.join(work, "stream")),
                sink=VolumeSink(os.path.join(work, f"sink_{red}")))
            polls[red] = sess.poll()
            volumes[f"incremental/{red}"] = assemble_volume(
                sess.finalize(), mesh, red).reshape(g.volume_shape()).numpy()
        src = ProjectionSource(os.path.join(work, "stream"))
        same = torch.tensor([float(
            all(gathered_pmats_match(mesh, g, n) for n in (1, 2))),
            float(torch.equal(src.load(mesh, device="cpu"), local))])
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
        if rank == 0:
            np.savez(os.path.join(work, "volumes.npz"), **{
                k.replace("/", "__"): v for k, v in volumes.items()})
            with open(os.path.join(work, "meta.json"), "w") as f:
                json.dump({"shapes": shapes, "errors": errors,
                           "column_pmats": bool(same[0]),
                           "load_is_local": bool(same[1]),
                           "polls": polls}, f)
    finally:
        dist.destroy_process_group()


CKPT_LEAVES = {"slab": ["model"], "scattered": ["model", "data"]}


def checkpoint_save(rank: int, world: int, init_file: str, work: str) -> None:
    """Reconstruct WORK_DIR/proj.npy on the (1, 2, 2) mesh (fused, kernel)
    under psum and under scatter, and save each rank's part as a step-1
    checkpoint in WORK_DIR/ckpt, with the layout of each leaf's spec in
    CKPT_LEAVES, plus a host scalar. Each rank then loads the checkpoint
    back on the same mesh; rank 0 writes the assembled volumes to
    WORK_DIR/assembled.npz, and each rank whether its loaded parts equal
    its own and the shard files it opened to WORK_DIR/save_rank<R>.json."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.io import shard_store

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 2, 2), MESH_AXES, device_type="cpu")
        g = default_geometry(N, n_proj=N_PROJ)
        local = torch.as_tensor(local_projections(
            np.load(os.path.join(work, "proj.npy")), mesh))
        parts, volumes = {}, {}
        for leaf, red in (("slab", "psum"), ("scattered", "scatter")):
            plan = ReconstructionPlan(geometry=g, mesh=mesh, impl="kernel",
                                      reduce=red, device="cpu")
            assert plan.output_spec() == CKPT_LEAVES[leaf]
            parts[leaf] = plan.build()(local)
            volumes[leaf] = assemble_volume(parts[leaf], mesh, red).numpy()
        tree = {"cursor": np.int64(3)}
        tree.update({k: shard_store.snapshot(v, mesh, CKPT_LEAVES[k])
                     for k, v in parts.items()})
        save_checkpoint(os.path.join(work, "ckpt"), 1, tree)
        shard_store.reset_open_count()
        back = load_checkpoint(os.path.join(work, "ckpt"), 1, tree,
                               mesh=mesh, device="cpu")
        report = {"opened": shard_store.open_count(),
                  "equal": all(torch.equal(back[k], parts[k])
                               for k in parts),
                  "cursor": int(back["cursor"])}
        if rank == 0:
            np.savez(os.path.join(work, "assembled.npz"), **volumes)
        with open(os.path.join(work, f"save_rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def checkpoint_load(rank: int, world: int, init_file: str, work: str) -> None:
    """Restore WORK_DIR/ckpt step 1 on a (1, 1, 2) mesh of 2 ranks (an
    elastic restart from 4): each rank writes the parts it read to
    WORK_DIR/load_rank<R>.npz and the shard files it opened to
    WORK_DIR/load_rank<R>.json."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.io import shard_store

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1, 2), MESH_AXES, device_type="cpu")
        shape = default_geometry(N, n_proj=N_PROJ).volume_shape()
        like = {"cursor": np.int64(0)}
        like.update({k: torch.empty(shape, device="meta")
                     for k in CKPT_LEAVES})
        shard_store.reset_open_count()
        out = load_checkpoint(os.path.join(work, "ckpt"), 1, like,
                              mesh=mesh, device="cpu")
        np.savez(os.path.join(work, f"load_rank{rank}.npz"),
                 **{k: v.numpy() for k, v in out.items()})
        with open(os.path.join(work, f"load_rank{rank}.json"), "w") as f:
            json.dump({"opened": shard_store.open_count(),
                       "coord": list(mesh.get_coordinate())}, f)
    finally:
        dist.destroy_process_group()


def _flatten(tree, prefix):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flatten(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def _unflatten(flat, prefix):
    out = {}
    for key, v in flat.items():
        if key.startswith(prefix + "/"):
            *path, name = key[len(prefix) + 1:].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[name] = v
    return out


def lm(rank: int, world: int, init_file: str, work: str) -> None:
    """The port's side of tests/test_torch_parallel_lm.py: for each arch of
    WORK/lm.json ("archs"), the weights and batch of WORK/inputs_<ARCH>.npz
    run sharded under `ShardingRules(mesh)` on the (data, model) mesh of
    its "mesh" shape: prefill (also under fsdp=False), two decode steps,
    loss_fn, its gradients (`loss_and_grads`) and one train step of 2
    micro-batches with warmup 1 from second moments of 1, as
    `_jax_mesh_lm.py` runs the reference. Every output is gathered whole
    (`full`) and rank 0 writes WORK/port_<ARCH>.npz. Then the collectives
    on a (pod 2, data 2) mesh over the same ranks: each rank's block of
    WORK/collectives_in.npy through `hierarchical_psum`,
    `hierarchical_psum_scatter` and `psum_tree`, every rank writing
    WORK/port_collectives_<rank>.npz. WORK/lm_<rank>.json records the local
    shapes of the sharded weights and the error a sharded checkpoint
    raises, the (token, choice) pairs the MoE's capacity dropped in the
    prefill, over all ranks, and whether DTensor's collectives were
    rerouted (only a CUDA mesh over gloo
    reroutes them)."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import _leaves
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import ShardingRules, full
    from repro_torch.training.train_step import (
        loss_and_grads, make_train_step, train_state_from_reference)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    report = {}
    try:
        with open(os.path.join(work, "lm.json")) as f:
            spec = json.load(f)
        mesh = make_mesh(spec["mesh"], ("data", "model"), device_type="cpu")
        rules = ShardingRules(mesh=mesh)
        report["rerouted"] = bool(getattr(funcol.all_reduce, "blocking",
                                          False))
        for arch in spec["archs"]:
            name, _, cf = arch.partition("@")   # NAME or NAME@CF
            cfg = get_smoke_config(name).scaled(dtype="float32")
            if cf:
                cfg = cfg.scaled(moe=dataclasses.replace(
                    cfg.moe, capacity_factor=float(cf)))
            inputs = dict(np.load(os.path.join(work, f"inputs_{arch}.npz")))
            np_params = _unflatten(inputs, "params")
            tokens = torch.from_numpy(inputs["tokens"]).long()
            out = {}
            for name, r in (("", rules),
                            ("nofsdp_", ShardingRules(mesh=mesh,
                                                      fsdp=False))):
                params = T.params_from_reference(np_params, cfg, "cpu", r)
                logits, cache = T.prefill(params, cfg, {"tokens": tokens}, r)
                out[f"{name}prefill_logits"] = full(logits)
            params = T.params_from_reference(np_params, cfg, "cpu", rules)
            report[arch] = {"local_embed": list(
                params["embed"].to_local().shape)}
            routed, route = [], M.route
            M.route = lambda *a: routed.append(route(*a)) or routed[-1]
            try:
                logits, cache = T.prefill(params, cfg, {"tokens": tokens},
                                          rules)
            finally:
                M.route = route
            dropped = torch.tensor(sum(int((~r.keep).sum())
                                       for r in routed))
            dist.all_reduce(dropped)
            report[arch]["dropped"] = int(dropped)
            out.update({k: full(v) for k, v in
                        _flatten(cache, "cache").items()})
            s0, steps = tokens.shape[1], inputs["decode"].shape[1]
            cache = T.extend_cache(cfg, cache, s0 + steps)
            for i in range(steps):
                tok = torch.from_numpy(inputs["decode"][:, i:i + 1]).long()
                logits, cache = T.decode_step(params, cfg, cache, tok,
                                              s0 + i, rules)
                out[f"decode_logits_{i}"] = full(logits)
            batch = {"tokens": tokens,
                     "labels": torch.from_numpy(inputs["labels"]).long()}
            loss, parts = T.loss_fn(params, cfg, batch, rules)
            out["loss"], out["ce"], out["aux"] = (
                full(loss), full(parts["ce"]), full(parts["aux"]))
            _, grads = loss_and_grads(params, cfg, batch, rules)
            out.update({k: full(v) for k, v in
                        _flatten(grads, "grads").items()})
            del grads
            zeros = {k: np.zeros_like(v) for k, v in inputs.items()
                     if k.startswith("params/")}
            ones = {k: np.ones_like(v) for k, v in zeros.items()}
            state = train_state_from_reference(
                (np_params, (np.int32(0), _unflatten(zeros, "params"),
                             _unflatten(ones, "params"))), cfg, "cpu", rules)
            new, metrics = make_train_step(cfg, rules=rules, microbatches=2,
                                           warmup=1)(state, batch)
            out.update({f"metric_{k}": v for k, v in metrics.items()})
            out.update({k: full(v).detach() for k, v in
                        _flatten(new.params, "trained").items()})
            out.update({k: full(v) for k, v in
                        _flatten(new.opt.mu, "mu").items()})
            try:
                save_checkpoint(os.path.join(work, f"ckpt_{rank}"), 0,
                                {"w": _leaves(new.params)[0]})
            except NotImplementedError as e:
                report[arch]["checkpoint"] = str(e)
            if rank == 0:
                np.savez(os.path.join(work, f"port_{arch}.npz"),
                         **{k: v.numpy() for k, v in out.items()})
        pd = make_mesh((2, 2), ("pod", "data"), device_type="cpu")
        x = np.load(os.path.join(work, "collectives_in.npy"))
        block = torch.from_numpy(np.split(x, world)[rank].copy())
        np.savez(os.path.join(work, f"port_collectives_{rank}.npz"),
                 psum=C.hierarchical_psum(block, pd, scatter_dim=1).numpy(),
                 psum_no_pod=C.hierarchical_psum(
                     block, pd, scatter_dim=1, have_pod=False).numpy(),
                 psum_scatter=C.hierarchical_psum_scatter(
                     block, pd, scatter_dim=1).numpy(),
                 psum_tree=C.psum_tree({"g": block}, pd, ("pod",))["g"]
                 .numpy())
    finally:
        with open(os.path.join(work, f"lm_{rank}.json"), "w") as f:
            json.dump(report, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    mode = sys.argv[5] if len(sys.argv) > 5 else "mesh"
    {"mesh": main, "checkpoint-save": checkpoint_save,
     "checkpoint-load": checkpoint_load, "lm": lm}[mode](
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
