"""One gloo rank for tests/test_torch_launch_dryrun.py ("dryrun") and
tests/test_torch_checkpoint_sharded.py ("checkpoint"), on a (data 2,
model 2) CPU mesh of 4 ranks.

    PYTHONPATH=src python tests/_torch_launch_rank.py RANK WORLD INIT_FILE WORK_DIR MODE

"dryrun": the smoke cells of `CELLS` (Qwen2-1.5B's prefill and train step
at B 4, S 16, 2 micro-batches) as the dry run builds them, run on real
CPU tensors (zeros, each rank's local part) under `launch.dryrun`'s
`TraceCounter`, and once more under `torch.utils.flop_counter`'s
FlopCounterMode. The rank takes the card's path through the model: the
device checks answer "on the card" and the attention operator gets a CPU
kernel, the plain version, so the program is the one the dry run traces.
Writes WORK/real_<rank>.json.

"checkpoint": the f32 smoke TrainState of Qwen2-1.5B under
`ShardingRules(mesh)` (the reference's init from WORK/state.npz, the
moments filled from it) is saved to WORK/port_ckpt, restored onto the
(2, 2) mesh (DTensor leaves as `like`), onto a (1, 4) mesh and onto a
(4, 1) mesh (`shardings=`); one train step from the restored state and
one from the live state; then the reference's checkpoint WORK/jax_ckpt
(written by tests/_jax_ckpt_lm.py, waited for) is restored onto (2, 2).
Rank 0 writes every state gathered whole to WORK/port_<name>.npz; every
rank writes WORK/ckpt_<rank>.json (equalities, the errors a Partial and
an uneven leaf raise).
"""
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import make_mesh

SEP = "/"
B, S, MB = 4, 16, 2
CELLS = {"prefill": ("prefill_32k", dict(kind="prefill", seq=S, batch=B)),
         "train": ("train_4k", dict(kind="train", seq=S, batch=B))}
JAX_DEADLINE_S = 120


def _flat(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{SEP}{key}").items()}
    return {prefix: tree}


def _unflatten(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + SEP):
            continue
        *path, name = key[len(prefix) + 1:].split(SEP)
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[name] = v
    return out


def dryrun(rank: int, work: str, mesh) -> None:
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import TraceCounter, local_inputs
    from repro_torch.models import layers

    for module in (layers, fak, bpk):      # the card's path
        module.on_card = lambda t: True
    torch.library.register_kernel(
        "repro_torch::flash_attention_fwd", "cpu",
        lambda q, k, v, causal, window: fak.flash_attention_bhsd_torch(
            q, k, v, causal=causal, window=window or None))
    cfg = get_smoke_config("qwen2_1_5b")
    report = {}
    for name, (shape, info) in CELLS.items():
        cell = build_cell("qwen2_1_5b", shape, mesh, cfg=cfg,
                          shape_info=info, microbatches=MB)
        counts = []
        for mode in (TraceCounter(gpus_per_node=2),
                     FlopCounterMode(display=False)):
            inputs = [local_inputs(a, s) for a, s in
                      zip(cell.args, cell.in_shardings)]
            with mode:
                cell.fn(*inputs)
            counts.append(mode)
        c, fc = counts
        report[name] = {"flops": c.flops, "by_group": c.by_group,
                        "kernel_calls": c.kernel_calls,
                        "flop_counter_mode": fc.get_total_flops()}
    with open(os.path.join(work, f"real_{rank}.json"), "w") as f:
        json.dump(report, f)


def checkpoint(rank: int, work: str, mesh) -> None:
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.checkpoint import (
        committed_steps, load_checkpoint, save_checkpoint)
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import OptState
    from repro_torch.optim.adamw import _leaves
    from repro_torch.parallel.sharding import ShardingRules, full
    from repro_torch.training.train_step import (
        TrainState, make_abstract_state, make_train_step, state_shardings,
        train_state_from_reference)

    cfg = get_smoke_config("qwen2_1_5b").scaled(dtype="float32")
    rules = ShardingRules(mesh=mesh)
    flat = dict(np.load(os.path.join(work, "state.npz")))
    params = _unflatten(flat, "params")
    state = train_state_from_reference(
        (params, (np.int32(3), _unflatten(flat, "mu"),
                  _unflatten(flat, "nu"))), cfg, "cpu", rules)
    report = {}

    def whole(tree):
        return {k: full(v).detach().numpy() for k, v in _flat(tree).items()}

    def dump(name, tree):
        if rank == 0:
            np.savez(os.path.join(work, f"port_{name}.npz"), **whole(tree))
        else:
            whole(tree)    # every rank joins the gathers

    def equal_locals(a, b):
        return all(torch.equal(x.to_local() if isinstance(x, DTensor) else x,
                               y.to_local() if isinstance(y, DTensor) else y)
                   for x, y in zip(_flat(a).values(), _flat(b).values()))

    ckpt = os.path.join(work, "port_ckpt")
    save_checkpoint(ckpt, 1, state)
    dump("saved", state)
    back = load_checkpoint(ckpt, 1, state, device="cpu")
    report["dtensor_leaves"] = all(isinstance(v, DTensor) for k, v in
                                   _flat(back).items()
                                   if not k.endswith("step"))
    report["restored_2x2_bit_equal"] = equal_locals(back, state)
    for shape in ((1, 4), (4, 1)):
        other = make_mesh(shape, ("data", "model"), device_type="cpu")
        sh = state_shardings(cfg, ShardingRules(mesh=other))
        sh = sh._replace(opt=sh.opt._replace(step=None))
        moved = load_checkpoint(ckpt, 1, make_abstract_state(cfg),
                                device="cpu", shardings=sh)
        report[f"placements_{shape[0]}x{shape[1]}"] = [
            str(v.placements) for v in _leaves(moved.params)][:3]
        dump(f"restored_{shape[0]}x{shape[1]}", moved)
    whole_state = load_checkpoint(ckpt, 1, make_abstract_state(cfg),
                                  device="cpu")
    report["whole_is_plain"] = not any(isinstance(v, DTensor) for v in
                                       _flat(whole_state).values())
    if rank == 0:
        np.savez(os.path.join(work, "port_whole.npz"),
                 **{k: v.numpy() for k, v in _flat(whole_state).items()})

    # one train step from the restored state, one from the live state
    tokens = torch.from_numpy(flat["tokens"]).long()
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    step = make_train_step(cfg, rules=rules, microbatches=MB, warmup=1)
    resumed, m_resumed = step(back, batch)
    live, m_live = step(state, batch)
    report["resumed_step_bit_equal"] = equal_locals(resumed, live) and all(
        torch.equal(m_resumed[k], m_live[k]) for k in m_live)

    # what the checkpoint refuses: a Partial leaf, an uneven one
    for name, leaf in (
            ("partial", DTensor.from_local(torch.ones(4), mesh,
                                           [Partial(), Partial()])),
            ("uneven", DTensor.from_local(
                torch.ones(3 if mesh.get_coordinate()[0] == 0 else 2),
                mesh, [Shard(0), Replicate()], shape=torch.Size([5]),
                stride=(1,)))):
        try:
            save_checkpoint(os.path.join(work, f"bad_{name}"), 0,
                            {"w": leaf})
            report[f"{name}_raises"] = None
        except ValueError as e:
            report[f"{name}_raises"] = str(e)

    # the reference's checkpoint, restored onto this mesh
    deadline = time.monotonic() + JAX_DEADLINE_S
    jax_ckpt = os.path.join(work, "jax_ckpt")
    while not committed_steps(jax_ckpt):
        if time.monotonic() > deadline:
            raise TimeoutError("the reference's checkpoint did not appear")
        time.sleep(0.2)
    like = TrainState(state.params, OptState(
        torch.zeros((), dtype=torch.int32), state.opt.mu, state.opt.nu))
    from_jax = load_checkpoint(jax_ckpt, 1, like, device="cpu")
    dump("from_jax", from_jax)
    with open(os.path.join(work, f"ckpt_{rank}.json"), "w") as f:
        json.dump(report, f)


def main(rank: int, world: int, init_file: str, work: str,
         mode: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        {"dryrun": dryrun, "checkpoint": checkpoint}[mode](rank, work, mesh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
