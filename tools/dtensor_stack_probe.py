"""`torch.stack` of DTensors laid out over their batch dim, along dim -1:
the layout DTensor gives the result, with whatever torch this machine has.

    PYTHONPATH=src python tools/dtensor_stack_probe.py [cpu|cuda]

Spawns 4 gloo ranks of a (data 2, model 2) mesh (default on the CPU;
"cuda": CUDA tensors on card 0, as `chip_smoke.py`'s `[lm-mesh]` ranks
share it). Each holds ids of global shape (4,) laid out (Shard(0),
Replicate()), the layout of `greedy_generate`'s next ids on that mesh,
stacks two of them along dim -1 and gathers the result whole. Rank 0
prints the torch version, the result's placements and its gathered shape
against the (4, 2) of the same stack on plain tensors; `greedy_generate`
gathers each step's ids before stacking them because of what torch 2.11
prints here. Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist


def rank_main(rank: int, init: str, device: str) -> None:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.parallel.mesh import make_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type=device)
        ids = torch.arange(4, device=device)
        rows = distribute_tensor(ids, mesh, [Shard(0), Replicate()])
        stacked = torch.stack([rows, rows], dim=-1)
        whole = stacked.full_tensor()
        want = torch.stack([ids, ids], dim=-1)
        if rank == 0:
            print(f"torch {torch.__version__}, {device}: stack of "
                  f"{tuple(rows.placements)} along dim -1 gives "
                  f"{tuple(stacked.placements)}; gathered "
                  f"{tuple(whole.shape)}, plain {tuple(want.shape)}, equal "
                  f"{whole.shape == want.shape and torch.equal(whole, want)}",
                  flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    device = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    init = os.path.join(tempfile.mkdtemp(), "pg")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r), init, device])
             for r in range(4)]
    codes = [p.wait(timeout=300) for p in procs]
    return max(codes)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
