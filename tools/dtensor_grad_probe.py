"""Gradients of a cross entropy over a vocab-sharded logits DTensor,
DTensor's own reduction against the port's explicit one.

    PYTHONPATH=src python tools/dtensor_grad_probe.py [cpu|cuda]

Spawns 4 gloo ranks of a (data 2, model 2) mesh (default on the CPU;
"cuda": CUDA tensors on card 0, as `chip_smoke.py`'s `[lm-mesh]` ranks
share it). Each holds x (batch over data), the tied head E (vocab over
model) and a norm scale s (replicated), and takes the gradients of three
losses over logits = (x * (1 + s)) @ E.T:

  dtensor   sum(log(sum(exp(logits), -1))), every op on the DTensor;
  port lse  sum(transformer._logsumexp(logits)), the port's sharded
            logsumexp (local sums, `sharding.summed`);
  port ce   mean(_logsumexp - _label_logits), the port's cross entropy.

Rank 0 prints the torch version and, per loss, the relative error of the
loss and of the gradients of x, E and s against the same program on plain
tensors. Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

B, S, D, V = 2, 4, 8, 6


def rel(got, want) -> float:
    from torch.distributed.tensor import DTensor

    if isinstance(got, DTensor):
        got = got.full_tensor()
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


def losses(T, labels):
    return {
        "dtensor": lambda lg: torch.log(torch.sum(torch.exp(lg), -1)).sum(),
        "port lse": lambda lg: T._logsumexp(lg).sum(),
        "port ce": lambda lg: (T._logsumexp(lg)
                               - T._label_logits(lg, labels)).mean(),
    }


def rank_main(rank: int, init: str, device: str) -> None:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import transformer as T
    from repro_torch.parallel.mesh import make_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type=device)
        g = torch.Generator().manual_seed(0)
        x0, e0 = torch.randn(B, S, D, generator=g), torch.randn(V, D,
                                                                 generator=g)
        s0 = 0.1 * torch.randn(D, generator=g)
        labels = torch.randint(0, V, (B, S), generator=g).to(device)
        x0, e0, s0 = x0.to(device), e0.to(device), s0.to(device)
        lines = [f"torch {torch.__version__}, {device}"]
        for name, loss in losses(T, labels).items():
            plain = [t.clone().requires_grad_() for t in (x0, e0, s0)]
            want_loss = loss((plain[0] * (1.0 + plain[2])) @ plain[1].T)
            want = torch.autograd.grad(want_loss, plain)
            x, e, s = (distribute_tensor(t, mesh, pl).requires_grad_()
                       for t, pl in ((x0, [Shard(0), Replicate()]),
                                     (e0, [Replicate(), Shard(0)]),
                                     (s0, [Replicate(), Replicate()])))
            got_loss = loss((x * (1.0 + s)) @ e.T)
            got = torch.autograd.grad(got_loss, [x, e, s])
            lines.append(
                f"{name}: loss {rel(got_loss, want_loss):.1e}, gradient of "
                f"x {rel(got[0], want[0]):.1e}, E {rel(got[1], want[1]):.1e}"
                f", s {rel(got[2], want[2]):.1e} (relative)")
        if rank == 0:
            print("\n".join(lines), flush=True)
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
