"""Fault tolerance for long-running jobs.

Port of `repro/runtime/fault_tolerance.py`. Three mechanisms:

1. `ResumableReconstruction` — the CT pipeline checkpoints its partial-volume
   accumulator plus the projection cursor, so a reconstruction killed at any
   micro-batch boundary restarts mid-stream (the FDK accumulation is a plain
   sum over projection batches -> resumable by construction).

2. `restart_loop` — generic supervised execution: run a step function,
   checkpoint every K steps, and on failure restore the latest committed
   checkpoint and continue; tolerates a bounded number of failures per
   window (crash-loop guard).

3. `StragglerMonitor` — EMA of per-step wall time; steps slower than
   `threshold` x EMA are flagged. In an SPMD job a persistent straggler is
   indistinguishable from a slow step on *every* rank (lock-step), so the
   mitigation is topological: the monitor recommends re-slicing the
   over-decomposed projection/microbatch axis (cheap, no state movement) or
   excluding a failed slice of the mesh at the next restart boundary
   (elastic re-mesh via checkpoint/io's mesh-agnostic restore).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..obs.trace import wait_for


@dataclasses.dataclass
class ReconState:
    """Checkpointable reconstruction progress."""

    cursor: int                 # next projection micro-batch index
    accumulator: torch.Tensor   # partial (unscaled) volume, rank-local layout


class ResumableReconstruction:
    """Drives an FDK reconstruction in resumable micro-batch chunks.

    `step_fn(acc, batch_index)` must return `acc` plus the batch's
    back-projection, leaving `acc` itself unchanged; `n_batches` is the
    over-decomposition factor. A restored accumulator lands on the device
    of `init_acc`.
    """

    def __init__(self, step_fn: Callable[[torch.Tensor, int], torch.Tensor],
                 init_acc: torch.Tensor, n_batches: int,
                 manager: Optional[CheckpointManager] = None,
                 checkpoint_every: int = 0):
        self.step_fn = step_fn
        self.n_batches = n_batches
        self.manager = manager
        self.checkpoint_every = checkpoint_every
        self.state = ReconState(cursor=0, accumulator=init_acc)

    def resume(self) -> None:
        if self.manager is None:
            return
        acc = self.state.accumulator
        like = {"cursor": np.int64(0), "acc": acc}
        step, tree = self.manager.restore_latest(like, device=acc.device)
        if tree is not None:
            self.state = ReconState(
                cursor=int(tree["cursor"]), accumulator=tree["acc"])

    def run(self, fail_at: Optional[int] = None) -> torch.Tensor:
        """Process remaining batches; `fail_at` injects a fault (tests)."""
        while self.state.cursor < self.n_batches:
            b = self.state.cursor
            if fail_at is not None and b == fail_at:
                raise RuntimeError(f"injected failure at batch {b}")
            acc = self.step_fn(self.state.accumulator, b)
            self.state = ReconState(cursor=b + 1, accumulator=acc)
            if (self.manager is not None and self.checkpoint_every
                    and (b + 1) % self.checkpoint_every == 0):
                self.manager.save(
                    b + 1,
                    {"cursor": np.int64(b + 1), "acc": acc},
                    blocking=True,
                )
        return self.state.accumulator


def restart_loop(make_state, step_fn, n_steps: int,
                 manager: CheckpointManager,
                 checkpoint_every: int = 10,
                 max_failures: int = 3,
                 fail_at: Optional[set] = None,
                 device="cuda"):
    """Supervised loop with checkpoint/restart.

    make_state() -> state pytree; step_fn(state, step) -> state.
    `fail_at` is a set of (step) fault injections consumed once each. A
    restored state's leaves land on `device`.
    """
    fail_at = set(fail_at or ())
    failures = 0
    state = make_state()
    restored, tree = manager.restore_latest(state, device=device)
    start = 0
    if tree is not None:
        state, start = tree, restored
    step = start
    while step < n_steps:
        try:
            if step in fail_at:
                fail_at.discard(step)
                raise RuntimeError(f"injected failure at step {step}")
            state = step_fn(state, step)
            step += 1
            if step % checkpoint_every == 0:
                manager.save(step, state, blocking=True)
        except Exception:
            failures += 1
            if failures > max_failures:
                raise
            restored, tree = manager.restore_latest(state, device=device)
            if tree is None:
                state, step = make_state(), 0
            else:
                state, step = tree, restored
    manager.save(n_steps, state, blocking=True)
    return state


class StragglerMonitor:
    """Flags slow steps and recommends re-balancing (see module docstring)."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.2):
        self.threshold = threshold
        self.alpha = alpha
        self.ema: Optional[float] = None
        self.flagged: list[tuple[int, float]] = []
        self._step = 0

    def record(self, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        straggler = False
        if self.ema is not None and seconds > self.threshold * self.ema:
            self.flagged.append((self._step, seconds))
            straggler = True
            # do not pollute the EMA with outliers
        else:
            self.ema = (seconds if self.ema is None
                        else self.alpha * seconds + (1 - self.alpha) * self.ema)
        self._step += 1
        return straggler

    def timed(self, fn, *args):
        """(fn(*args), whether the step straggled): the step's time runs
        until every CUDA tensor of the output is computed."""
        t0 = time.perf_counter()
        out = fn(*args)
        wait_for(out)
        return out, self.record(time.perf_counter() - t0)

    def rebalance_hint(self, n_batches: int, n_ranks: int) -> dict:
        """Suggested over-decomposition after observed stragglers."""
        factor = 2 if self.flagged else 1
        return {
            "micro_batches": min(n_batches * factor, max(n_batches, n_ranks * 4)),
            "flagged_steps": list(self.flagged),
        }
