"""Faults planted underneath the timed path, each of which the check has
to catch (`correct` false). The tests drive whole runs with each planted.

  answer_altered    a block of voxels of each bucket's first volume changed
                    where the batched engine produces it
  half_projections  every back-projection takes every other projection
                    and doubles the sum (the mean taken over half the batch)
  half_lanes        the upper half of each bucket's lanes answered with the
                    first lane's volume
  state_unchanged   every back-projection returns its accumulator as it
                    was initialised (zeros)

The program caches its engines per plan; each fault clears that cache on
entry and exit, so that it is built into the engines the run uses and
into no later run's.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch


def _plan_class():
    from repro_torch.core.plan import ReconstructionPlan, clear_engine_cache
    return ReconstructionPlan, clear_engine_cache


@contextlib.contextmanager
def _patched(name: str, make):
    cls, clear = _plan_class()
    clear()
    try:
        with mock.patch.object(cls, name, make(getattr(cls, name))):
            yield
    finally:
        clear()


def _engine_fault(edit):
    def make(orig):
        def build_batched(self, batch_size):
            engine = orig(self, batch_size)

            def broken(projections):
                out = engine(projections)
                edit(out)
                return out
            return broken
        return build_batched
    return _patched("build_batched", make)


def _backprojector_fault(wrap):
    def make(orig):
        def resolve(self):
            return wrap(orig(self))
        return resolve
    return _patched("_resolve_backprojector", make)


def answer_altered():
    def edit(out):
        n = max(1, out.shape[1] // 8)
        out[0, :n, :n, :n] += 0.01 * out[0].abs().max()
    return _engine_fault(edit)


def half_lanes():
    def edit(out):
        half = out.shape[0] // 2
        if half:
            out[out.shape[0] - half:] = out[0]
    return _engine_fault(edit)


def half_projections():
    def wrap(bp):
        def halved(pmats, proj, nx, ny, nz, scales=None):
            sc = None if scales is None else scales[::2]
            return 2.0 * bp(pmats[::2], proj[::2], nx, ny, nz, scales=sc)
        return halved
    return _backprojector_fault(wrap)


def state_unchanged():
    def wrap(bp):
        def unchanged(pmats, proj, nx, ny, nz, scales=None):
            return torch.zeros((nx, ny, nz), dtype=torch.float32,
                               device=proj.device)
        return unchanged
    return _backprojector_fault(wrap)


FAULTS = {"answer_altered": answer_altered, "half_lanes": half_lanes,
          "half_projections": half_projections,
          "state_unchanged": state_unchanged}
