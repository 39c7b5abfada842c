"""iFDK distributed decomposition (paper §4) — the part a single-device
plan needs.

Port of the `IFDKGrid` and `shift_pmats_i` pieces of
`repro/core/distributed.py`. The rank grid, the column AllGather and the
row Reduce over `torch.distributed` come with the mesh engine (ROADMAP
Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class IFDKGrid:
    """The paper's 2-D rank grid: R rows (volume slabs) x C columns."""

    r: int
    c: int

    @property
    def n_ranks(self) -> int:
        return self.r * self.c


def shift_pmats_i(pmats: torch.Tensor, i0) -> torch.Tensor:
    """Reparameterize P for a volume slab starting at voxel index i0:
    P . [i + i0, j, k, 1]^T == P' . [i, j, k, 1]^T with
    P'[:, 3] = P[:, 3] + i0 * P[:, 0]."""
    out = pmats.clone()
    out[..., :, 3] += pmats[..., :, 0] * i0
    return out
