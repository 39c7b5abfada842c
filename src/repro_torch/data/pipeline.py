"""Data pipelines: synthetic LM token streams and CT projection sources.

Port of `repro/data/pipeline.py`. `batch_specs(cfg, batch, seq)` is the
one source of model input shapes; it returns `TensorSpec`s (shape, dtype)
where the reference returns `jax.ShapeDtypeStruct`s, with the same names,
shapes and dtypes.

The CT `ProjectionSource` mimics the paper's PFS loading: projections are
delivered in micro-batches, numpy in and numpy out, with an
injectable-latency hook used by the straggler tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def batch_specs(cfg: ModelConfig, batch: int,
                seq: int) -> Dict[str, TensorSpec]:
    """Training-batch specs for an architecture: tokens and labels (B, S)
    int32, (B, K, S) over K codebooks for audio; vision adds bf16
    patch_embeds (B, num_positions, d_frontend)."""
    specs = {}
    if cfg.frontend is not None and cfg.frontend.modality == "audio":
        k = cfg.frontend.num_positions
        specs["tokens"] = TensorSpec((batch, k, seq), torch.int32)
        specs["labels"] = TensorSpec((batch, k, seq), torch.int32)
    else:
        specs["tokens"] = TensorSpec((batch, seq), torch.int32)
        specs["labels"] = TensorSpec((batch, seq), torch.int32)
    if cfg.frontend is not None and cfg.frontend.modality == "vision":
        specs["patch_embeds"] = TensorSpec(
            (batch, cfg.frontend.num_positions, cfg.frontend.d_frontend),
            torch.bfloat16)
    return specs


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A random batch matching `batch_specs`, drawn from `generator` on its
    device in sorted name order: ids uniform in [0, vocab_size), embeddings
    standard normal drawn in f32 and cast. The values are not bit-equal to
    the reference's `jax.random` draws; tests that compare the packages
    feed both the same arrays."""
    dev = generator.device
    out = {}
    for name, spec in sorted(batch_specs(cfg, batch, seq).items()):
        if spec.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(spec.shape, generator=generator,
                                    device=dev,
                                    dtype=torch.float32).to(spec.dtype)
    return out


def step_seed(seed: int, step: int) -> int:
    """The generator seed of (seed, step): the first 64 bits of numpy's
    SeedSequence((seed, step)), which mixes both (a resumed job at step k
    draws what an uninterrupted one drew there)."""
    words = np.random.SeedSequence((seed, step)).generate_state(2, np.uint32)
    return int(words[0]) | int(words[1]) << 32


class SyntheticTokens:
    """Deterministic, restartable synthetic LM stream (seeded per step).

    batch(step) is a pure function of (seed, step): a fresh
    torch.Generator on `device`, seeded with `step_seed(seed, step)`, so a
    resumed job sees the identical stream (the data-pipeline half of
    reproducible recovery)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 device="cuda"):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.device = resolve_device(device)

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, step))
        return synthetic_batch(self.cfg, self.batch, self.seq, gen)


@dataclasses.dataclass
class ProjectionSource:
    """Streams projection micro-batches (the paper's PFS read path)."""

    projections: np.ndarray          # (N_p, N_v, N_u)
    micro_batch: int
    latency_s: float = 0.0           # injectable per-batch latency (tests)

    def __post_init__(self):
        if self.projections.shape[0] % self.micro_batch:
            raise ValueError("N_p must divide by the micro batch")

    @property
    def n_batches(self) -> int:
        return self.projections.shape[0] // self.micro_batch

    def batch(self, idx: int) -> np.ndarray:
        if self.latency_s:
            time.sleep(self.latency_s)
        lo = idx * self.micro_batch
        return self.projections[lo:lo + self.micro_batch]

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self.n_batches):
            yield self.batch(i)
