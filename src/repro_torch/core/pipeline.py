"""Software-pipelined distributed FDK (paper §4.1.4, Fig. 4) — legacy API.

Port of `repro/core/pipeline.py`. The paper overlaps load/filter,
AllGather and back-projection with circular buffers; the engine's
pipelined schedule issues the AllGather of micro-batch s asynchronously
before it back-projects micro-batch s-1 (core/plan.py). Both builders here
are deprecated-but-stable thin wrappers over `ReconstructionPlan`.
"""
from __future__ import annotations

from typing import Callable, Literal

from .fdk import BpImpl, warn_deprecated_once
from .geometry import CBCTGeometry
from .plan import ReconstructionPlan, shift_pmats_j  # noqa: F401 (re-export)
from .precision import Precision


def make_chunked_fdk(mesh, g: CBCTGeometry,
                     n_steps: int = 2, y_chunks: int = 16,
                     impl: BpImpl = "factorized",
                     window: str = "ramlak",
                     precision: Precision | str | None = "fp32",
                     device: str = "cuda") -> Callable:
    """y-chunked back-projection with a per-chunk reduce-scatter over
    `data`. Each rank returns the (N_x/R, y_chunks, N_y/y_chunks/C_data,
    N_z) store layout.

    Deprecated-but-stable alias for
    ``ReconstructionPlan(..., schedule="chunked", reduce="scatter")``.
    """
    warn_deprecated_once(
        "make_chunked_fdk",
        'ReconstructionPlan(..., schedule="chunked", reduce="scatter")'
        '.build()')
    return ReconstructionPlan(
        geometry=g, mesh=mesh, impl=impl, window=window,
        schedule="chunked", n_steps=n_steps, y_chunks=y_chunks,
        reduce="scatter", precision=precision, device=device,
    ).build()


def make_pipelined_fdk(mesh, g: CBCTGeometry,
                       n_steps: int = 4,
                       impl: BpImpl = "factorized",
                       window: str = "ramlak",
                       reduce: Literal["psum", "scatter",
                                       "scatter_bf16"] = "scatter",
                       precision: Precision | str | None = "fp32",
                       device: str = "cuda") -> Callable:
    """Pipelined reconstruction; same interface as make_distributed_fdk.

    Deprecated-but-stable alias for
    ``ReconstructionPlan(..., schedule="pipelined").build()``.
    """
    warn_deprecated_once(
        "make_pipelined_fdk",
        'ReconstructionPlan(..., schedule="pipelined").build()')
    return ReconstructionPlan(
        geometry=g, mesh=mesh, impl=impl, window=window,
        schedule="pipelined", n_steps=n_steps, reduce=reduce,
        precision=precision, device=device,
    ).build()
