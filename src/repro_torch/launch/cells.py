"""Dry-run cell construction: (arch x input-shape) -> a function and its
abstract inputs.

Port of `repro/launch/cells.py`. `input_specs()` gives (shape, dtype)
stand-ins for every model input (no storage); `build_cell()` pairs them
with the step function (the port's `prefill`, `decode_step` or
`make_train_step` under the cell's `ShardingRules`) and the Shardings of
its inputs. Parameters, train states and caches are meta tensors, laid
out by `param_shardings`, `state_shardings` and `cache_specs`; the dry run
(`launch/dryrun.py`) turns each into this rank's fake local part. Every
batch entry is laid out over dp on its leading (batch) dim, as the
reference's `in_shardings` lay it out: each rank is fed its own rows. The
optimizer's step is whole on every rank (its Sharding is None: the
port's step is a plain 0-d tensor). The same specs drive the smoke tests
(reduced sizes) via `data.pipeline.batch_specs`.

`inference_fsdp` keeps the reference's rule with the TPU figures made
parameters: the tensor-parallel degree is the mesh's `model` axis, and
the budget half of one card's memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import get_config
from ..data.pipeline import TensorSpec, batch_specs
from ..models.config import ModelConfig, count_params
from ..models.transformer import (
    abstract_params, cache_specs, decode_step, param_shardings, prefill,
)
from ..parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_POD
from ..parallel.sharding import ShardingRules, mesh_axes
from ..training.train_step import (
    make_abstract_state, make_train_step, state_shardings,
)
from .roofline import GPUS_PER_NODE, HBM_BYTES

# The assigned input-shape sets (LM transformer shapes).
SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
}

# Microbatch count for train cells (grad accumulation): sized so a
# per-rank microbatch holds ~1 row on the single-group mesh.
TRAIN_MICROBATCHES = 8


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    fn: Callable
    args: Tuple
    in_shardings: Tuple
    skip_reason: Optional[str] = None


def cell_is_applicable(cfg: ModelConfig, shape: str) -> Optional[str]:
    """Returns a skip reason or None (the reference's reasons)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: no sub-quadratic path at 500k "
                "(skip per assignment; see DESIGN.md §Arch-applicability)")
    return None


def input_specs(cfg: ModelConfig, shape: str,
                shape_info: Optional[Dict[str, Any]] = None
                ) -> Dict[str, TensorSpec]:
    """(shape, dtype) stand-ins for the cell's model inputs (`shape_info`
    replaces SHAPES[shape])."""
    info = SHAPES[shape] if shape_info is None else shape_info
    if info["kind"] == "train" or info["kind"] == "prefill":
        return batch_specs(cfg, info["batch"], info["seq"])
    # decode: one new token against a seq_len-deep cache
    b = info["batch"]
    if cfg.frontend is not None and cfg.frontend.modality == "audio":
        tok = TensorSpec((b, cfg.frontend.num_positions, 1), torch.int32)
    else:
        tok = TensorSpec((b, 1), torch.int32)
    return {"tokens": tok}


def card_memory_bytes() -> float:
    """One card's memory: the card's own figure when there is one, else
    the 80 GB datasheet figure."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


def inference_fsdp(cfg: ModelConfig, tp: int = GPUS_PER_NODE,
                   hbm_budget: Optional[float] = None) -> bool:
    """Serving replicates params over data ranks when the TP shard fits
    `hbm_budget` (default: half of one card's memory); models too big for
    a TP shard keep FSDP sharding and pay the gather."""
    if hbm_budget is None:
        hbm_budget = card_memory_bytes() / 2
    return count_params(cfg) * 2.0 / tp > hbm_budget


def _tp(mesh) -> int:
    if mesh is None:
        return 1
    return mesh_axes(mesh).get(AXIS_MODEL, 1)


def make_rules(cfg: ModelConfig, shape: str, mesh,
               strategy: str = "baseline",
               fsdp: Optional[bool] = None,
               hbm_budget: Optional[float] = None) -> ShardingRules:
    """Sharding strategy for a cell (the reference's).

    baseline  — ZeRO-3 gather-at-use for everything (incl. MoE experts),
                TP over `model`, FSDP over (pod, data).
    optimized — MoE experts stay EP-sharded (tokens move, not weights);
                decode skips the ZeRO-3 gather; small/mid dense models
                fold `model` into the FSDP axes.

    `hbm_budget` is `inference_fsdp`'s, whose TP degree is the mesh's
    `model` axis.
    """
    info = SHAPES[shape]
    if fsdp is None:
        fsdp = True if info["kind"] == "train" else inference_fsdp(
            cfg, _tp(mesh), hbm_budget)
    if strategy == "baseline":
        return ShardingRules(mesh=mesh, fsdp=fsdp, zero3_gather=True,
                             gather_moe_experts=True)
    if info["kind"] == "decode":
        return ShardingRules(mesh=mesh, fsdp=fsdp, zero3_gather=False,
                             gather_moe_experts=False,
                             decode_feature_shard=fsdp)
    small_dense = cfg.moe is None and count_params(cfg) < 40e9
    fsdp_axes = ((AXIS_POD, AXIS_DATA, AXIS_MODEL) if small_dense
                 else (AXIS_POD, AXIS_DATA))
    return ShardingRules(mesh=mesh, fsdp=fsdp, zero3_gather=True,
                         gather_moe_experts=False, fsdp_axes=fsdp_axes)


def strategy_microbatches(cfg: ModelConfig, strategy: str) -> int:
    """Grad-accumulation depth per strategy: weight-gather wire scales
    with microbatch count, so the optimized strategy accumulates as
    little as activation memory allows — dense full-DP models take the
    whole batch in one microbatch, MoE models take 4."""
    if strategy == "baseline":
        return TRAIN_MICROBATCHES
    if cfg.moe is None and count_params(cfg) < 40e9:
        return 1
    return 4


def build_cell(arch: str, shape: str, mesh, fsdp: Optional[bool] = None,
               microbatches: Optional[int] = None,
               strategy: str = "baseline", cfg: Optional[ModelConfig] = None,
               shape_info: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell of `arch` x `shape` on `mesh` (a DeviceMesh, an
    AbstractMesh, or None for one rank without rules). `cfg` and
    `shape_info` replace the registered config and SHAPES[shape] (smoke
    sizes, a cut depth)."""
    cfg = get_config(arch) if cfg is None else cfg
    skip = cell_is_applicable(cfg, shape)
    if skip:
        return Cell(arch, shape, cfg, None, (), (), skip_reason=skip)
    info = SHAPES[shape] if shape_info is None else shape_info
    if microbatches is None:
        microbatches = strategy_microbatches(cfg, strategy)
    rules = make_rules(cfg, shape, mesh, strategy, fsdp)
    specs = input_specs(cfg, shape, info)
    batch_sh = {k: rules.sharding_for_shape(v.shape, "dp",
                                            *(None,) * (len(v.shape) - 1))
                for k, v in specs.items()}
    fn_rules = rules if mesh is not None else None

    if info["kind"] == "train":
        step = make_train_step(cfg, rules=fn_rules, microbatches=microbatches)
        state = make_abstract_state(cfg)
        st_sh = state_shardings(cfg, rules)
        # the port's step is a plain 0-d tensor on every rank (adamw_init)
        st_sh = st_sh._replace(opt=st_sh.opt._replace(step=None))
        return Cell(arch, shape, cfg, step, (state, specs), (st_sh, batch_sh))

    params = abstract_params(cfg)
    if strategy == "optimized":
        # Serve from bf16 weights: halves both the HBM stream and any
        # remaining weight-shard gathers; f32 masters are a training-only
        # artifact.
        params = _tree_map(
            lambda t: torch.empty(t.shape, dtype=torch.bfloat16
                                  if t.dtype == torch.float32 else t.dtype,
                                  device="meta"), params)
    p_sh = param_shardings(cfg, rules)

    if info["kind"] == "prefill":
        def prefill_fn(p, b):
            return prefill(p, cfg, b, fn_rules)
        return Cell(arch, shape, cfg, prefill_fn, (params, specs),
                    (p_sh, batch_sh))

    # decode: the new token at the cache's last position
    long = bool(info.get("long"))
    cache, cache_sh = cache_specs(cfg, info["batch"], info["seq"],
                                  rules, shard_seq=long)
    cur_len = info["seq"] - 1

    def decode_fn(p, c, tok):
        return decode_step(p, cfg, c, tok["tokens"], cur_len, fn_rules)

    return Cell(arch, shape, cfg, decode_fn, (params, cache, specs),
                (p_sh, cache_sh, batch_sh))


def _tree_map(fn: Callable, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return {k: _tree_map(fn, v) for k, v in tree.items()}
