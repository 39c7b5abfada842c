"""Roofline terms of a dry-run cell on H100 nodes (no card needed).

Port of `repro/launch/roofline.py`. Three terms per (arch x shape x mesh),
each the least time one rank could take for its share of the step:

  compute    = FLOPs (per rank)  / PEAK_FLOPS
  memory     = bytes (per rank)  / HBM_BW
  collective = NVLink wire bytes / NVLINK_BW + network wire bytes / NET_BW

The constants are the H100 SXM datasheet's (dense bf16 tensor cores,
HBM3, NVLink 4 per direction, one 400 Gb/s NDR port per card), not
figures measured here. The reference prices every collective at one ICI
link speed; an H100 cluster has two links, so `CollectiveStats.add`
takes whether the collective's group lies inside one node (NVLink) or
spans nodes (the network), and `Roofline.t_collective` prices each part
at its own rate. Each collective's wire bytes follow the ring algorithm
for its group size g:

  all-gather      (g-1)/g * result_bytes
  all-reduce    2*(g-1)/g * operand_bytes
  reduce-scatter  (g-1)/g * operand_bytes
  all-to-all      (g-1)/g * operand_bytes
  collective-permute   1 * operand_bytes

The reference parses XLA's HLO text for its collectives; here they come
from the dry run's trace (`launch/dryrun.py`), so the HLO parser is not
ported. `forward_flops_per_token`, `model_flops_for`, `analytic_costs`
and the `Roofline` properties and `row()` keys are the reference's. Its
TPU-specific defaults become parameters: `analytic_costs`'s `tp`
defaults to one node's cards (the production mesh's `model` axis,
`launch/mesh.py`).

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) gives the useful-compute
ratio (catches remat/redundancy waste).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..models.config import count_moe_expert_params

# H100 SXM datasheet figures (per card)
PEAK_FLOPS = 989.4e12        # dense bf16 tensor cores
HBM_BW = 3.35e12             # B/s, HBM3
HBM_BYTES = 80e9             # the 80 GB card
NVLINK_BW = 450e9            # B/s per direction, NVLink 4 inside a node
NET_BW = 50e9                # B/s per card across nodes (400 Gb/s NDR)
GPUS_PER_NODE = 8            # one HGX node's NVLink domain


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    op_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    op_count: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the part of wire_bytes whose group lies inside one node (NVLink)
    nvlink_wire_bytes: float = 0.0

    def add(self, kind: str, nbytes: float, group: int, mult: float = 1.0,
            intra_node: bool = True):
        if kind == "all-gather":
            wire = (group - 1) / group * nbytes
        elif kind == "all-reduce":
            wire = 2 * (group - 1) / group * nbytes
        elif kind in ("reduce-scatter", "all-to-all"):
            wire = (group - 1) / group * nbytes
        else:  # collective-permute
            wire = nbytes
        self.wire_bytes += wire * mult
        if intra_node:
            self.nvlink_wire_bytes += wire * mult
        self.op_bytes[kind] = self.op_bytes.get(kind, 0.0) + nbytes * mult
        self.op_count[kind] = self.op_count.get(kind, 0) + mult


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per rank
    hlo_bytes: float            # per rank
    wire_bytes: float           # per rank, ring-factored
    model_flops: Optional[float] = None   # 6*N*D useful flops (global)
    peak_mem_bytes: Optional[float] = None
    # the part of wire_bytes that stays inside one node (NVLink); the
    # rest crosses nodes
    nvlink_wire_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.nvlink_wire_bytes / NVLINK_BW
                + (self.wire_bytes - self.nvlink_wire_bytes) / NET_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / (chips * FLOPs-per-rank)."""
        if not self.model_flops or not self.hlo_flops:
            return None
        return self.model_flops / (self.chips * self.hlo_flops)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the binding roofline actually used by useful work:
        time the dominant resource *must* take for the useful work, divided
        by the time the traced program claims on that resource."""
        t = self.bound_time
        if t <= 0:
            return 0.0
        if self.model_flops:
            useful_t = self.model_flops / self.chips / PEAK_FLOPS
            return min(useful_t / t, 1.0)
        return self.t_compute / t

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "wire_bytes_per_dev": self.wire_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_bytes": self.peak_mem_bytes,
        }


def model_flops_for(cfg, shape_info: dict, n_active_params: int) -> float:
    """6*N*D per processed token (train fwd+bwd); 2*N*D for inference."""
    tokens = shape_info["batch"] * shape_info["seq"]
    if shape_info["kind"] == "train":
        return 6.0 * n_active_params * tokens
    if shape_info["kind"] == "prefill":
        return 2.0 * n_active_params * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active_params * shape_info["batch"]


# ---------------------------------------------------------------------------
# Analytic per-rank cost model: the reference's architecture formulas
# (matmul-exact, attention/SSD included, remat multiplier applied). The
# dry run reports its traced FLOPs beside these.
# ---------------------------------------------------------------------------

def _attn_flops_per_token(cfg, s_kv: float) -> float:
    hd = cfg.resolved_head_dim
    h, k, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    proj = 2.0 * d * (h + 2 * k) * hd + 2.0 * h * hd * d
    score = 4.0 * h * hd * s_kv                 # qk^T and pv
    return proj + score


def _ssm_flops_per_token(cfg, decode: bool) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    h = d_in // s.head_dim
    p, n, q = s.head_dim, s.d_state, s.chunk
    proj = 2.0 * d * (2 * d_in + 2 * n + h) + 2.0 * d_in * d
    conv = 2.0 * s.d_conv * (d_in + 2 * n)
    if decode:
        ssd = 6.0 * h * p * n
    else:
        ssd = 2.0 * q * n + 2.0 * q * h * p + 4.0 * n * h * p
    return proj + conv + ssd


def _ffn_flops_per_token(cfg, sub) -> float:
    d = cfg.d_model
    if sub.ffn == "mlp":
        return (6.0 if cfg.mlp_type == "swiglu" else 4.0) * d * cfg.d_ff
    if sub.ffn == "moe":
        m = cfg.moe
        routed = m.top_k * m.capacity_factor * 6.0 * d * m.d_ff_expert
        shared = m.num_shared_experts * 6.0 * d * m.d_ff_shared
        return routed + shared + 2.0 * d * m.num_experts
    return 0.0


def forward_flops_per_token(cfg, s_kv: float, decode: bool = False) -> float:
    total = 0.0
    for sub in cfg.pattern:
        if sub.kind == "attn":
            kv = s_kv
            if cfg.sliding_window is not None:
                kv = min(kv, cfg.sliding_window)
            total += _attn_flops_per_token(cfg, kv)
        else:
            total += _ssm_flops_per_token(cfg, decode)
        total += _ffn_flops_per_token(cfg, sub)
    total *= cfg.repeats
    # head (audio: K heads)
    k = cfg.frontend.num_positions if (
        cfg.frontend and cfg.frontend.modality == "audio") else 1
    total += 2.0 * cfg.d_model * cfg.vocab_size * k
    return total


@dataclasses.dataclass
class AnalyticCosts:
    flops_per_dev: float
    hbm_bytes_per_dev: float


def analytic_costs(cfg, shape_info: dict, chips: int,
                   param_count: int, microbatches: int = 8,
                   remat: bool = True, tp: int = GPUS_PER_NODE,
                   fsdp: bool = True, zero3_gather: bool = True,
                   moe_ep: bool = False) -> AnalyticCosts:
    """Per-rank FLOPs and HBM bytes for one step of the cell.

    Accounting (documented assumptions, the reference's):
      * FLOPs are balanced across ranks: per-rank = global / chips.
      * Weight stream per rank: with FSDP the all-gathered bf16 weights
        pass through every rank's HBM once per use (full P bytes); without
        FSDP only the TP shard streams (P/tp bytes). `tp` is the size of
        the mesh's `model` axis.
      * train: fwd+bwd = 3x fwd matmul FLOPs; full remat re-runs fwd -> 4x;
        weights stream once per microbatch per pass (fwd, remat-fwd, bwd);
        optimizer: m, v, master in f32, read+write, on the 1/chips shard.
      * activations: ~16 bytes/token/d_model residual-path round-trip per
        sub-layer, sharded across ranks.
      * decode: KV cache (or SSM state) read once per token step.
    """
    kind = shape_info["kind"]
    seq = shape_info["seq"]
    batch = shape_info["batch"]
    dtype_b = 2.0  # bf16
    p_moe = count_moe_expert_params(cfg) if moe_ep else 0
    p_dense = param_count - p_moe
    if fsdp and zero3_gather:
        # gathered weights stream fully through each rank's HBM
        p_stream = p_dense * dtype_b + p_moe * dtype_b / tp
    elif fsdp:
        # no gather: each rank reads only its 1/chips shard
        p_stream = param_count * dtype_b / chips
    else:
        p_stream = param_count * dtype_b / tp

    if kind == "decode":
        tokens = float(batch)
        f = forward_flops_per_token(cfg, s_kv=seq, decode=True) * tokens
        hd = cfg.resolved_head_dim
        n_attn = cfg.repeats * sum(1 for s in cfg.pattern if s.kind == "attn")
        s_alloc = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        kv_bytes = 2 * n_attn * batch * s_alloc * cfg.num_kv_heads * hd * dtype_b
        ssm_bytes = 0.0
        if cfg.ssm:
            d_in = cfg.ssm.expand * cfg.d_model
            h = d_in // cfg.ssm.head_dim
            n_ssm = cfg.repeats * sum(1 for s in cfg.pattern if s.kind == "ssm")
            ssm_bytes = 2 * n_ssm * batch * h * cfg.ssm.head_dim \
                * cfg.ssm.d_state * 4
        act = 16.0 * tokens * cfg.d_model * cfg.num_layers
        bytes_dev = p_stream + (kv_bytes + ssm_bytes + act) / chips
        return AnalyticCosts(f / chips, bytes_dev)

    tokens = float(batch) * seq
    s_kv = (seq + 1) / 2.0  # causal average
    f_fwd = forward_flops_per_token(cfg, s_kv=s_kv) * tokens
    act_bytes = 16.0 * tokens * cfg.d_model * cfg.num_layers
    logits_bytes = 4.0 * tokens * cfg.vocab_size  # f32 logits r/w
    if kind == "prefill":
        bytes_dev = p_stream + (act_bytes + logits_bytes / seq) / chips
        return AnalyticCosts(f_fwd / chips, bytes_dev)

    # train
    flops = (4.0 if remat else 3.0) * f_fwd
    passes = (3.0 if remat else 2.0)
    opt_bytes = param_count * 4.0 * 6.0 / chips
    bytes_dev = (microbatches * passes * p_stream
                 + (passes * act_bytes + 2 * logits_bytes) / chips + opt_bytes)
    return AnalyticCosts(flops / chips, bytes_dev)
