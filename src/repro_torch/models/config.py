"""Model configuration for the LM substrate.

Port of `repro/models/config.py`: the same frozen dataclasses, so that the
reference's configs load unchanged. A model is `num_layers` sub-layers
arranged as repeats of a block pattern (tuple of SubLayer descriptors).
The port serves and trains every reference architecture: attention
(with an optional sliding window), MoE and Mamba-2 (SSD) patterns, the
hybrid Jamba stack, and the vision and audio frontends, with or without
sharding rules. What is not ported yet raises NotImplementedError naming
its ROADMAP.md item (`not_ported`).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

Kind = Literal["attn", "ssm"]
Ffn = Literal["mlp", "moe", "none"]

# The ROADMAP.md Queue 1 item that brings back what the port leaves out.
SHARDED_CHECKPOINTS = ("ROADMAP.md Queue 1 item 23 (checkpoints of "
                       "sharded LM state)")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see {item}")


@dataclasses.dataclass(frozen=True)
class SubLayer:
    kind: Kind = "attn"
    ffn: Ffn = "mlp"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0            # per shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub: the reference feeds precomputed embeddings."""
    modality: Literal["vision", "audio"]
    d_frontend: int = 0       # embedding dim delivered by the (stub) encoder
    num_positions: int = 0    # patches (vision) / codebooks (audio)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp_type: Literal["swiglu", "gelu"] = "swiglu"
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    sliding_window: Optional[int] = None      # SWA (mixtral)
    tie_embeddings: bool = False
    pattern: Tuple[SubLayer, ...] = (SubLayer(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
    dtype: str = "bfloat16"                   # activation/compute dtype
    param_dtype: str = "float32"
    # source tag for provenance, e.g. "arXiv:2407.10671; hf"
    source: str = ""

    def __post_init__(self):
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not a multiple of "
                f"pattern length {len(self.pattern)}"
            )
        needs_moe = any(s.ffn == "moe" for s in self.pattern)
        if needs_moe and self.moe is None:
            raise ValueError(f"{self.name}: pattern has MoE but moe config is None")
        needs_ssm = any(s.kind == "ssm" for s in self.pattern)
        if needs_ssm and self.ssm is None:
            raise ValueError(f"{self.name}: pattern has SSM but ssm config is None")

    @property
    def repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def attention_free(self) -> bool:
        return all(s.kind != "attn" for s in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the reference's long_500k cell."""
        return self.attention_free or self.family == "hybrid" or (
            self.sliding_window is not None
        )

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **overrides)


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count, every family (the reference's formula)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if cfg.frontend is not None and cfg.frontend.modality == "audio":
        # K codebook embedding tables + K output heads
        total = 2 * cfg.frontend.num_positions * cfg.vocab_size * d
    else:
        total = cfg.vocab_size * d  # embed
        if not cfg.tie_embeddings:
            total += cfg.vocab_size * d
    if cfg.frontend is not None and cfg.frontend.modality == "vision":
        df = cfg.frontend.d_frontend
        total += df * d + df + d * d  # projector (w1, norm, w2)
    per_pattern = 0
    for s in cfg.pattern:
        per_pattern += d  # pre-norm
        if s.kind == "attn":
            per_pattern += d * cfg.num_heads * hd            # q
            per_pattern += 2 * d * cfg.num_kv_heads * hd     # k, v
            per_pattern += cfg.num_heads * hd * d            # o
            if cfg.qkv_bias:
                per_pattern += (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
        else:
            ssm = cfg.ssm
            d_in = ssm.expand * d
            nheads = d_in // ssm.head_dim
            conv_ch = d_in + 2 * ssm.d_state
            per_pattern += d * (2 * d_in + 2 * ssm.d_state + nheads)  # in_proj
            per_pattern += conv_ch * ssm.d_conv + conv_ch              # conv w+b
            per_pattern += 2 * nheads + nheads                         # A, D, dt_bias
            per_pattern += d_in                                        # gate norm
            per_pattern += d_in * d                                    # out_proj
        if s.ffn == "mlp":
            per_pattern += d  # norm
            if cfg.mlp_type == "swiglu":
                per_pattern += 3 * d * cfg.d_ff
            else:
                per_pattern += 2 * d * cfg.d_ff
        elif s.ffn == "moe":
            per_pattern += d  # norm
            m = cfg.moe
            per_pattern += d * m.num_experts                       # router
            per_pattern += m.num_experts * 3 * d * m.d_ff_expert   # routed (swiglu)
            per_pattern += m.num_shared_experts * 3 * d * m.d_ff_shared
    total += cfg.repeats * per_pattern
    total += d  # final norm
    return int(total)


def count_moe_expert_params(cfg: ModelConfig) -> int:
    """Routed-expert params only."""
    if cfg.moe is None:
        return 0
    m = cfg.moe
    n_moe_layers = cfg.repeats * sum(1 for s in cfg.pattern if s.ffn == "moe")
    return int(n_moe_layers * m.num_experts * 3 * cfg.d_model * m.d_ff_expert)


def count_active_params(cfg: ModelConfig) -> int:
    """Per-token active params (MoE: only top_k + shared experts)."""
    if cfg.moe is None:
        return count_params(cfg)
    m = cfg.moe
    d = cfg.d_model
    inactive_per_moe = (m.num_experts - m.top_k) * 3 * d * m.d_ff_expert
    n_moe_layers = cfg.repeats * sum(1 for s in cfg.pattern if s.ffn == "moe")
    return int(count_params(cfg) - n_moe_layers * inactive_per_moe)
