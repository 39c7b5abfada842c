"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed top-4 + 4 shared.

Shared experts are modelled as 4 swiglu experts of d_ff 1408 merged into one
5632-wide dense MLP (hf: shared_expert_intermediate_size = 5632), with the
routed experts at d_ff_expert = 1408.

Port of `repro/configs/qwen2_moe_a2_7b.py`.
"""
from ..models.config import ModelConfig, MoEConfig, SubLayer

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                       # per-expert (assignment convention)
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    pattern=(SubLayer(kind="attn", ffn="moe"),),
    moe=MoEConfig(
        num_experts=60, top_k=4, d_ff_expert=1408,
        num_shared_experts=4, d_ff_shared=1408,
    ),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=4, d_ff_expert=32,
                      num_shared_experts=2, d_ff_shared=32,
                      capacity_factor=8.0),
    )
