"""Mixtral-8x7B [arXiv:2401.04088; hf] — 8 experts top-2, sliding window.

Port of `repro/configs/mixtral_8x7b.py`."""
from ..models.config import ModelConfig, MoEConfig, SubLayer

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,                      # per-expert
    vocab_size=32000,
    rope_theta=1_000_000.0,
    sliding_window=4096,             # SWA -> sub-quadratic, runs long_500k
    pattern=(SubLayer(kind="attn", ffn="moe"),),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    source="arXiv:2401.04088; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256, sliding_window=32,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      capacity_factor=8.0),
    )
